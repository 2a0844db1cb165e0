"""Modules kept in host memory and staged to the card for the phase that uses
them (the component offload of `dualforce_tpu/diffusion/pipeline.py`,
`MOVAPipeline._staged`).

`to_host` moves a module's parameters and buffers into one host buffer,
page-locked when it is to feed a CUDA card: `cudaHostRegister` on a buffer
of the module's exact size. PyTorch's pinned allocator rounds every block up
to a power of two, which would take 32 GiB of locked memory for a 26.6 GiB
video expert. Page-locking raises when it fails; it never falls back to
pageable memory.

`staged` yields a copy of a module on the card, made without a second host
copy (`copy.deepcopy` with every tensor already mapped to its device copy),
and frees the copy's device memory when the block ends, also on an
exception. Staging always copies, also to the CPU, so a staged copy never
shares memory with its master.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Dict, Iterator, List

import numpy as np
import torch
from torch import nn

_PAGE = 4096
_ALIGN = 256        # byte offset of each tensor in a module's host buffer


def _tensors(module: nn.Module) -> List[torch.Tensor]:
    """Every parameter and buffer of `module`, each shared tensor once."""
    seen: Dict[int, torch.Tensor] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        seen.setdefault(id(t), t)
    return list(seen.values())


def nbytes(module: nn.Module) -> int:
    """Bytes of `module`'s parameters and buffers."""
    return sum(t.numel() * t.element_size() for t in _tensors(module))


def _replace(module: nn.Module, new: Dict[int, torch.Tensor]) -> None:
    """Put `new[id(t)]` in place of each parameter and buffer `t`, under every
    name that holds it."""
    params: Dict[int, nn.Parameter] = {}
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None and id(p) in new:
                if id(p) not in params:
                    params[id(p)] = nn.Parameter(new[id(p)], requires_grad=p.requires_grad)
                m._parameters[name] = params[id(p)]
        for name, b in m._buffers.items():
            if b is not None and id(b) in new:
                m._buffers[name] = new[id(b)]


def _page_locked(size: int) -> torch.Tensor:
    """A uint8 host tensor of `size` bytes, page-locked for CUDA copies, its
    storage starting on a page. The lock is released just before the memory
    is freed: the storage owns a view of a numpy array whose finaliser
    unregisters it."""
    length = -(-size // _PAGE) * _PAGE
    arr = np.empty(length + _PAGE, np.uint8)
    start = (-arr.ctypes.data) % _PAGE
    view = arr[start:start + length]
    # fault the pages in on every core first: registering pages not yet
    # mapped runs at ~2 GB/s on one thread (NVIDIA H100 host, 8 cores)
    buf = torch.from_numpy(view)
    buf.fill_(0)
    cudart = torch.cuda.cudart()
    rc = cudart.cudaHostRegister(buf.data_ptr(), length, 0)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostRegister of {length} bytes failed: {rc}")
    weakref.finalize(arr, cudart.cudaHostUnregister, buf.data_ptr()).atexit = False
    return buf[:size]


@torch.no_grad()
def to_host(module: nn.Module, device) -> nn.Module:
    """Move every parameter and buffer of `module` into one host buffer, in
    place, and return `module`. `device`: where the module will be staged;
    for a CUDA device the buffer is page-locked, so that staging copies run
    at the link's full rate."""
    tensors = _tensors(module)
    offsets, size = [], 0
    for t in tensors:
        offsets.append(size)
        size += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    pin = torch.device(device).type == "cuda"
    buf = _page_locked(size) if pin else torch.empty(size, dtype=torch.uint8)
    new = {}
    for t, off in zip(tensors, offsets):
        n = t.numel() * t.element_size()
        host = buf[off:off + n].view(t.dtype).view(t.shape)
        host.copy_(t)
        new[id(t)] = host
    _replace(module, new)
    return module


@contextlib.contextmanager
def staged(module: nn.Module, device) -> Iterator[nn.Module]:
    """A copy of `module` on `device` for the length of the block. Its device
    memory is freed when the block ends, even if references to the copy
    remain (a traceback's frames, say)."""
    copies: List[torch.Tensor] = []
    memo: Dict[int, torch.Tensor] = {}
    params = {id(p) for p in module.parameters()}
    for t in _tensors(module):
        c = t.to(device, non_blocking=True, copy=True)
        copies.append(c)
        memo[id(t)] = (nn.Parameter(c, requires_grad=t.requires_grad) if id(t) in params
                       else c)
    try:
        yield copy.deepcopy(module, memo)
    finally:
        for c in copies:
            c.untyped_storage().resize_(0)

