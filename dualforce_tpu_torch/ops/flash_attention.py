"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of `dualforce_tpu/ops/flash_attention.py`: the Pallas kernel
`_fwd_kernel` in exact mode with no LSE output, behind `flash_attention`.
The kernel (`csrc/flash_fwd.cu`) computes, per (batch, head),
softmax(Q K^T / sqrt(D) + kv mask) V, non-causal, D = 128, bf16 in and out
with fp32 accumulation; keys at positions >= kv_valid_len[b] are excluded,
and a query row with no valid key returns zeros, not NaN.

`flash_attention` launches the kernel for CUDA tensors and raises on what
it does not take; for CPU tensors it runs `flash_attention_plain`, the same
function in plain PyTorch. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dualforce_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 128
_MAX_FLOOR = -1.0e4          # running-max floor, in log2 units (the kernel's)
_PLAIN_SCORE_BYTES = 1 << 28  # fp32 score bytes the plain version holds per q chunk
_MAX_GRID_Y = 65535           # batch * heads rides on the grid's y dimension

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])


_KERNEL = None


def _kernel():
    """The C launcher `dft_flash_fwd_bf16`, built and bound at first use."""
    global _KERNEL
    if _KERNEL is None:
        fn = _build.load("flash_fwd").dft_flash_fwd_bf16
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in fp32.

    q: [B, Sq, N, D]; k, v: [B, Sk, N, D]; kv_valid_len: [B] int or None.
    Returns [B, Sq, N, D] in q's dtype. The running max is floored at the
    kernel's -1e4 (log2 units), so a row with no valid key returns zeros.
    Queries go in chunks that keep each fp32 score block near 256 MiB, so it
    runs at the main path's shapes on the card for a subset of heads.
    """
    b, sq, n, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    kf = k.float().permute(0, 2, 3, 1)          # [B, N, D, Sk]
    vf = v.float().permute(0, 2, 1, 3)          # [B, N, Sk, D]
    keep = None
    if kv_valid_len is not None:
        pos = torch.arange(sk, device=q.device)
        keep = (pos[None, :] < kv_valid_len.to(q.device)[:, None])[:, None, None, :]
    out = torch.empty((b, n, sq, d), dtype=q.dtype, device=q.device)
    chunk = max(1, _PLAIN_SCORE_BYTES // max(1, 4 * b * n * sk))
    for s0 in range(0, sq, chunk):
        qc = q[:, s0:s0 + chunk].float().permute(0, 2, 1, 3)   # [B, N, c, D]
        s = torch.matmul(qc * scale, kf)                       # [B, N, c, Sk]
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(dim=-1, keepdim=True).clamp_min(_MAX_FLOOR / LOG2E)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.where(denom == 0, 1.0, denom)
        out[:, :, s0:s0 + chunk] = o.to(q.dtype)
    return out.permute(0, 2, 1, 3)


def _check_cuda_inputs(q, k, v, kv_valid_len, shapes, strides, ptrs) -> None:
    """Raise unless the kernel takes these inputs. The shapes, strides and
    data pointers of q, k and v are read once by the caller, which passes
    them on to the kernel too: each read of a tensor attribute costs host
    time on every launch."""
    dev = q.get_device()
    for name, t, shape, stride, ptr in zip("qkv", (q, k, v), shapes, strides, ptrs):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16, {name} is {t.dtype}")
        if len(shape) != 4 or shape[3] != HEAD_DIM:
            raise ValueError(f"{name} must be [B, S, N, {HEAD_DIM}], got "
                             f"{tuple(shape)}")
        if stride[3] != 1 or stride[0] % 8 or stride[1] % 8 or stride[2] % 8 \
                or ptr % 16:
            raise ValueError(f"{name} needs a unit D stride, other strides a "
                             f"multiple of 8 and a 16-byte aligned start; got "
                             f"strides {stride}")
    b, _, n, _ = shapes[0]
    if shapes[1] != shapes[2] or shapes[1][0] != b or shapes[1][2] != n:
        raise ValueError(f"k/v shapes {tuple(shapes[1])}, {tuple(shapes[2])} do "
                         f"not match q {tuple(shapes[0])}")
    if b * n > _MAX_GRID_Y:
        raise ValueError(f"batch * heads = {b * n} exceeds {_MAX_GRID_Y}")
    if kv_valid_len is not None and (kv_valid_len.get_device() != dev
                                     or kv_valid_len.shape != (b,)):
        raise ValueError(f"kv_valid_len must be [{b}] on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Flash attention over [B, S, N, D] tensors.

    CUDA tensors go to the kernel (bf16, D = 128, any Sq/Sk), which reads
    them through their strides; CPU tensors go to `flash_attention_plain`.
    `flash_attention.launches` counts kernel launches.
    """
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, kv_valid_len)
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    shapes = (q.shape, k.shape, v.shape)
    strides = (q.stride(), k.stride(), v.stride())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    _check_cuda_inputs(q, k, v, kv_valid_len, shapes, strides, ptrs)
    b, sq, n, d = shapes[0]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    lens = None
    if kv_valid_len is not None:
        lens = kv_valid_len.to(torch.int32).contiguous()
    err = _kernel()(
        *ptrs, out.data_ptr(), None if lens is None else lens.data_ptr(), b, n, sq,
        shapes[1][1],
        *strides[0][:3], *strides[1][:3], *strides[2][:3], sq * n * d, n * d, d,
        d ** -0.5 * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
