"""Process mesh and collectives (counterpart of `dualforce_tpu/parallel/mesh.py`).

One mesh, three axes, as the JAX package's: `data` (batch), `fsdp` (weight
shards) and `cp` (sequence chunks). The JAX package runs one controller
over a device mesh; the port follows PyTorch's idiom instead: one process
per rank (`torchrun`), a `torch.distributed` `DeviceMesh` whose dimensions
carry JAX's axis names, and explicit collectives. Every module of
`parallel/` talks to the other ranks only through the helpers at the end of
this file, each over one mesh axis (`MeshAxis`): `ppermute_next`,
`all_gather`, `psum`, `pmax`, `all_to_all`, `axis_index`, `axis_size`.

The backend follows one rule (`choose_backend`): NCCL when each rank of the
host has a card of its own, gloo on the CPU or when there are more ranks
than cards (NCCL refuses two ranks on one card). Gloo moves CPU tensors; for
a CUDA tensor, an operation that gloo does not take on the card
(`GLOO_CUDA_OPS`) goes through page-locked host memory, by that rule and
never by retry. Data moves as raw bytes (uint8 views), so any dtype rides
every backend; sums and maxima take fp32. `TRANSFER` counts the bytes each
rank sends and the seconds it spends in collectives.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "cp")
# gloo operations that take CUDA tensors on the card machine's torch (2.11.0+cu128), by
# `parallel/transport_probe.py`: its collectives do, its send/recv does not ("Bad
# address"); every other one is staged through page-locked host memory
GLOO_CUDA_OPS = frozenset({"all_gather", "all_reduce", "all_to_all"})
# bytes this rank sent and seconds it spent in the helpers' collectives
TRANSFER = {"bytes": 0, "seconds": 0.0, "calls": 0}


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if os.environ.get(name) else None


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo
    (on the CPU, or more ranks than cards)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def local_placement(device: torch.device, rank: int, world: int):
    """(local rank, ranks on this host) from LOCAL_RANK / LOCAL_WORLD_SIZE,
    which torchrun sets. A CUDA rank of a world of more than one process
    without them raises: the global rank and world say nothing of how the
    ranks are spread over hosts, and guessing would bind two ranks to one
    card, or pick gloo where every rank has a card of its own."""
    local_rank, local_world = _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE")
    if local_rank is not None and local_world is not None:
        return local_rank, local_world
    if world <= 1 or device.type != "cuda":
        return local_rank or 0, local_world or world
    raise ValueError(f"rank {rank} of {world} on the card needs LOCAL_RANK and "
                     "LOCAL_WORLD_SIZE (torchrun sets both)")


def initialize_distributed(device="cuda") -> torch.device:
    """Join the process group and return this rank's device (the counterpart
    of `jax.distributed.initialize`). Reads torchrun's RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT, or the JAX package's COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID, and LOCAL_RANK / LOCAL_WORLD_SIZE
    (`local_placement`). A one-process run is a no-op. Rank r binds
    `cuda:LOCAL_RANK % cards`. An init error propagates: swallowing it would
    leave every rank in a world of its own, each computing the whole request
    alone."""
    from dualforce_tpu_torch import resolve_device

    device = resolve_device(device)
    coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address:
        world = _env_int("NUM_PROCESSES") or 1
        rank = _env_int("PROCESS_ID") or 0
        init_method = f"tcp://{coordinator_address}"
    else:
        world = _env_int("WORLD_SIZE") or 1
        rank = _env_int("RANK") or 0
        init_method = "env://"
    local_rank, local_world = local_placement(device, rank, world)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world <= 1 or dist.is_initialized():
        return device
    backend = choose_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    print(f"[dist] rank {rank} of {world} on {device}, backend {backend} ("
          f"{local_world} ranks on this host, {torch.cuda.device_count()} cards)", flush=True)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def leave() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def create_mesh(data: int = 1, fsdp: int = 1, cp: int = 1):
    """A `DeviceMesh` of shape (data, fsdp, cp) with JAX's axis names over
    the whole world, cp the fastest-varying axis (JAX's row-major layout).
    Raises when the world does not hold data * fsdp * cp processes. A
    one-process world without a process group gets one (gloo, in-memory
    store). Under gloo the mesh's device type is "cpu": its groups carry
    the collectives, and the helpers stage CUDA tensors themselves."""
    from torch.distributed.device_mesh import init_device_mesh

    n = data * fsdp * cp
    if world_size() != n:
        raise ValueError(f"mesh {data}x{fsdp}x{cp} needs a world of {n} processes, this "
                         f"one has {world_size()} (launch with torchrun --nproc-per-node {n})")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, fsdp, cp), mesh_dim_names=AXES)


def single_device_mesh():
    return create_mesh(1, 1, 1)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a mesh (JAX's `mesh.shape`); {} for None."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class MeshAxis(NamedTuple):
    """One axis of a mesh: the group the helpers below talk over."""
    mesh: object
    name: str


def axis_size(axis: MeshAxis) -> int:
    return mesh_shape(axis.mesh)[axis.name]


def axis_index(axis: MeshAxis) -> int:
    return axis.mesh.get_local_rank(axis.name)


def _group(axis: MeshAxis):
    return axis.mesh.get_group(axis.name)


def _via_host(op: str, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(None) == "gloo" and op not in GLOO_CUDA_OPS


def _stage(x: torch.Tensor, host: bool) -> torch.Tensor:
    """x as a contiguous tensor the backend takes: a page-locked host copy
    where `host`."""
    x = x.contiguous()
    if not host:
        return x
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).view(torch.uint8)


@contextlib.contextmanager
def _timed(nbytes: int, x: torch.Tensor):
    """Count a collective that sends `nbytes` into `TRANSFER`. For a CUDA
    tensor the device is synchronised on both sides: NCCL's calls (and
    gloo's on the card) return once the work is queued, so the host's
    clock alone would read the time to enqueue."""
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    TRANSFER["seconds"] += time.perf_counter() - t0
    TRANSFER["bytes"] += nbytes
    TRANSFER["calls"] += 1


def ppermute_next(tensors, axis: MeshAxis):
    """Each rank's tensors go to the next rank of the axis ((i + 1) mod n);
    returns those from the previous rank (JAX's `lax.ppermute` with the
    ring permutation), as new tensors on the inputs' devices."""
    n = axis_size(axis)
    if n == 1:
        return list(tensors)
    group = _group(axis)
    i = axis_index(axis)
    dst = dist.get_global_rank(group, (i + 1) % n)
    src = dist.get_global_rank(group, (i - 1) % n)
    host = _via_host("ppermute", tensors[0])
    sends = [_stage(t, host) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    with _timed(sum(t.numel() * t.element_size() for t in sends), tensors[0]):
        ops = []
        for s, r in zip(sends, recvs):
            ops += [dist.P2POp(dist.isend, _bytes(s), dst, group),
                    dist.P2POp(dist.irecv, _bytes(r), src, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out = [r.to(t.device) for r, t in zip(recvs, tensors)]
    return out


def all_gather_many(tensors, dims, axis: MeshAxis):
    """`all_gather` of each tensor along its dim, all in one collective (a
    layer's weight shards: one call instead of one per tensor), each result
    contiguous, so that it is laid out as the whole tensor was."""
    n = axis_size(axis)
    if n == 1:
        return list(tensors)
    moved = [t.movedim(d, 0).contiguous() for t, d in zip(tensors, dims)]
    flat = torch.cat([_bytes(t) for t in moved])
    s = _stage(flat, _via_host("all_gather", flat))
    parts = [torch.empty_like(s) for _ in range(n)]
    with _timed(s.numel(), flat):
        dist.all_gather(parts, s, group=_group(axis))
        parts = [p.to(flat.device) for p in parts]
    out, start = [], 0
    for t, d in zip(moved, dims):
        size = t.numel() * t.element_size()
        whole = torch.cat([p[start:start + size].view(t.dtype).view(t.shape) for p in parts])
        out.append(whole.movedim(0, d).contiguous())    # the whole tensor's own layout
        start += size
    return out


def all_gather(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The axis' chunks of x concatenated along `dim` in rank order (JAX's
    tiled `lax.all_gather`)."""
    return all_gather_many([x], [dim], axis)[0]


def _all_reduce(x: torch.Tensor, axis: MeshAxis, op) -> torch.Tensor:
    if axis_size(axis) == 1:
        return x
    s = _stage(x.float(), _via_host("all_reduce", x))
    if s.data_ptr() == x.data_ptr():
        s = s.clone()
    with _timed(s.numel() * s.element_size(), x):
        dist.all_reduce(s, op=op, group=_group(axis))
        out = s.to(x.device)
    return out


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum over the axis, in fp32."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The maximum over the axis, in fp32."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """x [n, ...]: chunk j goes to rank j of the axis; returns [n, ...] whose
    chunk j came from rank j."""
    n = axis_size(axis)
    if n == 1:
        return x
    s = _stage(x, _via_host("all_to_all", x))
    out = torch.empty_like(s)
    with _timed(s.numel() * s.element_size(), x):
        dist.all_to_all_single(_bytes(out), _bytes(s), group=_group(axis))
        out = out.to(x.device)
    return out
