"""Process mesh and collectives (counterpart of `dualforce_tpu/parallel/mesh.py`).

One mesh, three axes, as the JAX package's: `data` (batch), `fsdp` (weight
shards) and `cp` (sequence chunks). The JAX package runs one controller
over a device mesh; the port follows PyTorch's idiom instead: one process
per rank (`torchrun`), a `torch.distributed` `DeviceMesh` whose dimensions
carry JAX's axis names, and explicit collectives. Every module of
`parallel/` talks to the other ranks only through the helpers at the end of
this file, each over one mesh axis (`MeshAxis`): `ppermute_next`,
`all_gather`, `reduce_scatter`, `psum`, `pmax`, `all_to_all`, `axis_index`,
`axis_size`.

Under autograd each collective a gradient crosses has JAX's transpose for
its backward, the rule of `shard_map`: every rank differentiates its own
part of an objective that is the sum of the ranks' parts. `ppermute_next`
sends the cotangents to the previous rank, `all_gather` reduce-scatters
them, `psum` sums them, `all_to_all` exchanges them back; `pmax` takes its
input detached, as JAX's callers `stop_gradient` it. A collective whose
output a rank does not use gets a zero cotangent there all the same, so
every rank's backward makes the same calls. `all_gather_many(...,
identical=True)` (a layer's fsdp weight shards, which the fsdp ranks use
alike) keeps this rank's slice of the cotangent instead. Without autograd
(`torch.no_grad`, or inputs that need no gradient) the helpers are the
plain collectives, bit for bit.

The backend follows one rule (`choose_backend`): NCCL when each rank of the
host has a card of its own, gloo on the CPU or when there are more ranks
than cards (NCCL refuses two ranks on one card). Under gloo in a world on
one host, the helpers move their bytes through shared memory instead of
gloo's loopback TCP (`_Arena`: each rank of a group writes its part into
its own anonymous shared buffer, which every rank of the group maps; gloo
carries only the barriers around each exchange); sums and maxima are taken
in rank order, the same on every rank. Across hosts, gloo moves CPU
tensors; for a CUDA tensor, an operation that gloo does not take on the
card (`GLOO_CUDA_OPS`) goes through page-locked host memory, by that rule
and never by retry. Data moves as raw bytes (uint8 views), so any dtype
rides every backend; sums and maxima take fp32. `TRANSFER` counts the bytes each
rank sends and the seconds it spends in collectives, the backward's
included.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "cp")
# gloo operations that take CUDA tensors on the card machine's torch (2.11.0+cu128), by
# `parallel/transport_probe.py`: its collectives do (`reduce_scatter_tensor` among
# them), its send/recv does not ("Bad address"); every other one is staged through
# page-locked host memory
GLOO_CUDA_OPS = frozenset({"all_gather", "all_reduce", "all_to_all", "reduce_scatter"})
# bytes this rank sent and seconds it spent in the helpers' collectives
TRANSFER = {"bytes": 0, "seconds": 0.0, "calls": 0}
# whether every rank of the world runs on this host (set when the world is joined)
_ONE_HOST = {"on": False}


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
    _ONE_HOST["on"] = local_world == world
    print(f"[dist] rank {rank} of {world} on {device}, backend {backend} ("
          f"{local_world} ranks on this host, {torch.cuda.device_count()} cards)", flush=True)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank of the world (nothing in a one-process run)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def leave() -> None:
    """Leave the process group, where this process joined one."""
    _ARENAS.clear()
    _ONE_HOST["on"] = False
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


class _Arena:
    """Shared byte buffers of one group whose ranks share a host: each rank
    owns an anonymous shared-memory file (`os.memfd_create`, no path in any
    file system) and maps every rank's, reached through /proc/<pid>/fd.
    `exchange(mine)` writes this rank's bytes into its buffer, waits for the
    group (a gloo barrier), hands out every rank's bytes as CPU views valid
    inside the `with`, and waits again on leaving it, before any buffer is
    written anew. The buffers grow (new files, mapped again by every rank)
    when a message outgrows them; every rank of a collective sends as many
    bytes, so they all grow at the same call."""

    def __init__(self, group):
        self.group = group
        self.n, self.i = dist.get_world_size(group), dist.get_rank(group)
        self.size, self.views = 0, []

    def _grow(self, nbytes: int) -> None:
        self.views = []                         # the old maps close with their last view
        self.size = max(nbytes, 2 * self.size, 1 << 20)
        fd = os.memfd_create("dualforce-mesh", 0)
        os.ftruncate(fd, self.size)
        mine = mmap.mmap(fd, self.size)
        where: List[Optional[tuple]] = [None] * self.n
        dist.all_gather_object(where, (os.getpid(), fd), group=self.group)
        maps = []
        for j, (pid, peer_fd) in enumerate(where):
            if j == self.i:
                maps.append(mine)
                continue
            with open(f"/proc/{pid}/fd/{peer_fd}", "r+b") as f:
                maps.append(mmap.mmap(f.fileno(), self.size))
        dist.barrier(group=self.group)          # every rank has mapped every buffer
        os.close(fd)
        self.views = [torch.frombuffer(m, dtype=torch.uint8) for m in maps]

    @contextlib.contextmanager
    def exchange(self, mine: torch.Tensor):
        """mine: this rank's bytes (uint8, 1-D, any device); yields every
        rank's bytes, in rank order."""
        nbytes = mine.numel()
        if nbytes > self.size:
            self._grow(nbytes)
        self.views[self.i][:nbytes].copy_(mine)
        dist.barrier(group=self.group)
        try:
            yield [v[:nbytes] for v in self.views]
        finally:
            dist.barrier(group=self.group)


_ARENAS: Dict[int, _Arena] = {}


def _arena(axis: MeshAxis) -> Optional[_Arena]:
    """The axis group's `_Arena` where the world runs on one host under
    gloo, else None (NCCL, or gloo across hosts)."""
    if not _ONE_HOST["on"] or dist.get_backend(None) != "gloo":
        return None
    group = _group(axis)
    if id(group) not in _ARENAS:
        _ARENAS[id(group)] = _Arena(group)
    return _ARENAS[id(group)]


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


def _ppermute(tensors, axis: MeshAxis, shift: int):
    """Each rank's tensors go to rank (i + shift) mod n of the axis; returns
    those from rank (i - shift) mod n, as new tensors on the inputs' devices."""
    n = axis_size(axis)
    group = _group(axis)
    i = axis_index(axis)
    arena = _arena(axis)
    if arena is not None:
        flat = torch.cat([_bytes(t.contiguous()) for t in tensors])
        with _timed(flat.numel(), tensors[0]), arena.exchange(flat) as parts:
            got = parts[(i - shift) % n].to(flat.device, copy=True)
        out, start = [], 0
        for t in tensors:
            size = t.numel() * t.element_size()
            out.append(got[start:start + size].view(t.dtype).view(t.shape))
            start += size
        return out
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
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


def _differentiable(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _PPermute(torch.autograd.Function):
    """`_ppermute` whose backward sends each cotangent back the way its
    tensor came. An unused output's cotangent arrives as zeros and is sent
    all the same: every rank's backward makes the same calls."""

    @staticmethod
    def forward(ctx, axis, shift, *tensors):
        ctx.axis, ctx.shift = axis, shift
        return tuple(_ppermute(tensors, axis, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_ppermute([g.contiguous() for g in grads], ctx.axis, -ctx.shift))


def ppermute_next(tensors, axis: MeshAxis):
    """Each rank's tensors go to the next rank of the axis ((i + 1) mod n);
    returns those from the previous rank (JAX's `lax.ppermute` with the
    ring permutation), as new tensors on the inputs' devices. Under autograd
    the cotangents go to the previous rank."""
    if axis_size(axis) == 1:
        return list(tensors)
    if _differentiable(*tensors):
        return list(_PPermute.apply(axis, 1, *tensors))
    return _ppermute(tensors, axis, 1)


def _all_gather_many(tensors, dims, axis: MeshAxis):
    n = axis_size(axis)
    moved = [t.movedim(d, 0).contiguous() for t, d in zip(tensors, dims)]
    flat = torch.cat([_bytes(t) for t in moved])
    arena = _arena(axis)
    if arena is not None:
        with _timed(flat.numel(), flat), arena.exchange(flat) as views:
            parts = [v.to(flat.device, copy=True) for v in views]
    else:
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


def _reduce_scatter_many(tensors, dims, axis: MeshAxis):
    """Each tensor summed over the axis in fp32 (cast back to its dtype),
    this rank's 1/n along its dim kept, all in one collective."""
    n = axis_size(axis)
    moved = [t.float().movedim(d, 0).reshape(n, -1) for t, d in zip(tensors, dims)]
    flat = torch.cat(moved, dim=1).contiguous()          # [n, the rank-sized parts]
    arena = _arena(axis)
    if arena is not None:
        i, part = axis_index(axis), flat.shape[1] * 4
        with _timed(flat.numel() * 4, flat), arena.exchange(_bytes(flat)) as views:
            out = None
            for v in views:                                  # in rank order
                x = v[i * part:(i + 1) * part].view(torch.float32).to(flat.device)
                out = x.clone() if out is None else out + x
    else:
        s = _stage(flat, _via_host("reduce_scatter", flat))
        out = torch.empty(s.shape[1], dtype=s.dtype, device=s.device)
        with _timed(s.numel() * s.element_size(), flat):
            dist.reduce_scatter_tensor(out, s.reshape(-1), group=_group(axis))
            out = out.to(flat.device)
    res, start = [], 0
    for t, d, m in zip(tensors, dims, moved):
        shape = list(t.movedim(d, 0).shape)
        shape[0] //= n
        part = out[start:start + m.shape[1]].view(shape)
        res.append(part.movedim(0, d).to(t.dtype).contiguous())
        start += m.shape[1]
    return res


class _AllGather(torch.autograd.Function):
    """`_all_gather_many`, whose backward is JAX's transpose: the cotangents
    summed over the axis, this rank's slice kept (`reduce_scatter`)."""

    @staticmethod
    def forward(ctx, axis, dims, *tensors):
        ctx.axis, ctx.dims = axis, dims
        return tuple(_all_gather_many(tensors, dims, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_reduce_scatter_many(grads, ctx.dims, ctx.axis))


class _GatherShards(torch.autograd.Function):
    """`_all_gather_many` of tensors that every rank of the axis consumes
    identically (a layer's fsdp weight shards: the fsdp ranks compute the
    same tokens): the backward keeps this rank's slice of the cotangent,
    with no collective, so the copies are counted once."""

    @staticmethod
    def forward(ctx, axis, dims, *tensors):
        ctx.axis, ctx.dims = axis, dims
        return tuple(_all_gather_many(tensors, dims, axis))

    @staticmethod
    def backward(ctx, *grads):
        n, i = axis_size(ctx.axis), axis_index(ctx.axis)
        return (None, None, *(g.narrow(d, i * (g.shape[d] // n), g.shape[d] // n).contiguous()
                              for g, d in zip(grads, ctx.dims)))


def all_gather_many(tensors, dims, axis: MeshAxis, identical: bool = False):
    """`all_gather` of each tensor along its dim, all in one collective (a
    layer's weight shards: one call instead of one per tensor), each result
    contiguous, so that it is laid out as the whole tensor was. Under
    autograd the backward reduce-scatters the cotangents; with `identical`
    (every rank of the axis consumes the result the same way) it keeps this
    rank's slice instead."""
    if axis_size(axis) == 1:
        return list(tensors)
    if _differentiable(*tensors):
        fn = _GatherShards if identical else _AllGather
        return list(fn.apply(axis, tuple(dims), *tensors))
    return _all_gather_many(tensors, dims, axis)


def all_gather(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The axis' chunks of x concatenated along `dim` in rank order (JAX's
    tiled `lax.all_gather`); its backward is `reduce_scatter`."""
    return all_gather_many([x], [dim], axis)[0]


def reduce_scatter(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """x summed over the axis in fp32, this rank's 1/n along `dim` kept
    (JAX's tiled `lax.psum_scatter`), in x's dtype."""
    if axis_size(axis) == 1:
        return x
    return _reduce_scatter_many([x], [dim], axis)[0]


def _all_reduce(x: torch.Tensor, axis: MeshAxis, op) -> torch.Tensor:
    arena = _arena(axis)
    if arena is not None:
        xf = x.float().contiguous()
        with _timed(xf.numel() * 4, x), arena.exchange(_bytes(xf)) as views:
            out = None
            for v in views:                                  # in rank order
                y = v.view(torch.float32).view(xf.shape).to(x.device)
                out = y.clone() if out is None else (out + y if op == dist.ReduceOp.SUM
                                                     else torch.maximum(out, y))
        return out
    s = _stage(x.float(), _via_host("all_reduce", x))
    if s.data_ptr() == x.data_ptr():
        s = s.clone()
    with _timed(s.numel() * s.element_size(), x):
        dist.all_reduce(s, op=op, group=_group(axis))
        out = s.to(x.device)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis, ctx.dtype = axis, x.dtype
        return _all_reduce(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g, ctx.axis, dist.ReduceOp.SUM).to(ctx.dtype)


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum over the axis, in fp32; its backward is a psum."""
    if axis_size(axis) == 1:
        return x
    if _differentiable(x):
        return _PSum.apply(axis, x)
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The maximum over the axis, in fp32, of x detached (JAX's
    `pmax(stop_gradient(x))`: the callers' maxima only stabilise softmaxes
    that do not depend on them)."""
    x = x.detach()
    if axis_size(axis) == 1:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def _all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    arena = _arena(axis)
    if arena is not None:
        n, i = axis_size(axis), axis_index(axis)
        xc = x.contiguous()
        chunk = xc.numel() * xc.element_size() // n
        with _timed(xc.numel() * xc.element_size(), x), arena.exchange(_bytes(xc)) as views:
            got = torch.cat([v[i * chunk:(i + 1) * chunk] for v in views]).to(x.device)
        return got.view(x.dtype).view(x.shape)
    s = _stage(x, _via_host("all_to_all", x))
    out = torch.empty_like(s)
    with _timed(s.numel() * s.element_size(), x):
        dist.all_to_all_single(_bytes(out), _bytes(s), group=_group(axis))
        out = out.to(x.device)
    return out


class _AllToAll(torch.autograd.Function):
    """`_all_to_all` is its own inverse: chunk j went to rank j, so the
    cotangent's chunk j goes back to rank j."""

    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return _all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(g.contiguous(), ctx.axis)


def all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """x [n, ...]: chunk j goes to rank j of the axis; returns [n, ...] whose
    chunk j came from rank j. Its backward is the same exchange."""
    if axis_size(axis) == 1:
        return x
    if _differentiable(x):
        return _AllToAll.apply(axis, x)
    return _all_to_all(x, axis)
