"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd glue.

Counterpart of `dualforce_tpu/ops/flash_attention.py`: the Pallas kernels
`_fwd_kernel` in its exact and cap modes (with or without the LSE output),
`_bwd_fused_kernel`, and the split pair `_bwd_dq_kernel` + `_bwd_dkv_kernel`,
behind `flash_attention` and `flash_attention_with_lse`. The forward kernel
(`csrc/flash_fwd.cu`) computes, per (batch, head), softmax(Q K^T / sqrt(D) +
kv mask) V, non-causal, D = 128, bf16 in and out with fp32 accumulation, and
optionally the natural-log LSE [B, N, Sq] in fp32. It reads q, k and v
through 4-D tensor maps (`tma_geometry`); where its 128-row CTAs would leave
SMs idle it splits the key range (`fwd_splits`) and a combine kernel merges
the ranges, both launched by one call. Keys at positions >=
kv_valid_len[b] are excluded, and a query row with no valid key returns
zeros (LSE -1e4 * ln 2), not NaN. With `softmax_cap` (the "fast" route) the
static shift cap replaces the running max: P = exp2(S log2(e) / sqrt(D) -
cap), exact while a row's largest score lies in (cap - 126, cap + 127) in
log2 units, and a keyless row's LSE is cap * ln 2.

The backward (`csrc/flash_bwd.cu`) computes dq, dk and dv from q, k, v, dO,
the LSE and delta = rowsum(dO * O) - dlse, in one of two ways that compute
the same function: the fused kernel (one pass; dq summed over key tiles by
bulk fp32 reductions into a workspace of whole 64-row tiles) or the split
pair (a dk/dv pass and a dq pass that sums over key tiles in registers: no
workspace, a deterministic dq). So one plain version,
`flash_attention_bwd_plain`, serves both. Both first run the preprocess
kernel (`flash_bwd_preprocess`), which computes delta and lse * log2(e) from
bf16 O and dO into rows padded to whole 128-row tiles; its plain version is
`_delta`. The kernels read q, k, v and dO through 4-D tensor maps
(`tma_geometry`). `flash_attention_bwd` routes by shape as the JAX package's
`_bwd` does under its default mode (`bwd_takes_split`).

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it runs the plain PyTorch version of
the same function. There is no fallback from one to the other, and the split
route never gives way to the fused kernel.

`flash_attention` and `flash_attention_with_lse` are differentiable through
the custom op `dualforce_tpu::flash_fwd_lse` with its registered backward
(the counterpart of the JAX package's `jax.custom_vjp` glue `_flash` and
`_flash_lse`): when an input requires grad, the forward runs with the LSE
output and saves q, k, v, o and the LSE, and the backward runs
`flash_attention_bwd`. Without grad (serving, under
`torch.no_grad()`) `flash_attention` runs the forward without the LSE.
`flash_attention.launches` counts forward kernel launches in exact mode,
`flash_attention.cap_launches` those in cap mode,
`flash_attention_bwd.launches` fused backwards,
`flash_attention_bwd.split_launches` split ones (each launches both of the
pair's kernels once) and `flash_bwd_preprocess.launches` the preprocess
(once per backward).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from dualforce_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIM = 128
# static shift of the cap ("fast") mode, log2 units: exact while a row's
# largest score lies in (cap - 126, cap + 127), as QK-RMS-normed scores do
FAST_SOFTMAX_CAP = 30.0
_MAX_FLOOR = -1.0e4          # running-max floor, in log2 units (the kernel's)
_PLAIN_SCORE_BYTES = 1 << 28  # fp32 score bytes the plain versions hold per q chunk
_MAX_GRID_Y = 65535           # batch * heads rides on the grid's y dimension

# the forward's C launchers: q, k, v, their tensor-map geometry, o, lse, kv_len, the split
# workspace; then the combine of a split call
_FWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_COMBINE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                     + [ctypes.c_void_p])
# the forward kernel's tiles (csrc/flash_fwd.cu `kBlockM`, `kBlockN`): 128 query rows per CTA,
# 128 keys per stage; a split call gives each key range at least FWD_MIN_SPLIT_TILES tiles
FWD_BLOCK_M = 128
FWD_BLOCK_N = 128
FWD_MIN_SPLIT_TILES = 8
# the backward's C launchers: q, k, v, dO, then their tensor-map geometry (`tma_geometry`)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p])
_FINISH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p])
_PREP_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
# the backward kernels' lse and delta rows (csrc/flash_bwd.cu `kRowPad`): whole 128-row
# tiles, the dq pass's CTA, which the fused kernel's 64-row dQ tiles divide
BWD_ROW_PAD = 128

_KERNELS = {}


def _kernel(lib: str, symbol: str, argtypes):
    """A C launcher of a port library, built and bound at first use."""
    key = (lib, symbol)
    if key not in _KERNELS:
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _KERNELS[key] = fn
    return _KERNELS[key]


# --- plain versions ---------------------------------------------------------

def _key_mask(kv_valid_len, sk: int, device):
    """[B, 1, 1, Sk] bool, True for the keys a row may attend to, or None."""
    if kv_valid_len is None:
        return None
    pos = torch.arange(sk, device=device)
    return (pos[None, :] < kv_valid_len.to(device)[:, None])[:, None, None, :]


def _chunk_rows(b: int, n: int, sk: int) -> int:
    return max(1, _PLAIN_SCORE_BYTES // max(1, 4 * b * n * sk))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid_len: Optional[torch.Tensor] = None,
                          return_lse: bool = False,
                          softmax_cap: Optional[float] = None):
    """The forward kernel's function in plain PyTorch, in fp32.

    q: [B, Sq, N, D]; k, v: [B, Sk, N, D]; kv_valid_len: [B] int or None.
    Returns o [B, Sq, N, D] in q's dtype, and with `return_lse` also the
    natural-log LSE [B, N, Sq] in fp32. The running max is floored at the
    kernel's -1e4 (log2 units), so a row with no valid key returns zeros and
    an LSE of -1e4 * ln 2. With `softmax_cap` the cap mode runs instead:
    P = exp2(S log2(e) / sqrt(D) - cap) with no max, o = P V / l (l == 0
    gives 0) and LSE = (cap + log2 l) ln 2. Queries go in chunks that keep
    each fp32 score block near 256 MiB, so it runs at the main path's shapes
    on the card for a subset of heads.
    """
    b, sq, n, d = q.shape
    sk = k.shape[1]
    cap = softmax_cap
    scale = d ** -0.5 if cap is None else d ** -0.5 * LOG2E   # cap mode: log2 units
    kf = k.float().permute(0, 2, 3, 1)          # [B, N, D, Sk]
    vf = v.float().permute(0, 2, 1, 3)          # [B, N, Sk, D]
    keep = _key_mask(kv_valid_len, sk, q.device)
    out = torch.empty((b, n, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    chunk = _chunk_rows(b, n, sk)
    for s0 in range(0, sq, chunk):
        qc = q[:, s0:s0 + chunk].float().permute(0, 2, 1, 3)   # [B, N, c, D]
        s = torch.matmul(qc * scale, kf)                       # [B, N, c, Sk]
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        if cap is None:
            m = s.amax(dim=-1, keepdim=True).clamp_min(_MAX_FLOOR / LOG2E)
            p = torch.exp(s - m)
        else:
            p = torch.exp2(s - cap)
        denom = p.sum(dim=-1, keepdim=True)
        denom = torch.where(denom == 0, 1.0, denom)
        out[:, :, s0:s0 + chunk] = (torch.matmul(p, vf) / denom).to(q.dtype)
        lse_c = m + torch.log(denom) if cap is None else (cap + torch.log2(denom)) * LN2
        lse[:, :, s0:s0 + chunk] = lse_c[..., 0]
    out = out.permute(0, 2, 1, 3)
    return (out, lse) if return_lse else out


def _delta(o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """delta = rowsum(dO * O) - dlse, [B, N, Sq] fp32 (`_bwd_prepare`)."""
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid_len=None, dlse=None):
    """The backward kernel's function in plain PyTorch, in fp32, from the LSE.

    q, o, do: [B, Sq, N, D]; k, v: [B, Sk, N, D]; lse, dlse: [B, N, Sq]
    (natural log). P = exp(S / sqrt(D) - lse) with masked keys excluded,
    dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dK = dS^T Q / sqrt(D),
    dQ = dS K / sqrt(D). Returns (dq, dk, dv) in the dtypes of q, k, v. Rows
    with no valid key get zero dq, and masked keys zero dk and dv. Queries go
    in chunks, as in `flash_attention_plain`.
    """
    b, sq, n, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    kf = k.float().permute(0, 2, 1, 3)          # [B, N, Sk, D]
    vf = v.float().permute(0, 2, 1, 3)
    keep = _key_mask(kv_valid_len, sk, q.device)
    delta = _delta(o, do, dlse)
    dq = torch.empty((b, n, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.zeros((b, n, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, n, sk, d), dtype=torch.float32, device=q.device)
    chunk = _chunk_rows(b, n, sk)
    for s0 in range(0, sq, chunk):
        qc = q[:, s0:s0 + chunk].float().permute(0, 2, 1, 3)   # [B, N, c, D]
        doc = do[:, s0:s0 + chunk].float().permute(0, 2, 1, 3)
        s = torch.matmul(qc, kf.transpose(-1, -2)) * scale     # [B, N, c, Sk]
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.exp(s - lse[:, :, s0:s0 + chunk, None].float())
        dv += torch.matmul(p.transpose(-1, -2), doc)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - delta[:, :, s0:s0 + chunk, None])
        dq[:, :, s0:s0 + chunk] = (torch.matmul(ds, kf) * scale).to(q.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# --- kernel launches --------------------------------------------------------

def _check_cuda_inputs(names, tensors, shapes, strides, ptrs) -> None:
    """Raise unless the kernels take these [B, S, N, D] tensors. Shapes,
    strides and data pointers are read once by the caller, which passes them
    on to the kernel too: each read of a tensor attribute costs host time on
    every launch."""
    dev = tensors[0].get_device()
    for name, t, shape, stride, ptr in zip(names, tensors, shapes, strides, ptrs):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on {tensors[0].device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernels take bfloat16, {name} is {t.dtype}")
        if len(shape) != 4 or shape[3] != HEAD_DIM:
            raise ValueError(f"{name} must be [B, S, N, {HEAD_DIM}], got "
                             f"{tuple(shape)}")
        if stride[3] != 1 or stride[0] % 8 or stride[1] % 8 or stride[2] % 8 \
                or ptr % 16:
            raise ValueError(f"{name} needs a unit D stride, other strides a "
                             f"multiple of 8 and a 16-byte aligned start; got "
                             f"strides {stride}")


def _check_qkv(q, k, v, kv_valid_len, shapes) -> None:
    b, _, n, _ = shapes[0]
    if shapes[1] != shapes[2] or shapes[1][0] != b or shapes[1][2] != n:
        raise ValueError(f"k/v shapes {tuple(shapes[1])}, {tuple(shapes[2])} do "
                         f"not match q {tuple(shapes[0])}")
    if b * n > _MAX_GRID_Y:
        raise ValueError(f"batch * heads = {b * n} exceeds {_MAX_GRID_Y}")
    if kv_valid_len is not None and (kv_valid_len.get_device() != q.get_device()
                                     or kv_valid_len.shape != (b,)):
        raise ValueError(f"kv_valid_len must be [{b}] on {q.device}")


def _lens(kv_valid_len):
    return None if kv_valid_len is None else kv_valid_len.to(torch.int32).contiguous()


def fwd_splits(ctas: int, sk: int, sms: int) -> int:
    """Key ranges a forward call is cut into: 1 where its `ctas` CTAs (B * N
    * ceil(Sq / 128)) fill the `sms` SMs; else the count, among those that
    leave every range at least FWD_MIN_SPLIT_TILES key tiles, whose CTAs
    best fill whole waves of `sms` (the smallest such count)."""
    if ctas >= sms:
        return 1
    tiles = -(-sk // FWD_BLOCK_N)
    best, best_fill = 1, ctas / sms
    # sms ranges always fill whole waves: no count past it can do better
    for splits in range(2, min(tiles // FWD_MIN_SPLIT_TILES, sms) + 1):
        waves = ctas * splits / sms
        fill = waves / math.ceil(waves)
        if fill > best_fill + 1e-9:
            best, best_fill = splits, fill
            if fill >= 1.0:
                break
    return best


_SMS = {}


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _launch_fwd(q, k, v, kv_valid_len, with_lse: bool, softmax_cap):
    shapes = (q.shape, k.shape, v.shape)
    strides = (q.stride(), k.stride(), v.stride())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    _check_cuda_inputs("qkv", (q, k, v), shapes, strides, ptrs)
    _check_qkv(q, k, v, kv_valid_len, shapes)
    b, sq, n, d = shapes[0]
    sk = shapes[1][1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if sk == 0:     # no key at all: the kernel's keyless rows, without a launch
        if lse is not None:
            lse.fill_((_MAX_FLOOR if softmax_cap is None else softmax_cap) * LN2)
        return out.zero_(), lse
    lens = _lens(kv_valid_len)
    splits = fwd_splits(b * n * -(-sq // FWD_BLOCK_M), sk, _sm_count(q.device))
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, b * n * sq, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, b * n * sq, 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    o_strides = (sq * n * d, n * d, d)
    err = _kernel("flash_fwd", "dft_flash_fwd_bf16", _FWD_ARGTYPES)(
        *ptrs, _geometry(shapes, strides), out.data_ptr(),
        None if lse is None else lse.data_ptr(), None if lens is None else lens.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, n, sq, sk, splits, *o_strides,
        d ** -0.5 * LOG2E, softmax_cap is not None, 0.0 if softmax_cap is None else softmax_cap,
        stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: error {err}")
    if splits > 1:
        err = _kernel("flash_fwd", "dft_flash_fwd_combine", _COMBINE_ARGTYPES)(
            part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, n, sq, splits, *o_strides, stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd combine launch failed: CUDA error {err}")
    if softmax_cap is None:
        flash_attention.launches += 1
    else:
        flash_attention.cap_launches += 1
    return out, lse


def _rows_padded(sq: int) -> int:
    """Query rows of the backward's lse and delta buffers (`BWD_ROW_PAD`)."""
    return _ceil_to(max(sq, 1), BWD_ROW_PAD)


def bwd_workspace_floats(b: int, n: int, sq: int) -> int:
    """fp32 elements of the fused kernel's dQ workspace: [B*N, Sq_pad, 128],
    whole 64-row tiles, each in the kernel's register order."""
    return b * n * _rows_padded(sq) * HEAD_DIM


def tma_geometry(shape, stride, elem_bytes: int = 2):
    """The seven values the kernels build a [B, S, N, 128] tensor map from:
    the dims innermost first (128, N, S, B) and the byte strides of N, S and
    B, for elements of `elem_bytes` bytes (2 for bf16, the default; 1 for the
    sage kernel's int8 q and k). A dim of size 1 is never stepped, so its
    stride is given as one 128-element row whatever the view says. Raises
    unless each stride is a positive multiple of 16 bytes below 2^40 and S
    fits an int32 coordinate."""
    b, s, n, d = shape
    if s >= 2**31:
        raise ValueError(f"{s} rows pass the tensor map's int32 coordinates")
    strides = []
    for size, st in ((n, stride[2]), (s, stride[1]), (b, stride[0])):
        nbytes = elem_bytes * st if size > 1 else elem_bytes * HEAD_DIM
        if nbytes <= 0 or nbytes % 16 or nbytes >= 2**40:
            raise ValueError(f"byte stride {nbytes} of a dim of size {size}: the tensor maps "
                             f"take positive multiples of 16 below 2^40")
        strides.append(nbytes)
    return (d, n, s, b, *strides)


def _geometry(shapes, strides):
    vals = [x for shape, stride in zip(shapes, strides) for x in tma_geometry(shape, stride)]
    return (ctypes.c_ulonglong * len(vals))(*vals)


def _check_lse(name, x, b, n, sq) -> None:
    if x.shape != (b, n, sq) or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 [{b}, {n}, {sq}] tensor")


def _launch_preprocess(o, do, lse, dlse, shapes, strides, workspace=None):
    """delta = rowsum(dO * O) - dlse and lse * log2(e), each [B, N, Sq_pad]
    fp32 (rows past Sq: 0 and +inf), from the preprocess kernel, which also
    zeroes `workspace` when given."""
    b, sq, n, _ = shapes[0]
    sq_pad = _rows_padded(sq)
    delta = torch.empty((b, n, sq_pad), dtype=torch.float32, device=o.device)
    lse2 = torch.empty_like(delta)
    err = _kernel("flash_bwd", "dft_flash_bwd_preprocess", _PREP_ARGTYPES)(
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), None if dlse is None else dlse.data_ptr(),
        delta.data_ptr(), lse2.data_ptr(), None if workspace is None else workspace.data_ptr(),
        0 if workspace is None else workspace.numel(), b, n, sq, sq_pad, *strides[0][:3],
        *strides[1][:3], torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd preprocess launch failed: CUDA error {err}")
    flash_bwd_preprocess.launches += 1
    return delta, lse2


def flash_bwd_preprocess(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                         dlse: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta, lse * log2(e)) as the backward kernels read them: [B, N,
    Sq_pad] fp32, Sq_pad = Sq rounded up to 128; rows past Sq hold 0 and
    +inf. CUDA tensors only: the plain version of delta is `_delta`.
    `flash_bwd_preprocess.launches` counts its launches (each backward makes
    one)."""
    if not o.is_cuda:
        raise ValueError("the preprocess kernel takes CUDA tensors; `_delta` is its plain "
                         "version")
    shapes, strides = (o.shape, do.shape), (o.stride(), do.stride())
    _check_cuda_inputs(("o", "do"), (o, do), shapes, strides, (o.data_ptr(), do.data_ptr()))
    b, sq, n, _ = shapes[0]
    if shapes[1] != shapes[0]:
        raise ValueError(f"do {tuple(shapes[1])} must match o {tuple(shapes[0])}")
    _check_lse("lse", lse, b, n, sq)
    if dlse is not None:
        dlse = dlse.float().contiguous()
        _check_lse("dlse", dlse, b, n, sq)
    return _launch_preprocess(o, do, lse, dlse, shapes, strides)


flash_bwd_preprocess.launches = 0


class _Bwd:
    """One backward's arguments, checked, with its outputs allocated and its
    preprocess launched: the passes below launch the kernels on them."""

    def __init__(self, q, k, v, o, lse, do, kv_valid_len, dlse, split: bool):
        shapes = (q.shape, k.shape, v.shape, do.shape, o.shape)
        strides = (q.stride(), k.stride(), v.stride(), do.stride(), o.stride())
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr())
        _check_cuda_inputs(("q", "k", "v", "do", "o"), (q, k, v, do, o), shapes, strides, ptrs)
        _check_qkv(q, k, v, kv_valid_len, shapes[:3])
        b, sq, n, d = shapes[0]
        sk = shapes[1][1]
        if shapes[3] != shapes[0] or shapes[4] != shapes[0]:
            raise ValueError(f"do {tuple(shapes[3])} and o {tuple(shapes[4])} must match "
                             f"q {tuple(shapes[0])}")
        _check_lse("lse", lse, b, n, sq)
        if dlse is not None:
            dlse = dlse.float().contiguous()
            _check_lse("dlse", dlse, b, n, sq)
        self.dims = (b, n, sq, sk)
        self.dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        self.dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        self.dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        self.empty = self.dq.numel() == 0 or self.dk.numel() == 0
        if self.empty:
            return
        self.ptrs = ptrs[:4]
        self.geom = _geometry(shapes[:4], strides[:4])
        self.dq_acc = None if split else torch.empty(bwd_workspace_floats(b, n, sq),
                                                     dtype=torch.float32, device=q.device)
        self.delta, self.lse2 = _launch_preprocess(o, do, lse, dlse, (shapes[4], shapes[3]),
                                                   (strides[4], strides[3]), self.dq_acc)
        lens = _lens(kv_valid_len)
        self.lens = lens
        self.lens_ptr = None if lens is None else lens.data_ptr()
        self.stream = torch.cuda.current_stream(q.device).cuda_stream

    def dq_pass(self) -> None:
        """The split's dq pass: dq written once, deterministic."""
        b, n, sq, sk = self.dims
        err = _kernel("flash_bwd", "dft_flash_bwd_dq_bf16", _DQ_ARGTYPES)(
            *self.ptrs, self.geom, self.lse2.data_ptr(), self.delta.data_ptr(), self.lens_ptr,
            self.dq.data_ptr(), b, n, sq, _rows_padded(sq), sk, *self.dq.stride()[:3],
            HEAD_DIM ** -0.5, self.stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd dq pass launch failed: error {err}")

    def dkv_pass(self) -> None:
        """The dk/dv core: the fused kernel with a workspace, else the split's
        dk/dv pass."""
        b, n, sq, sk = self.dims
        err = _kernel("flash_bwd", "dft_flash_bwd_bf16", _BWD_ARGTYPES)(
            *self.ptrs, self.geom, self.lse2.data_ptr(), self.delta.data_ptr(), self.lens_ptr,
            None if self.dq_acc is None else self.dq_acc.data_ptr(), self.dk.data_ptr(),
            self.dv.data_ptr(), b, n, sq, _rows_padded(sq), sk, *self.dk.stride()[:3],
            *self.dv.stride()[:3], HEAD_DIM ** -0.5, self.stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd {'kernel' if self.dq_acc is not None else 'dk/dv pass'}"
                               f" launch failed: error {err}")

    def dq_finish(self) -> None:
        """The fused kernel's dq = bf16(workspace / sqrt(D))."""
        b, n, sq, _ = self.dims
        err = _kernel("flash_bwd", "dft_flash_bwd_dq_finish", _FINISH_ARGTYPES)(
            self.dq_acc.data_ptr(), self.dq.data_ptr(), b, n, sq, _rows_padded(sq),
            *self.dq.stride()[:3], HEAD_DIM ** -0.5, self.stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd dq finish launch failed: error {err}")


def _launch_bwd(q, k, v, o, lse, do, kv_valid_len, dlse, split: bool):
    """The preprocess, then the fused backward kernel and its dq finish, or
    with `split` the split pair: the dq pass and the dk/dv pass (the fused
    kernel without its dQ product)."""
    bwd = _Bwd(q, k, v, o, lse, do, kv_valid_len, dlse, split)
    if bwd.empty:
        return bwd.dq.zero_(), bwd.dk.zero_(), bwd.dv.zero_()
    if split:
        bwd.dq_pass()
        bwd.dkv_pass()
        flash_attention_bwd.split_launches += 1
    else:
        bwd.dkv_pass()
        bwd.dq_finish()
        flash_attention_bwd.launches += 1
    return bwd.dq, bwd.dk, bwd.dv


def _forward(q, k, v, kv_valid_len, with_lse: bool, softmax_cap=None):
    """(o, lse or None) from the kernel (CUDA) or the plain version (CPU)."""
    if q.is_cuda:
        return _launch_fwd(q, k, v, kv_valid_len, with_lse, softmax_cap)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if with_lse:
        return flash_attention_plain(q, k, v, kv_valid_len, return_lse=True,
                                     softmax_cap=softmax_cap)
    return flash_attention_plain(q, k, v, kv_valid_len, softmax_cap=softmax_cap), None


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def bwd_takes_split(sq: int, d: int = HEAD_DIM) -> bool:
    """True where the JAX package's `_bwd` routes to `_bwd_split` under its
    default "auto" mode: where the fused kernel's whole-row dq scratch,
    ceil(Sq, bq) * D * 4 bytes with bq = min(1024, 512, ceil(Sq, 128)),
    would pass 48 MiB, i.e. from 98,305 query rows at D = 128 (720p video
    self-attention, 176,400 tokens). The three numbers are the reference's
    routing (its DEFAULT_BQ, _BWD_BQ_CAP and _FUSED_DQ_SCRATCH_CAP), kept so
    that the same shapes reach the same kernel in both packages; they are
    not this card's tile sizes."""
    bq = min(1024, 512, _ceil_to(max(sq, 1), 128))
    return _ceil_to(sq, bq) * d * 4 > 48 * 2**20


def _backward(split: bool, q, k, v, o, lse, do, kv_valid_len, dlse):
    """(dq, dk, dv) from the kernels (CUDA) or the plain version (CPU)."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, o, lse, do, kv_valid_len, dlse, split)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid_len, dlse)


def flash_attention_bwd_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              kv_valid_len: Optional[torch.Tensor] = None,
                              dlse: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the saved LSE through the fused backward kernel for
    CUDA tensors (bf16, D = 128; dq in bf16 after an fp32 accumulation whose
    summation order varies from run to run), the plain version for CPU
    tensors. `flash_attention_bwd.launches` counts its launches."""
    return _backward(False, q, k, v, o, lse, do, kv_valid_len, dlse)


def flash_attention_bwd_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              kv_valid_len: Optional[torch.Tensor] = None,
                              dlse: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the saved LSE through the split pair for CUDA
    tensors (bf16, D = 128; deterministic, dk and dv bit-equal to the fused
    kernel's), the plain version for CPU tensors.
    `flash_attention_bwd.split_launches` counts its launches."""
    return _backward(True, q, k, v, o, lse, do, kv_valid_len, dlse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_valid_len: Optional[torch.Tensor] = None,
                        dlse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from its saved LSE, routed by Sq as
    the JAX package's `_bwd` routes: `flash_attention_bwd_split` where
    `bwd_takes_split`, `flash_attention_bwd_fused` elsewhere."""
    if bwd_takes_split(q.shape[1], q.shape[3]):
        return flash_attention_bwd_split(q, k, v, o, lse, do, kv_valid_len, dlse)
    return flash_attention_bwd_fused(q, k, v, o, lse, do, kv_valid_len, dlse)


flash_attention_bwd.launches = 0
flash_attention_bwd.split_launches = 0


# --- autograd ---------------------------------------------------------------

def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@torch.library.custom_op("dualforce_tpu::flash_fwd_lse", mutates_args=())
def _flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid_len: Optional[torch.Tensor],
                   softmax_cap: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) = flash(q, k, v); the counterpart of `_flash` and `_flash_lse`
    with their custom VJPs. A dispatcher op, so that a selective checkpoint
    policy can see and keep its outputs (`checkpoint_context`). An unused
    output's cotangent arrives as None: an unused LSE adds nothing to delta,
    an unused o gives dO = 0. In cap mode the forward saves the cap-mode LSE;
    the backward is the same (P = exp(S / sqrt(D) - lse) is the softmax in
    both modes)."""
    return _forward(q, k, v, kv_valid_len, with_lse=True, softmax_cap=softmax_cap)


def _flash_fwd_lse_setup(ctx, inputs, output) -> None:
    q, k, v, kv_valid_len, _ = inputs
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(q, k, v, *output, kv_valid_len)


def _flash_fwd_lse_backward(ctx, do, dlse):
    q, k, v, o, lse, kv_valid_len = ctx.saved_tensors
    do = torch.zeros_like(o) if do is None else do.to(q.dtype).contiguous()
    return (*flash_attention_bwd(q, k, v, o, lse, do, kv_valid_len, dlse), None, None)


_flash_fwd_lse.register_autograd(_flash_fwd_lse_backward, setup_context=_flash_fwd_lse_setup)

_REMAT_SAVE_ATTENTION = False


def remat_save_attention(on: bool) -> bool:
    """The JAX package's switch of the same name: with it on, a layer
    checkpointed with `checkpoint_context` keeps the outputs of the
    dispatcher op `dualforce_tpu::flash_fwd_lse`, o and the LSE, across the
    remat boundary: its backward's recompute takes them from the forward
    and launches no second forward kernel; q, k and v are recomputed. The
    gradients are full remat's (the same backward on the same tensors). The
    policy keeps `flash_attention_with_lse`'s outputs too, where JAX's
    switch leaves that function alone; no checkpointed layer of the port
    calls it. Read at each `checkpoint_context` call. Returns the previous
    value.

    The kept residuals cost, per attention that reaches the kernel, o [B,
    Sq, N, D] in the compute dtype plus the LSE [B, N, Sq] in fp32, held
    from the layer's forward to its backward: at 360p training (B 1, 11,440
    video tokens, 40 heads) 117.1 + 1.8 MB for each of a layer's video self,
    video text cross and a2v attentions (the 103-query audio side takes
    plain attention), 357 MB per shared layer and 238 MB per tail layer; at
    720p (176,400 video, 403 audio tokens) 1.806 GB + 28.2 MB for each of
    the three video-side ones and 1.3 MB for each audio-side one, 5.51 GB
    per shared layer."""
    global _REMAT_SAVE_ATTENTION
    prev = _REMAT_SAVE_ATTENTION
    _REMAT_SAVE_ATTENTION = bool(on)
    return prev


def _keep_flash_outputs(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if func is torch.ops.dualforce_tpu.flash_fwd_lse.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_context():
    """The `context_fn` of `torch.utils.checkpoint` (non-reentrant) around a
    rematerialised layer: PyTorch's selective checkpointing that keeps the
    flash forward's outputs while `remat_save_attention` is on, else plain
    checkpointing."""
    from torch.utils.checkpoint import (create_selective_checkpoint_contexts,
                                        noop_context_fn)

    if not _REMAT_SAVE_ATTENTION:
        return noop_context_fn()
    return create_selective_checkpoint_contexts(_keep_flash_outputs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    softmax_cap: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [B, S, N, D] tensors.

    CUDA tensors go to the kernel (bf16, D = 128, any Sq/Sk), which reads
    them through their strides; CPU tensors go to `flash_attention_plain`.
    `softmax_cap` selects the cap mode (`FAST_SOFTMAX_CAP` on the "fast"
    route). Differentiable in q, k and v through `flash_attention_bwd`
    (`dualforce_tpu::flash_fwd_lse`).
    """
    if _needs_grad(q, k, v):
        return _flash_fwd_lse(q, k, v, kv_valid_len, softmax_cap)[0]
    return _forward(q, k, v, kv_valid_len, with_lse=False, softmax_cap=softmax_cap)[0]


flash_attention.launches = 0
flash_attention.cap_launches = 0


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_valid_len: Optional[torch.Tensor] = None,
                             softmax_cap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, N, D], lse [B, N, Sq] fp32, natural log), differentiable in
    both outputs: the inner attention of sequence-parallel combines.
    `softmax_cap` as for `flash_attention`."""
    if _needs_grad(q, k, v):
        return _flash_fwd_lse(q, k, v, kv_valid_len, softmax_cap)
    return _forward(q, k, v, kv_valid_len, with_lse=True, softmax_cap=softmax_cap)

