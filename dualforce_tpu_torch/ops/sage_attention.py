"""Int8-QK ("sage") attention: the quantization prologue and the attention
kernel, their CUDA wrappers and their plain versions.

Counterpart of `sage_attention` and `_sage_fwd` in
`dualforce_tpu/ops/flash_attention.py` (the Pallas kernel
`_sage_fwd_kernel`, and the jnp prologue before it). Inference only: there
is no gradient, and an input that requires grad raises.

`sage_quantize` is the prologue: K in fp32 is mean-centred over all Sk keys
(masked ones included), then Q and K get per-block absmax int8 quantization
with scale = max(absmax, 1e-8) / 127, rounded half to even, the softmax
scale D^-1/2 and log2(e) folded into the q scales. Its arithmetic is that of
`_sage_fwd` as it runs, under jit, where XLA turns each division by a
constant (the mean's by Sk, the scale's by 127) into a product with the
fp32 reciprocal, and folds that reciprocal and the q scales' factor into one
fp32 constant; the codes are an IEEE division x / scale. The quantization
blocks are part of the numerics and follow JAX's rule (`sage_blocks`); the
block scales are handed on as per-row [B, N, Sq] and per-key [B, N, Sk]
vectors, so the kernel's tiles do not depend on them. CUDA tensors (bf16, D = 128)
go to the prologue's kernels in `csrc/sage_fwd.cu`, CPU tensors to
`sage_quantize_plain`. The two give Q's codes and scales bit for bit; the
kernels sum K over the keys in another order, so a K code may differ by one
at a rounding tie (`sage_quantize.launches` counts the CUDA calls).

`sage_fwd` is the attention kernel's function: s = float(Qi8 . Ki8^T) *
(q_scale * k_scale) in log2 units, keys past kv_valid_len excluded, P =
exp2(s - cap) with the static shift cap = `FAST_SOFTMAX_CAP` (a constant of
the kernel too), o = P V / rowsum(P) with a zero sum giving 0. CUDA tensors
go to the kernel (`csrc/sage_fwd.cu`: int8 q/k, bf16 v, D = 128, read
through tensor maps; a call whose CTAs would leave SMs idle is split over
keys, as the flash forward's `fwd_splits` decides, and merged in the same
call), which raises on what it does not take; CPU tensors go to
`sage_fwd_plain`. `sage_attention.launches` counts its calls.

Each wrapper launches its kernel for CUDA tensors or raises; there is no
fallback to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dualforce_tpu_torch.ops.flash_attention import (_MAX_GRID_Y, FAST_SOFTMAX_CAP,
                                                     FWD_BLOCK_M, HEAD_DIM, LOG2E, _chunk_rows,
                                                     _kernel, _key_mask, _lens, _sm_count,
                                                     fwd_splits, tma_geometry)

DEFAULT_BLOCK = 1024
# the kernel's C launcher: q, k, v, k_scale, their tensor-map geometry, o, q_scale, kv_len, the
# split workspace; then the prologue's
_SAGE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                  + [ctypes.c_void_p])
_QUANT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
# keys per partial sum of K's mean in the CUDA prologue; it sizes the workspace and is passed
SUM_CHUNK = 512


# --- the quantization blocks (JAX's rule; numerics, not tile sizes) ----------

def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _exact_bk(sk: int, bk_max: int, hi_cap: int) -> Optional[int]:
    """Largest multiple of 8 in [512, max(bk_max, hi_cap)] that divides sk."""
    hi = min(max(bk_max, hi_cap), sk)
    for cand in range(hi // 8 * 8, 511, -8):
        if sk % cand == 0:
            return cand
    return None


def _exact_bq(sq: int, bq: int, hi: int) -> int:
    """Largest multiple of 8 in [1024, hi] that divides sq, else bq."""
    for cand in range(hi // 8 * 8, 1023, -8):
        if sq % cand == 0:
            return cand
    return bq


def sage_blocks(sq: int, sk: int, masked: bool, block_q: int = DEFAULT_BLOCK,
                block_k: int = DEFAULT_BLOCK) -> Tuple[int, int]:
    """(q block, k block) of the int8 quantization, as `_sage_fwd` picks
    them: an exact divisor of Sq up to 1264 rows when the default is asked
    for, an exact divisor of Sk up to 2048 when there is no kv mask, else
    the requested size capped at Sq or Sk rounded up to 128."""
    bq = block_q
    if bq == DEFAULT_BLOCK and sq > bq:
        bq = _exact_bq(sq, bq, hi=1264)
    bq = min(bq, _ceil_to(sq, 128))
    if masked:
        bk = min(block_k, _ceil_to(sk, 128))
    else:
        bk = _exact_bk(sk, block_k, hi_cap=2048) or min(block_k, _ceil_to(sk, 128))
    return bq, bk


def _recip_f32(n: int) -> float:
    """1 / n rounded once to fp32 (1.0f / float(n)), as XLA folds a
    division by the constant n; a Python float that is exactly that value."""
    return (torch.ones((), dtype=torch.float32) / float(n)).item()


def _q_scale_factor(d: int) -> float:
    """What the q scales are the clamped block absmax times: fp32(1 / 127)
    times fp32(D^-1/2 log2(e)), one fp32 product, as XLA folds
    `max(absmax, 1e-8) / 127.0 * (d ** -0.5 * LOG2E)` under jit."""
    return (torch.tensor(_recip_f32(127), dtype=torch.float32)
            * torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)).item()


def _block_quant_int8(x: torch.Tensor, blk: int):
    """[B, S, N, D] (S a multiple of blk) -> (int8 [B, S, N, D], fp32
    clamped block absmax [B, S // blk, N]), as `_block_quant_int8` per
    (batch, head) on x cast to fp32 under jit: codes = round(x / scale) with
    scale = max(absmax, 1e-8) * fp32(1 / 127). The absmax is exact in x's
    dtype, and x / scale promotes to fp32 element by element, so no fp32
    copy of x is made."""
    b, s, n, d = x.shape
    xb = x.reshape(b, s // blk, blk, n, d)
    amax = xb.abs().amax(dim=(2, 4)).float().clamp_min(1e-8)
    sc = amax * _recip_f32(127)
    xi = torch.round_(xb / sc[:, :, None, :, None]).to(torch.int8)
    return xi.reshape(b, s, n, d), amax


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [B, S, N, D] with zero rows appended up to `rows`."""
    return x if rows == x.shape[1] else F.pad(x, (0, 0, 0, 0, 0, rows - x.shape[1]))


def _per_row(sc: torch.Tensor, blk: int, s: int) -> torch.Tensor:
    """Block scales [B, S_p // blk, N] -> per-row [B, N, s] (contiguous)."""
    return sc.permute(0, 2, 1).repeat_interleave(blk, dim=2)[:, :, :s].contiguous()


def sage_quantize_plain(q: torch.Tensor, k: torch.Tensor,
                        kv_valid_len: Optional[torch.Tensor] = None,
                        block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK):
    """The prologue of `_sage_fwd` in plain PyTorch on [B, S, N, D] q and k.
    Returns (q int8 [B, Sq, N, D], k int8 [B, Sk, N, D], q_scale [B, N, Sq]
    fp32 times D^-1/2 log2(e), k_scale [B, N, Sk] fp32), all contiguous."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bq, bk = sage_blocks(sq, sk, kv_valid_len is not None, block_q, block_k)
    sq_p, sk_p = _ceil_to(sq, bq), _ceil_to(sk, bk)
    kf = k.float()
    # over all Sk keys, masked ones too; the sum times fp32(1 / Sk), as `jnp.mean` under jit
    kf = kf - kf.sum(dim=1, keepdim=True) * _recip_f32(sk)
    qi, q_amax = _block_quant_int8(_pad_rows(q, sq_p), bq)
    ki, k_amax = _block_quant_int8(_pad_rows(kf, sk_p), bk)
    del kf
    q_sc = q_amax * _q_scale_factor(d)         # the softmax scale and log2(e) folded in
    k_sc = k_amax * _recip_f32(127)
    return (qi[:, :sq].contiguous(), ki[:, :sk].contiguous(),
            _per_row(q_sc, bq, sq), _per_row(k_sc, bk, sk))


def _launch_quantize(q, k, kv_valid_len, block_q, block_k):
    _check_view("q", q, torch.bfloat16, 8)
    _check_view("k", k, torch.bfloat16, 8)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != n or k.get_device() != q.get_device():
        raise ValueError(f"k {tuple(k.shape)} on {k.device} does not match q "
                         f"{tuple(q.shape)} on {q.device}")
    if b * n > _MAX_GRID_Y:
        raise ValueError(f"batch * heads = {b * n} exceeds {_MAX_GRID_Y}")
    bq, bk = sage_blocks(sq, sk, kv_valid_len is not None, block_q, block_k)
    dev = q.device
    qi = torch.empty((b, sq, n, d), dtype=torch.int8, device=dev)
    ki = torch.empty((b, sk, n, d), dtype=torch.int8, device=dev)
    q_scale = torch.empty((b, n, sq), dtype=torch.float32, device=dev)
    k_scale = torch.empty((b, n, sk), dtype=torch.float32, device=dev)
    if qi.numel() + ki.numel() == 0:
        return qi, ki, q_scale, k_scale
    partial = torch.empty((-(-sk // SUM_CHUNK), b * n, d), dtype=torch.float32, device=dev)
    err = _kernel("sage_fwd", "dft_sage_quantize", _QUANT_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), qi.data_ptr(), ki.data_ptr(), q_scale.data_ptr(),
        k_scale.data_ptr(), partial.data_ptr(), b, n, sq, sk, max(bq, 1), max(bk, 1), SUM_CHUNK,
        *q.stride()[:3], *k.stride()[:3], _q_scale_factor(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sage_quantize kernel launch failed: CUDA error {err}")
    sage_quantize.launches += 1
    return qi, ki, q_scale, k_scale


def sage_quantize(q: torch.Tensor, k: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK):
    """The prologue of `_sage_fwd` on [B, S, N, D] q and k: the CUDA kernels
    for CUDA tensors (bf16, D = 128, a unit D stride and the other strides
    multiples of 8), `sage_quantize_plain` for CPU tensors. Returns (q int8
    [B, Sq, N, D], k int8 [B, Sk, N, D], q_scale [B, N, Sq] fp32 times
    D^-1/2 log2(e), k_scale [B, N, Sk] fp32), all contiguous."""
    if q.is_cuda:
        return _launch_quantize(q, k, kv_valid_len, block_q, block_k)
    if q.device.type != "cpu":
        raise ValueError(f"sage attention runs on cuda or cpu, not {q.device}")
    return sage_quantize_plain(q, k, kv_valid_len, block_q, block_k)


sage_quantize.launches = 0


# --- plain version ----------------------------------------------------------

def sage_fwd_plain(qi: torch.Tensor, ki: torch.Tensor, v: torch.Tensor,
                   q_scale: torch.Tensor, k_scale: torch.Tensor,
                   kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in fp32. The int8 products are exact in fp32
    (|sum| <= 127^2 * 128 < 2^24), then s = s_i32 * (q_scale * k_scale),
    masked keys excluded, p = exp2(s - cap), o = P V / l with l == 0 giving
    0. Returns [B, Sq, N, D] in v's dtype. Queries go in chunks, as in
    `flash_attention_plain`."""
    b, sq, n, d = qi.shape
    sk = ki.shape[1]
    kf = ki.float().permute(0, 2, 3, 1)          # [B, N, D, Sk]
    vf = v.float().permute(0, 2, 1, 3)           # [B, N, Sk, D]
    keep = _key_mask(kv_valid_len, sk, qi.device)
    out = torch.empty((b, n, sq, d), dtype=v.dtype, device=v.device)
    chunk = _chunk_rows(b, n, sk)
    for s0 in range(0, sq, chunk):
        qc = qi[:, s0:s0 + chunk].float().permute(0, 2, 1, 3)          # [B, N, c, D]
        s = torch.matmul(qc, kf) * (q_scale[:, :, s0:s0 + chunk, None] * k_scale[:, :, None])
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.exp2(s - FAST_SOFTMAX_CAP)
        denom = p.sum(dim=-1, keepdim=True)
        denom = torch.where(denom == 0, 1.0, denom)
        out[:, :, s0:s0 + chunk] = (torch.matmul(p, vf) / denom).to(v.dtype)
    return out.permute(0, 2, 1, 3)


# --- kernel launch ----------------------------------------------------------

def _check_view(name, t, dtype, stride_multiple: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"the sage kernel takes {dtype} {name}, got {t.dtype}")
    if t.dim() != 4 or t.shape[3] != HEAD_DIM:
        raise ValueError(f"{name} must be [B, S, N, {HEAD_DIM}], got {tuple(t.shape)}")
    st = t.stride()
    if st[3] != 1 or any(x % stride_multiple for x in st[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit D stride, other strides a multiple of "
                         f"{stride_multiple} and a 16-byte aligned start; got {st}")


def _launch_sage(qi, ki, v, q_scale, k_scale, kv_valid_len):
    """The kernel on checked inputs."""
    _check_view("q", qi, torch.int8, 16)
    _check_view("k", ki, torch.int8, 16)
    _check_view("v", v, torch.bfloat16, 8)
    b, sq, n, d = qi.shape
    sk = ki.shape[1]
    if ki.shape != v.shape or ki.shape[0] != b or ki.shape[2] != n:
        raise ValueError(f"k/v shapes {tuple(ki.shape)}, {tuple(v.shape)} do not match "
                         f"q {tuple(qi.shape)}")
    dev = qi.get_device()
    for name, t, shape in (("q_scale", q_scale, (b, n, sq)), ("k_scale", k_scale, (b, n, sk))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned fp32 "
                             f"{list(shape)} tensor")
    if any(t.get_device() != dev for t in (ki, v, q_scale, k_scale)):
        raise ValueError("sage inputs must lie on one device")
    if b * n > _MAX_GRID_Y:
        raise ValueError(f"batch * heads = {b * n} exceeds {_MAX_GRID_Y}")
    if b * n * sk >= 2**31:
        raise ValueError(f"{b * n * sk} key scales pass the kernel's int32 coordinates")
    if kv_valid_len is not None and (kv_valid_len.get_device() != dev
                                     or kv_valid_len.shape != (b,)):
        raise ValueError(f"kv_valid_len must be [{b}] on {qi.device}")
    out = torch.empty(v.shape[:1] + (sq,) + v.shape[2:], dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    if sk == 0:     # no key at all: the kernel's keyless rows, without a launch
        return out.zero_()
    lens = _lens(kv_valid_len)
    # the kernel's tiles are the flash forward's: 128 query rows a CTA, 128 keys a stage
    splits = fwd_splits(b * n * -(-sq // FWD_BLOCK_M), sk, _sm_count(qi.device))
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, b * n * sq, d), dtype=torch.float32, device=v.device)
        part_ml = torch.empty((splits, b * n * sq, 2), dtype=torch.float32, device=v.device)
    geom = (*tma_geometry(qi.shape, qi.stride(), 1), *tma_geometry(ki.shape, ki.stride(), 1),
            *tma_geometry(v.shape, v.stride()))
    err = _kernel("sage_fwd", "dft_sage_fwd", _SAGE_ARGTYPES)(
        qi.data_ptr(), ki.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        (ctypes.c_ulonglong * len(geom))(*geom), out.data_ptr(), q_scale.data_ptr(),
        None if lens is None else lens.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, n, sq, sk, splits,
        sq * n * d, n * d, d, torch.cuda.current_stream(qi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sage_fwd kernel launch failed: error {err}")
    sage_attention.launches += 1
    return out


def sage_fwd(qi: torch.Tensor, ki: torch.Tensor, v: torch.Tensor, q_scale: torch.Tensor,
             k_scale: torch.Tensor, kv_valid_len: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """The kernel (CUDA tensors) or `sage_fwd_plain` (CPU tensors) on
    quantized inputs from `sage_quantize`."""
    if qi.is_cuda:
        return _launch_sage(qi, ki, v, q_scale, k_scale, kv_valid_len)
    if qi.device.type != "cpu":
        raise ValueError(f"sage attention runs on cuda or cpu, not {qi.device}")
    return sage_fwd_plain(qi, ki, v, q_scale, k_scale, kv_valid_len)


def _no_grad(q, k, v) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("sage attention is inference only: it has no gradient")


def sage_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid_len: Optional[torch.Tensor] = None,
                   block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK
                   ) -> torch.Tensor:
    """Int8-QK attention over [B, S, N, D] tensors: `sage_quantize`, then
    `sage_fwd`. Output in v's dtype."""
    _no_grad(q, k, v)
    qi, ki, q_scale, k_scale = sage_quantize(q, k, kv_valid_len, block_q, block_k)
    return sage_fwd(qi, ki, v, q_scale, k_scale, kv_valid_len)


sage_attention.launches = 0


def sage_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid_len: Optional[torch.Tensor] = None,
                         block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK
                         ) -> torch.Tensor:
    """`sage_attention` through `sage_quantize_plain` and `sage_fwd_plain` on
    any device: the kernels' reference, launching nothing."""
    _no_grad(q, k, v)
    qi, ki, q_scale, k_scale = sage_quantize_plain(q, k, kv_valid_len, block_q, block_k)
    return sage_fwd_plain(qi, ki, v, q_scale, k_scale, kv_valid_len)
