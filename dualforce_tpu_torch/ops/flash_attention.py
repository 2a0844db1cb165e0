"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd glue.

Counterpart of `dualforce_tpu/ops/flash_attention.py`: the Pallas kernels
`_fwd_kernel` in exact mode (with or without the LSE output) and
`_bwd_fused_kernel`, behind `flash_attention` and `flash_attention_with_lse`.
The forward kernel (`csrc/flash_fwd.cu`) computes, per (batch, head),
softmax(Q K^T / sqrt(D) + kv mask) V, non-causal, D = 128, bf16 in and out
with fp32 accumulation, and optionally the natural-log LSE [B, N, Sq] in
fp32; keys at positions >= kv_valid_len[b] are excluded, and a query row with
no valid key returns zeros (LSE -1e4 * ln 2), not NaN. The backward kernel
(`csrc/flash_bwd.cu`) computes dq, dk and dv from q, k, v, dO, the LSE and
delta = rowsum(dO * O) - dlse in one pass.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it runs the plain PyTorch version of
the same function. There is no fallback from one to the other.

`flash_attention` and `flash_attention_with_lse` are differentiable through
`torch.autograd.Function`s (the counterparts of the JAX package's
`jax.custom_vjp` glue `_flash` and `_flash_lse`): when an input requires
grad, the forward runs with the LSE output and saves q, k, v, o and the LSE,
and the backward runs `flash_attention_bwd`. Without grad (serving, under
`torch.no_grad()`) `flash_attention` runs the forward without the LSE.
`flash_attention.launches` counts forward kernel launches and
`flash_attention_bwd.launches` backward ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dualforce_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 128
_MAX_FLOOR = -1.0e4          # running-max floor, in log2 units (the kernel's)
_PLAIN_SCORE_BYTES = 1 << 28  # fp32 score bytes the plain versions hold per q chunk
_MAX_GRID_Y = 65535           # batch * heads rides on the grid's y dimension

_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 18 + [ctypes.c_float, ctypes.c_void_p])
_FINISH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p])

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
                          return_lse: bool = False):
    """The forward kernel's function in plain PyTorch, in fp32.

    q: [B, Sq, N, D]; k, v: [B, Sk, N, D]; kv_valid_len: [B] int or None.
    Returns o [B, Sq, N, D] in q's dtype, and with `return_lse` also the
    natural-log LSE [B, N, Sq] in fp32. The running max is floored at the
    kernel's -1e4 (log2 units), so a row with no valid key returns zeros and
    an LSE of -1e4 * ln 2. Queries go in chunks that keep each fp32 score
    block near 256 MiB, so it runs at the main path's shapes on the card for
    a subset of heads.
    """
    b, sq, n, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
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
        m = s.amax(dim=-1, keepdim=True).clamp_min(_MAX_FLOOR / LOG2E)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        denom = torch.where(denom == 0, 1.0, denom)
        out[:, :, s0:s0 + chunk] = (torch.matmul(p, vf) / denom).to(q.dtype)
        lse[:, :, s0:s0 + chunk] = (m + torch.log(denom))[..., 0]
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


def _launch_fwd(q, k, v, kv_valid_len, with_lse: bool):
    shapes = (q.shape, k.shape, v.shape)
    strides = (q.stride(), k.stride(), v.stride())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    _check_cuda_inputs("qkv", (q, k, v), shapes, strides, ptrs)
    _check_qkv(q, k, v, kv_valid_len, shapes)
    b, sq, n, d = shapes[0]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lens = _lens(kv_valid_len)
    err = _kernel("flash_fwd", "dft_flash_fwd_bf16", _FWD_ARGTYPES)(
        *ptrs, out.data_ptr(), None if lse is None else lse.data_ptr(),
        None if lens is None else lens.data_ptr(), b, n, sq, shapes[1][1],
        *strides[0][:3], *strides[1][:3], *strides[2][:3], sq * n * d, n * d, d,
        d ** -0.5 * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def _launch_bwd(q, k, v, o, lse, do, kv_valid_len, dlse):
    shapes = (q.shape, k.shape, v.shape, do.shape)
    strides = (q.stride(), k.stride(), v.stride(), do.stride())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr())
    _check_cuda_inputs(("q", "k", "v", "do"), (q, k, v, do), shapes, strides, ptrs)
    _check_qkv(q, k, v, kv_valid_len, shapes[:3])
    b, sq, n, d = shapes[0]
    sk = shapes[1][1]
    if shapes[3] != shapes[0] or o.shape != shapes[0]:
        raise ValueError(f"do {tuple(shapes[3])} and o {tuple(o.shape)} must match "
                         f"q {tuple(shapes[0])}")
    if lse.shape != (b, n, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{b}, {n}, {sq}] tensor")
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = _delta(o, do, dlse)
    dq_acc = torch.zeros((b, n, sq, d), dtype=torch.float32, device=q.device)
    lens = _lens(kv_valid_len)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = d ** -0.5
    err = _kernel("flash_bwd", "dft_flash_bwd_bf16", _BWD_ARGTYPES)(
        *ptrs, lse.data_ptr(), delta.data_ptr(),
        None if lens is None else lens.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, n, sq, sk,
        *strides[0][:3], *strides[1][:3], *strides[2][:3], *strides[3][:3],
        sk * n * d, n * d, d, sk * n * d, n * d, d, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    err = _kernel("flash_bwd", "dft_flash_bwd_dq_finish", _FINISH_ARGTYPES)(
        dq_acc.data_ptr(), dq.data_ptr(), b, n, sq, sq * n * d, n * d, d, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dq finish launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _forward(q, k, v, kv_valid_len, with_lse: bool):
    """(o, lse or None) from the kernel (CUDA) or the plain version (CPU)."""
    if q.is_cuda:
        return _launch_fwd(q, k, v, kv_valid_len, with_lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if with_lse:
        return flash_attention_plain(q, k, v, kv_valid_len, return_lse=True)
    return flash_attention_plain(q, k, v, kv_valid_len), None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_valid_len: Optional[torch.Tensor] = None,
                        dlse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from its saved LSE: the backward
    kernel for CUDA tensors (bf16, D = 128; dq in bf16 after an fp32
    accumulation whose summation order varies from run to run), the plain
    version for CPU tensors. `flash_attention_bwd.launches` counts kernel
    launches."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, o, lse, do, kv_valid_len, dlse)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid_len, dlse)


flash_attention_bwd.launches = 0


# --- autograd ---------------------------------------------------------------

class _FlashLse(torch.autograd.Function):
    """(o, lse) = flash(q, k, v); the counterpart of `_flash` and `_flash_lse`
    with their custom VJPs. An unused output's cotangent arrives as None: an
    unused LSE adds nothing to delta, an unused o gives dO = 0."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid_len):
        o, lse = _forward(q, k, v, kv_valid_len, with_lse=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, o, lse, kv_valid_len)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_valid_len = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(q.dtype).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, kv_valid_len, dlse)
        return dq, dk, dv, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Flash attention over [B, S, N, D] tensors.

    CUDA tensors go to the kernel (bf16, D = 128, any Sq/Sk), which reads
    them through their strides; CPU tensors go to `flash_attention_plain`.
    Differentiable in q, k and v through `flash_attention_bwd`.
    """
    if _needs_grad(q, k, v):
        return _FlashLse.apply(q, k, v, kv_valid_len)[0]
    return _forward(q, k, v, kv_valid_len, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_valid_len: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, N, D], lse [B, N, Sq] fp32, natural log), differentiable in
    both outputs: the inner attention of sequence-parallel combines."""
    if _needs_grad(q, k, v):
        return _FlashLse.apply(q, k, v, kv_valid_len)
    return _forward(q, k, v, kv_valid_len, with_lse=True)

