"""Attention dispatch (counterpart of `dualforce_tpu/ops/attention.py`).

Every DiT and bridge attention goes through `attention(q, k, v)` with the
[B, S, N, D] layout, non-causal, scale 1/sqrt(D), optionally with a
per-batch kv-length mask. The routing is the JAX package's: "auto", "fast"
and "sage" take the gate Sq >= 256 and D % 128 == 0, and the rest go to
`attention_ref`; past the gate "auto" reaches `flash_attention` in exact
mode, "fast" its cap mode (`FAST_SOFTMAX_CAP`) and "sage" `sage_attention`.
"pallas" reaches `flash_attention` with no gate. The kernels run for CUDA
tensors and their plain versions for CPU tensors (where JAX's gate also asks
whether a TPU is present, the port's tensors' device decides).
"""

from __future__ import annotations

from typing import Optional

import torch

from dualforce_tpu_torch.ops.flash_attention import FAST_SOFTMAX_CAP, flash_attention
from dualforce_tpu_torch.ops.sage_attention import sage_attention

_FLASH_MIN_SEQ = 256
ATTN_IMPLS = ("auto", "fast", "sage", "pallas", "ref")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention with an fp32 softmax. [B, S, N, D] -> [B, Sq, N, D].
    Like the JAX reference, a row with no valid key gives NaN."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float() * q.shape[-1] ** -0.5, k.float())
    if kv_valid_len is not None:
        kv_ids = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
        mask = kv_ids < kv_valid_len.to(q.device)[:, None, None, None]
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_valid_len: Optional[torch.Tensor] = None,
              impl="auto") -> torch.Tensor:
    """impl: "auto" | "fast" | "sage" | "pallas" | "ref" | a callable
    (q, k, v, kv_valid_len) -> out, the hook a sequence-parallel caller uses
    to inject its own attention. "fast" is the static-shift softmax (exact
    for QK-normed attention, which all MOVA attention is); "sage" the
    int8-QK kernel (inference only)."""
    if callable(impl):
        return impl(q, k, v, kv_valid_len)
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of {ATTN_IMPLS}")
    if impl == "ref":
        return attention_ref(q, k, v, kv_valid_len)
    if impl != "pallas" and (q.shape[1] < _FLASH_MIN_SEQ or q.shape[-1] % 128 != 0):
        return attention_ref(q, k, v, kv_valid_len)
    if impl == "sage":
        return sage_attention(q, k, v, kv_valid_len)
    cap = FAST_SOFTMAX_CAP if impl == "fast" else None
    return flash_attention(q, k, v, kv_valid_len, softmax_cap=cap)
