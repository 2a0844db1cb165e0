"""Attention dispatch (counterpart of `dualforce_tpu/ops/attention.py`).

Every DiT and bridge attention goes through `attention(q, k, v)` with the
[B, S, N, D] layout, non-causal, scale 1/sqrt(D), optionally with a
per-batch kv-length mask. The gate is the JAX package's: Sq >= 256 and
D % 128 == 0 go to `flash_attention` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors); the rest go to `attention_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from dualforce_tpu_torch.ops.flash_attention import flash_attention

_FLASH_MIN_SEQ = 256


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
    """impl: "auto" | "ref" | a callable (q, k, v, kv_valid_len) -> out, the
    hook a sequence-parallel caller uses to inject its own attention. The
    JAX package's "fast", "sage" and "pallas" modes are not ported."""
    if callable(impl):
        return impl(q, k, v, kv_valid_len)
    if impl == "ref":
        return attention_ref(q, k, v, kv_valid_len)
    if impl != "auto":
        raise NotImplementedError(f"attention impl {impl!r} is not ported")
    if q.shape[1] < _FLASH_MIN_SEQ or q.shape[-1] % 128 != 0:
        return attention_ref(q, k, v, kv_valid_len)
    return flash_attention(q, k, v, kv_valid_len)
