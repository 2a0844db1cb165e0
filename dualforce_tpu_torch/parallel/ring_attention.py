"""Sequence-parallel attention (counterpart of `dualforce_tpu/parallel/ring_attention.py`).

Each function runs in every rank of a mesh axis (`mesh.MeshAxis`) on that
rank's chunk of a sequence [B, S_local, N, D]:

  - `ring_attention`: the K/V chunks rotate around the axis
    (`mesh.ppermute_next`); each rank keeps its Q chunk and merges the
    partial results online by their log-sum-exps;
  - `lse_combine_cross_attention`: replicated queries against sharded K/V
    (the bridge's v2a direction): each rank attends to its chunk and the
    partials merge exactly through one fp32 all-reduce of the LSE-weighted
    sums;
  - `gather_kv_attention`: self-attention over a tiny sharded sequence
    (audio): gather K/V once and attend locally;
  - `ulysses_attention`: all-to-all so each rank holds the whole sequence
    for N / axis-size heads.

`inner` is the local attention (q, k, v, kv_valid) -> (out, natural-log LSE
[B, N, Sq] fp32). `global_valid_len` masks the zero-padded tail of a
sequence that the axis does not divide out of every softmax, so that cp > 1
equals cp = 1. A chunk with no valid key gets weight 0, by its valid length
and not by the kernel's LSE (B1 gives a keyless row -1e4 ln 2, not -inf),
and its attention is not computed at all. The combines run in fp32 plain
PyTorch, as the JAX package's are `jnp`. The ring skips the JAX loop's
rotation after its last step, which changes no number.

Every function is differentiable through its collectives (`mesh`: each
has JAX's transpose for its backward) and its inner, B1's autograd op on
the card (`dualforce_tpu::flash_fwd_lse`: the LSE's cotangent goes to the
backward kernel's delta), the plain one on the CPU. A skipped chunk's K/V
still join the graph, with a zero cotangent (`_joined`): its rotation's
backward then runs on every rank, and every rank's backward makes the same
calls in the same order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dualforce_tpu_torch.parallel import mesh as pm


def _inner_with_lse(q, k, v, kv_valid=None):
    """Plain local attention: (out, lse) from q/k/v [B, S, N, D]; keys at
    positions >= kv_valid [B] are masked. A row with no key gives out 0 and
    LSE -inf."""
    d = q.shape[-1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float() * d ** -0.5, k.float())
    if kv_valid is not None:
        kv_ids = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
        mask = kv_ids < kv_valid.to(q.device)[:, None, None, None]
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnqk,bknd->bqnd", p / l.clamp_min(1e-37), v.float())
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-37)), float("-inf"))
    return o.to(q.dtype), lse[..., 0]


def _inner_auto(q, k, v, kv_valid=None):
    """B1 with its LSE (`flash_attention_with_lse`) for CUDA tensors with
    head_dim % 128 == 0 and both Sq and Sk >= 128 (the JAX package's gate
    here, not the dispatcher's Sq >= 256); the plain version otherwise."""
    if q.is_cuda and q.shape[-1] % 128 == 0 and q.shape[1] >= 128 and k.shape[1] >= 128:
        from dualforce_tpu_torch.ops.flash_attention import flash_attention_with_lse

        return flash_attention_with_lse(q, k, v, kv_valid_len=kv_valid)
    return _inner_with_lse(q, k, v, kv_valid)


def _inner_pallas(q, k, v, kv_valid=None):
    """B1 with its LSE unconditionally (its plain version for CPU tensors)."""
    from dualforce_tpu_torch.ops.flash_attention import flash_attention_with_lse

    return flash_attention_with_lse(q, k, v, kv_valid_len=kv_valid)


def inner_for_impl(attn_impl) -> Callable:
    """The (q, k, v, kv_valid) -> (o, lse) inner of an attention route:
    "ref" the plain one, "pallas" B1, and "auto", "fast" and "sage" the
    exact B1 behind `_inner_auto` (no cap-mode or int8 LSE variant runs in
    a combine); a callable is taken as it is."""
    if callable(attn_impl):
        return attn_impl
    if attn_impl == "ref":
        return _inner_with_lse
    if attn_impl == "pallas":
        return _inner_pallas
    return _inner_auto


class _Join(torch.autograd.Function):
    """x as it is, with `others` in its graph: their cotangents are zeros."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.others))


def _joined(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """x, joined under autograd to tensors that it does not depend on, so
    that their producers' backward (a collective) runs on this rank too."""
    if torch.is_grad_enabled() and any(o.requires_grad for o in others):
        return _Join.apply(x, *others)
    return x


def _valid(global_valid_len: Optional[int], src: int, chunk: int, n: int) -> Optional[int]:
    """Valid keys of rank `src`'s chunk, or None when nothing is padded."""
    if global_valid_len is None or global_valid_len >= n * chunk:
        return None
    return min(max(global_valid_len - src * chunk, 0), chunk)


def _lens(kv_valid: Optional[int], b: int, device):
    return None if kv_valid is None else torch.full((b,), kv_valid, dtype=torch.int32,
                                                    device=device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: pm.MeshAxis,
                   inner: Callable = _inner_auto,
                   global_valid_len: Optional[int] = None) -> torch.Tensor:
    """Attention of this rank's queries over the whole sharded sequence.
    q/k/v: [B, S_local, N, D]. global_valid_len: the global token count
    where the padded sequence (axis size * S_local) exceeds it; the pad
    tail, on the last ranks' chunks, is masked in every rotating chunk."""
    n = pm.axis_size(axis)
    my = pm.axis_index(axis)
    b, sq, nh, d = q.shape
    chunk = k.shape[1]
    m = torch.full((b, nh, sq), float("-inf"), dtype=torch.float32, device=q.device)
    s = torch.zeros((b, nh, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, nh, d), dtype=torch.float32, device=q.device)
    k_c, v_c = k, v
    for i in range(n):
        kv_valid = _valid(global_valid_len, (my - i) % n, chunk, n)   # chunk from my - i
        if kv_valid != 0:
            o_i, lse_i = inner(q, k_c, v_c, _lens(kv_valid, b, q.device))
            m_new = torch.maximum(m, lse_i)
            w_old = torch.exp(m - m_new)
            w_new = torch.exp(lse_i - m_new)
            acc = (acc * w_old.transpose(1, 2)[..., None]
                   + o_i.float() * w_new.transpose(1, 2)[..., None])
            s = s * w_old + w_new
            m = m_new
        else:
            acc = _joined(acc, k_c, v_c)
        if i < n - 1:
            k_c, v_c = pm.ppermute_next([k_c, v_c], axis)
    return (acc / s.transpose(1, 2)[..., None]).to(q.dtype)


def lse_combine_cross_attention(q: torch.Tensor, k_local: torch.Tensor,
                                v_local: torch.Tensor, axis: pm.MeshAxis,
                                inner: Callable = _inner_auto,
                                global_valid_len: Optional[int] = None) -> torch.Tensor:
    """Replicated queries q [B, Sq, N, D] against sequence-sharded K/V:
    each rank's partial weighted by exp(lse - global max), summed over the
    axis in one fp32 all-reduce. global_valid_len: the global K/V token
    count (the last ranks' pad tails masked)."""
    n = pm.axis_size(axis)
    b, sq, nh, d = q.shape
    kv_valid = _valid(global_valid_len, pm.axis_index(axis), k_local.shape[1], n)
    if kv_valid == 0:
        # under autograd the zeros join q's and K/V's graph, so that the psum
        # below is differentiable on this rank too, as on the others
        o_i = _joined(torch.zeros((b, sq, nh, d), dtype=torch.float32, device=q.device),
                      q, k_local, v_local)
        lse_i = torch.full((b, nh, sq), float("-inf"), dtype=torch.float32, device=q.device)
    else:
        o_i, lse_i = inner(q, k_local, v_local, _lens(kv_valid, b, q.device))
    m = pm.pmax(lse_i, axis)     # detached; finite: the whole sequence has keys
    w = torch.exp(lse_i - m)                    # [B, N, Sq]; 0 for a keyless chunk
    part = torch.cat([(o_i.float() * w.transpose(1, 2)[..., None]).reshape(-1),
                      w.reshape(-1)])
    total = pm.psum(part, axis)
    num = total[:o_i.numel()].reshape(b, sq, nh, d)
    den = total[o_i.numel():].reshape(b, nh, sq)
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype)


def gather_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        axis: pm.MeshAxis, global_valid_len: Optional[int] = None,
                        impl="auto") -> torch.Tensor:
    """Self-attention over a tiny sharded sequence: K/V gathered whole, the
    pad tail masked, local attention through the dispatcher with `impl`."""
    from dualforce_tpu_torch.ops.attention import attention

    k_full = pm.all_gather(k, axis, dim=1)
    v_full = pm.all_gather(v, axis, dim=1)
    vlen = None
    if global_valid_len is not None and global_valid_len < k_full.shape[1]:
        vlen = _lens(global_valid_len, q.shape[0], q.device)
    return attention(q, k_full, v_full, kv_valid_len=vlen, impl=impl)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: pm.MeshAxis, inner: Optional[Callable] = None) -> torch.Tensor:
    """All-to-all so each rank holds the whole sequence for N / n heads (rank
    r the heads [r N/n, (r+1) N/n)), local attention, all-to-all back.
    Raises unless the head count divides by the axis size."""
    n = pm.axis_size(axis)
    nh = q.shape[2]
    if nh % n:
        raise ValueError(f"Ulysses attention needs heads % axis size == 0: {nh} heads "
                         f"over {n} ranks")

    def scatter_heads(x):    # [B, S_loc, N, D] -> [B, S_loc * n, N / n, D]
        b, s, _, d = x.shape
        x = x.reshape(b, s, n, nh // n, d).permute(2, 0, 1, 3, 4)
        x = pm.all_to_all(x, axis)                           # [n (source), B, S, N/n, D]
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * s, nh // n, d)

    def gather_heads(x):     # [B, S_full, N / n, D] -> [B, S_full / n, N, D]
        b, sf, nl, d = x.shape
        x = x.reshape(b, n, sf // n, nl, d).permute(1, 0, 2, 3, 4)
        x = pm.all_to_all(x, axis)                           # [n (source), B, S/n, N/n, D]
        return x.permute(1, 2, 0, 3, 4).reshape(b, sf // n, n * nl, d)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if inner is None:
        from dualforce_tpu_torch.ops.attention import attention

        out = attention(qh, kh, vh)
    else:
        out, _ = inner(qh, kh, vh)
    return gather_heads(out)
