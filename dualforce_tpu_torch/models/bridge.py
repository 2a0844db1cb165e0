"""Dual-tower conditional bridge (counterpart of `dualforce_tpu/models/bridge.py`).

Per interacting shared layer, two asymmetric cross-attentions read the
pre-interaction hidden states: a2v (q = video, kv = audio) and v2a (q =
audio, kv = video). Each normalises the conditioning sequence, RMS-norms q
and k, applies the time-aligned rotate-half RoPE on each side and adds its
output scaled by the condition scale. Conditioners are named by shared-layer
index (`audio_to_video_conditioners.{layer}`), as in the MOVA state dict.

With `pooled_adaln`, each v2a block first conditions the audio side on the
video pooled per frame: a learned probe attends over each frame's H*W
tokens (`nn.MultiheadAttention` semantics, one query, fp32 softmax as the
JAX package computes it with `einsum`), the pooled frames are interpolated
linearly in time to the audio's length, and an AdaLN (no affine, eps 1e-5)
takes its scale and shift from them. The parameters carry the reference's
names (`per_frame_pooling.probe`, `per_frame_pooling.attention.in_proj_weight`,
`per_frame_pooling.layernorm`, `adaln.linear`).

Under sequence parallelism (`layer_apply_sp`) both hidden states are
cp-sharded token chunks: a2v gathers the tiny audio side and attends
locally; v2a runs the whole audio sequence's queries against the local
video chunk and merges the ranks' partials by their LSEs
(`parallel.ring_attention.lse_combine_cross_attention`), then keeps the
local audio slice. Its pooled AdaLN pools frames that straddle the shards
by one more LSE combine (`per_frame_attention_pooling_sp`).
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.config import BridgeConfig
from dualforce_tpu_torch.models.video_dit import Attention
from dualforce_tpu_torch.ops.attention import attention
from dualforce_tpu_torch.ops.rope import apply_rope_half
from dualforce_tpu_torch.parallel import mesh as pm
from dualforce_tpu_torch.parallel.ring_attention import (inner_for_impl,
                                                         lse_combine_cross_attention)
from dualforce_tpu_torch.registry import MODELS


def _rotation(freqs):
    """The rotate-half RoPE with the tables `freqs` = (cos, sin), or None."""
    if freqs is None:
        return None
    return lambda t: apply_rope_half(t, *freqs)


class _PoolAttention(nn.Module):
    """The packed projections of `nn.MultiheadAttention` (its names)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, **f))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, **f))
        self.out_proj = nn.Linear(dim, dim, **f)


class PerFramePooling(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.probe = nn.Parameter(torch.empty(1, 1, dim, **f))
        self.attention = _PoolAttention(dim, **f)
        self.layernorm = dnn.LayerNorm(dim, eps, **f)


class _AdaLN(nn.Module):
    def __init__(self, cond_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 2 * dim, device=device, dtype=dtype)


def per_frame_attention_pooling(pool: PerFramePooling, y: torch.Tensor,
                                grid: Tuple[int, int, int], num_heads: int) -> torch.Tensor:
    """y [B, T*H*W, d] -> per-frame pooled [B, T, d]: the probe attends over
    each frame's tokens (logits and softmax in fp32), then the output
    projection and the LayerNorm."""
    b, _, d = y.shape
    t, h, w = grid
    hd = d // num_heads
    yf = y.reshape(b * t, h * w, d)
    wq, wk, wv = pool.attention.in_proj_weight.to(y.dtype).chunk(3, dim=0)   # fp8: upcast
    bq, bk, bv = pool.attention.in_proj_bias.to(y.dtype).chunk(3)
    q = F.linear(pool.probe.to(y.dtype), wq, bq).reshape(num_heads, hd)
    k = F.linear(yf, wk, bk).reshape(b * t, h * w, num_heads, hd)
    v = F.linear(yf, wv, bv).reshape(b * t, h * w, num_heads, hd)
    logits = torch.einsum("nd,bknd->bnk", q.float(), k.float()) * hd ** -0.5
    o = torch.einsum("bnk,bknd->bnd", logits.softmax(dim=-1), v.float()).to(y.dtype)
    pooled = pool.attention.out_proj(o.reshape(b * t, 1, d)).reshape(b, t, d)
    return pool.layernorm(pooled)


def per_frame_attention_pooling_sp(pool: PerFramePooling, y_local: torch.Tensor,
                                   grid: Tuple[int, int, int], num_heads: int,
                                   axis: pm.MeshAxis,
                                   video_valid: Optional[int] = None) -> torch.Tensor:
    """`per_frame_attention_pooling` of a sequence whose contiguous cp-chunk
    `y_local` [B, l, d] this rank holds, frames straddling the chunks: each
    frame's softmax is merged over the axis (the max of the per-frame logit
    maxima, then the sums of the exponentials and of the weighted values),
    local tokens bucketed by their global frame, pad tokens (positions >=
    `video_valid`) into a trash bucket. fp32, as the local version.
    Returns [B, T, d] on every rank."""
    b, l_loc, d = y_local.shape
    t, h, w = grid
    hd = d // num_heads
    wq, wk, wv = pool.attention.in_proj_weight.to(y_local.dtype).chunk(3, dim=0)
    bq, bk, bv = pool.attention.in_proj_bias.to(y_local.dtype).chunk(3)
    q = F.linear(pool.probe.to(y_local.dtype), wq, bq).reshape(num_heads, hd)
    k = F.linear(y_local, wk, bk).reshape(b, l_loc, num_heads, hd)
    v = F.linear(y_local, wv, bv).reshape(b, l_loc, num_heads, hd)
    gpos = pm.axis_index(axis) * l_loc + torch.arange(l_loc, device=y_local.device)
    valid = gpos < (t * h * w if video_valid is None else video_valid)
    gid = torch.where(valid, gpos // (h * w), t)               # pad tokens -> segment t
    logits = torch.einsum("nd,blnd->bln", q.float(), k.float()) * hd ** -0.5
    neg = -1e30
    logits = logits.masked_fill(~valid[None, :, None], neg)
    lt = logits.permute(1, 0, 2)                                # [l, b, n]
    seg = gid[:, None, None].expand_as(lt)
    m = torch.full((t + 1, b, num_heads), float("-inf"), device=y_local.device)
    m = pm.pmax(m.scatter_reduce(0, seg, lt.detach(), "amax"), axis).clamp_min(neg)
    e = torch.exp(lt - m[gid]).masked_fill(~valid[:, None, None], 0.0)
    den = torch.zeros((t + 1, b, num_heads), device=y_local.device).index_add_(0, gid, e)
    num = torch.zeros((t + 1, b, num_heads, hd), device=y_local.device).index_add_(
        0, gid, e[..., None] * v.float().permute(1, 0, 2, 3))
    total = pm.psum(torch.cat([den.reshape(-1), num.reshape(-1)]), axis)
    den, num = total[:den.numel()].reshape(den.shape), total[den.numel():].reshape(num.shape)
    o = num[:t] / den[:t, ..., None].clamp_min(1e-30)
    o = o.permute(1, 0, 2, 3).reshape(b, t, d).to(y_local.dtype)
    return pool.layernorm(pool.attention.out_proj(o))


def interp_linear_time(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """x [B, T, C] resampled linearly to [B, target_len, C] along T (half-pixel
    centres, `F.interpolate(mode="linear", align_corners=False)`). Shrinking
    filters with the stretched triangle as `jax.image.resize(..., "linear")`
    does (antialiasing), which the plain F.interpolate does not (ROADMAP C,
    caveat 11); growing is the same in both."""
    if x.shape[1] == target_len:
        return x
    xt = x.transpose(1, 2)
    if target_len > x.shape[1]:
        out = F.interpolate(xt, size=target_len, mode="linear", align_corners=False)
    else:
        out = F.interpolate(xt[:, :, None, :], size=(1, target_len), mode="bilinear",
                            align_corners=False, antialias=True)[:, :, 0, :]
    return out.transpose(1, 2)


def adaln_from_pooled(adaln: _AdaLN, x: torch.Tensor, pooled: torch.Tensor,
                      x_valid_len: Optional[int] = None) -> torch.Tensor:
    """LayerNorm(x) (no affine, eps 1e-5) * (1 + scale) + shift, scale and
    shift from the pooled condition interpolated to x's length, or to its
    first `x_valid_len` rows where x carries a cp pad tail (the pad rows
    get scale = shift = 0)."""
    lx = x.shape[1] if x_valid_len is None else x_valid_len
    temb = adaln.linear(F.silu(interp_linear_time(pooled, lx)))
    if lx < x.shape[1]:
        temb = F.pad(temb, (0, 0, 0, x.shape[1] - lx))
    scale, shift = temb.chunk(2, dim=2)
    return dnn.layer_norm(x, 1e-5) * (1 + scale) + shift


class ConditionalCrossAttentionBlock(nn.Module):
    def __init__(self, dim: int, kv_dim: int, num_heads: int, eps: float = 1e-6,
                 pooled_adaln: bool = False, device=None, dtype=None):
        super().__init__()
        if pooled_adaln and kv_dim % num_heads:
            raise ValueError(
                f"pooled_adaln pools the kv side ({kv_dim}) over the query-side head "
                f"count ({num_heads}); kv_dim % num_heads must be 0 "
                "(interactionv2.py:326 has the same constraint)")
        self.num_heads = num_heads
        self.eps = eps
        self.y_norm = dnn.LayerNorm(kv_dim, eps, device=device, dtype=dtype)
        self.inner = Attention(dim, kv_dim, eps, device=device, dtype=dtype)
        if pooled_adaln:
            self.per_frame_pooling = PerFramePooling(kv_dim, eps, device=device, dtype=dtype)
            self.adaln = _AdaLN(kv_dim, dim, device=device, dtype=dtype)

    def pooled_condition(self, x: torch.Tensor, y: torch.Tensor,
                         grid: Tuple[int, int, int]) -> torch.Tensor:
        """x conditioned by AdaLN on y pooled per frame of `grid`."""
        pooled = per_frame_attention_pooling(self.per_frame_pooling, y, grid,
                                             self.num_heads)
        return adaln_from_pooled(self.adaln, x, pooled)

    def forward(self, x: torch.Tensor, y: torch.Tensor, x_freqs, y_freqs,
                attn_impl="auto", kv_valid_len: Optional[torch.Tensor] = None,
                video_grid: Optional[Tuple[int, int, int]] = None,
                sp: Optional["ShardedKV"] = None) -> torch.Tensor:
        """LayerNorm(y), then cross-attention of x over y with per-side RoPE;
        with pooled AdaLN, x is first conditioned on y pooled per frame of
        `video_grid`. With `sp`, y (and `y_freqs`) is this rank's chunk of a
        sequence sharded over `sp.axis` and x is whole on every rank: the
        pooling and the attention merge the ranks' partials (JAX's
        `cond_block_apply_dist`)."""
        if hasattr(self, "per_frame_pooling"):
            if video_grid is None:
                raise ValueError("pooled_adaln requires video_grid")
            if sp is None:
                x = self.pooled_condition(x, y, video_grid)
            else:
                pooled = per_frame_attention_pooling_sp(
                    self.per_frame_pooling, y, video_grid, self.num_heads, sp.axis,
                    sp.kv_valid)
                x = adaln_from_pooled(self.adaln, x, pooled, sp.x_valid)
        b, sx, dim = x.shape
        q, k, v = self.inner.qkv(x, self.y_norm(y), self.num_heads, _rotation(x_freqs),
                                 _rotation(y_freqs))
        if sp is None:
            out = attention(q, k, v, kv_valid_len=kv_valid_len, impl=attn_impl)
        else:
            out = lse_combine_cross_attention(q, k, v, sp.axis, inner_for_impl(attn_impl),
                                              sp.kv_valid)
        return self.inner.o(out.reshape(b, sx, dim))


class ShardedKV(NamedTuple):
    """A cross-attention's K/V side sharded over `axis`: its global valid
    token count (None: no padding) and the valid length of the whole Q side
    (None: no padding), the pooled AdaLN's interpolation target."""
    axis: pm.MeshAxis
    kv_valid: Optional[int] = None
    x_valid: Optional[int] = None


@MODELS.register_module(name="DualTowerBridge")
class DualTowerBridge(nn.Module):
    # fp8 storage (`dnn.fp8_stored`): the JAX tree stacks both conditioner
    # lists; the inner attention's `norm_q`/`norm_k` and `y_norm` stay bf16
    FP8_STACKED = ("audio_to_video_conditioners.", "video_to_audio_conditioners.")
    FP8_EXEMPT = ("norm_q.", "norm_k.", "y_norm.")

    def __init__(self, cfg: BridgeConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        f = dict(device=device, dtype=dtype)
        v_heads = cfg.visual_hidden_dim // cfg.head_dim
        a_heads = cfg.audio_hidden_dim // cfg.head_dim
        layers = [str(i) for i in cfg.interaction_layers()]
        self.audio_to_video_conditioners = nn.ModuleDict({
            i: ConditionalCrossAttentionBlock(cfg.visual_hidden_dim, cfg.audio_hidden_dim,
                                              v_heads, cfg.eps, **f) for i in layers})
        # only v2a carries pooled AdaLN (interactionv2.py:412-418)
        self.video_to_audio_conditioners = nn.ModuleDict({
            i: ConditionalCrossAttentionBlock(cfg.audio_hidden_dim, cfg.visual_hidden_dim,
                                              a_heads, cfg.eps, cfg.pooled_adaln, **f)
            for i in layers})
        if cfg.trainable_condition_scale:
            self.condition_scale = nn.Parameter(torch.ones(1, **f))

    def resolve_condition_scale(self, external_scale: Optional[float]) -> torch.Tensor:
        """The external scale wins over the trainable one; default 1."""
        if external_scale is not None:
            return torch.tensor(float(external_scale))
        if self.cfg.trainable_condition_scale:
            return self.condition_scale.detach().float()[0]
        return torch.tensor(1.0)

    def layer_apply(self, layer: int, visual_x: torch.Tensor, audio_x: torch.Tensor,
                    visual_freqs, audio_freqs, a2v_scale: torch.Tensor,
                    v2a_scale: torch.Tensor, attn_impl="auto",
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    video_grid: Optional[Tuple[int, int, int]] = None):
        """One interaction at shared layer `layer`: both directions read the
        pre-interaction states. `params`: optional {name: tensor} in place of
        the bridge's own parameters (names from the bridge, see `nn.call`);
        `video_grid`: the video token grid, for pooled AdaLN."""
        a2v, v2a = "audio_to_video_conditioners", "video_to_audio_conditioners"
        dv = dnn.call(getattr(self, a2v)[str(layer)], params, f"{a2v}.{layer}.",
                      visual_x, audio_x, visual_freqs, audio_freqs, attn_impl)
        da = dnn.call(getattr(self, v2a)[str(layer)], params, f"{v2a}.{layer}.",
                      audio_x, visual_x, audio_freqs, visual_freqs, attn_impl, None,
                      video_grid)
        return (visual_x + dv * a2v_scale.to(visual_x.device, visual_x.dtype),
                audio_x + da * v2a_scale.to(audio_x.device, audio_x.dtype))

    def layer_apply_sp(self, layer: int, visual_x: torch.Tensor, audio_x: torch.Tensor,
                       visual_freqs_local, audio_freqs_full, a2v_scale: torch.Tensor,
                       v2a_scale: torch.Tensor, axis: pm.MeshAxis, attn_impl="auto",
                       params: Optional[Dict[str, torch.Tensor]] = None,
                       video_grid: Optional[Tuple[int, int, int]] = None,
                       video_valid: Optional[int] = None,
                       audio_valid: Optional[int] = None):
        """`layer_apply` on cp-sharded chunks (JAX's `layer_apply_sp`): a2v
        attends the local video queries to the gathered audio (its pad tail
        masked); v2a attends the whole audio to the local video chunk by the
        LSE combine and keeps this rank's audio slice. video_valid /
        audio_valid: the global token counts where the padded lengths exceed
        them."""
        a2v, v2a = "audio_to_video_conditioners", "video_to_audio_conditioners"
        la_local = audio_x.shape[1]
        audio_full = pm.all_gather(audio_x, axis, dim=1)
        a_vlen = None
        if audio_valid is not None and audio_valid < audio_full.shape[1]:
            a_vlen = torch.full((audio_x.shape[0],), audio_valid, dtype=torch.int32,
                                device=audio_x.device)
        dv = dnn.call(getattr(self, a2v)[str(layer)], params, f"{a2v}.{layer}.",
                      visual_x, audio_full, visual_freqs_local, audio_freqs_full, attn_impl,
                      a_vlen)
        da = dnn.call(getattr(self, v2a)[str(layer)], params, f"{v2a}.{layer}.",
                      audio_full, visual_x, audio_freqs_full, visual_freqs_local, attn_impl,
                      None, video_grid, ShardedKV(axis, video_valid, audio_valid))
        i = pm.axis_index(axis)
        da = da[:, i * la_local:(i + 1) * la_local]
        return (visual_x + dv * a2v_scale.to(visual_x.device, visual_x.dtype),
                audio_x + da * v2a_scale.to(audio_x.device, audio_x.dtype))

    def with_conditioners(self, a2v: Dict[int, nn.Module],
                          v2a: Dict[int, nn.Module]) -> "DualTowerBridge":
        """A view of this bridge (its config and condition scale) that holds
        only the conditioners given, {layer: block}: the streamed pass's
        bridge for one layer group."""
        view = copy.copy(self)
        view._modules = dict(self._modules,
                             audio_to_video_conditioners=nn.ModuleDict(
                                 {str(i): m for i, m in a2v.items()}),
                             video_to_audio_conditioners=nn.ModuleDict(
                                 {str(i): m for i, m in v2a.items()}))
        return view
