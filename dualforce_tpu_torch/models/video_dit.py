"""Wan-style video DiT (counterpart of `dualforce_tpu/models/video_dit.py`).

Parameter names are the MOVA/HF state-dict names (`blocks.{i}.self_attn.q`,
`ffn.0`, `time_projection.1`, ...), so a released checkpoint loads into these
modules as it is. The DiT block here is shared by the audio tower.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.config import VideoDiTConfig
from dualforce_tpu_torch.ops.attention import attention
from dualforce_tpu_torch.ops.rope import apply_rope_interleaved
from dualforce_tpu_torch.registry import MODELS


class Attention(nn.Module):
    """q/k/v/o projections with RMS-normed q and k."""

    def __init__(self, dim: int, kv_dim: Optional[int] = None, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        kv_dim = kv_dim or dim
        f = dict(device=device, dtype=dtype)
        self.q = nn.Linear(dim, dim, **f)
        self.k = nn.Linear(kv_dim, dim, **f)
        self.v = nn.Linear(kv_dim, dim, **f)
        self.o = nn.Linear(dim, dim, **f)
        self.norm_q = dnn.RMSNorm(dim, eps, **f)
        self.norm_k = dnn.RMSNorm(dim, eps, **f)

    def qkv(self, x: torch.Tensor, ctx: torch.Tensor, num_heads: int,
            q_rope=None, k_rope=None):
        """Projected, RMS-normed q [B, Sx, N, D] and k, v [B, Sc, N, D].
        `q_rope` and `k_rope`, if given, rotate the normed q and k (functions
        of a [B, S, N, D] tensor): norm and rotation run as one chain whose
        fp32 intermediates are recomputed in the backward."""
        b, s, dim = x.shape
        sc = ctx.shape[1]
        d = dim // num_heads
        q = dnn.recompute_in_backward(_norm_rope, self.q(x), self.norm_q.weight,
                                      self.norm_q.eps, (b, s, num_heads, d), q_rope)
        k = dnn.recompute_in_backward(_norm_rope, self.k(ctx), self.norm_k.weight,
                                      self.norm_k.eps, (b, sc, num_heads, d), k_rope)
        v = self.v(ctx).reshape(b, sc, num_heads, d)
        return q, k, v


def _norm_rope(x, weight, eps, shape, rope):
    y = dnn.rms_norm(x, weight, eps).reshape(shape)
    return y if rope is None else rope(y)


def _gelu_linear(x, weight, bias):
    return F.linear(dnn.gelu_tanh(x), weight.to(x.dtype), bias.to(x.dtype))   # fp8: upcast


def self_attention(attn: Attention, x: torch.Tensor, rope, num_heads: int,
                   attn_impl="auto") -> torch.Tensor:
    """RMS-normed q/k, interleaved RoPE, then attention. The rotation runs
    in fp32, but in bf16 on the "sage" route, whose int8 quantization of q
    and k lies far below bf16's precision (as in the JAX package)."""
    b, s, dim = x.shape
    cos, sin = rope
    rope_dtype = torch.bfloat16 if attn_impl == "sage" else torch.float32

    def rotate(t):
        return apply_rope_interleaved(t, cos, sin, rope_dtype)

    q, k, v = attn.qkv(x, x, num_heads, rotate, rotate)
    return attn.o(attention(q, k, v, impl=attn_impl).reshape(b, s, dim))


def cross_attention(attn: Attention, x: torch.Tensor, ctx: torch.Tensor,
                    num_heads: int, attn_impl="auto",
                    ctx_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Text cross-attention, no RoPE."""
    b, s, dim = x.shape
    q, k, v = attn.qkv(x, ctx, num_heads)
    out = attention(q, k, v, kv_valid_len=ctx_valid_len, impl=attn_impl)
    return attn.o(out.reshape(b, s, dim))


class DiTBlock(nn.Module):
    """AdaLN-modulated block: self-attention, text cross-attention, FFN."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.eps = eps
        self.self_attn = Attention(dim, eps=eps, **f)
        self.cross_attn = Attention(dim, eps=eps, **f)
        self.norm3 = dnn.LayerNorm(dim, eps, **f)
        self.ffn = nn.Sequential(nn.Linear(dim, ffn_dim, **f),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(ffn_dim, dim, **f))
        self.modulation = nn.Parameter(torch.empty(1, 6, dim, **f))

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, t_mod: torch.Tensor,
                rope, attn_impl="auto",
                ctx_valid_len: Optional[torch.Tensor] = None,
                cross_attn_impl=None) -> torch.Tensor:
        """x [B, S, dim]; t_mod [B, 6, dim] in the compute dtype.
        cross_attn_impl: the text cross-attention's route (by default
        `attn_impl`, or "auto" where that is a callable)."""
        mod = self.modulation.to(t_mod.dtype) + t_mod
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mod[:, :, None, :].unbind(1)
        h = dnn.layer_norm(x, self.eps) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self_attention(self.self_attn, h, rope, self.num_heads,
                                          attn_impl)
        h = self.norm3(x)
        cross_impl = cross_attn_impl or (attn_impl if not callable(attn_impl) else "auto")
        x = x + cross_attention(self.cross_attn, h, ctx, self.num_heads,
                                cross_impl, ctx_valid_len)
        h = dnn.layer_norm(x, self.eps) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.feed_forward(h)

    def feed_forward(self, h: torch.Tensor) -> torch.Tensor:
        """`self.ffn(h)`. With bf16 linears, the GELU and the product after
        it run as one chain recomputed in the backward, so the GELU's output
        ([B, S, ffn_dim], 4.5 GiB at 720p video) is not kept for it."""
        up, down = self.ffn[0], self.ffn[2]
        if not isinstance(down, nn.Linear):       # quantized serving towers
            return self.ffn(h)
        return dnn.recompute_in_backward(_gelu_linear, up(h), down.weight, down.bias)


class Head(nn.Module):
    """Final modulated projection; t is the [B, dim] time embedding."""

    def __init__(self, dim: int, out_features: int, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.head = nn.Linear(dim, out_features, device=device, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 2, dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        mod = self.modulation.to(t.dtype) + t[:, None, :]
        shift, scale = mod[:, 0:1], mod[:, 1:2]
        return self.head(dnn.layer_norm(x, self.eps) * (1 + scale) + shift)


class DiTTower(nn.Module):
    """Embeddings, blocks and head shared by the video and audio towers."""

    # fp8 storage (`dnn.fp8_stored`): the JAX tree stacks `blocks`; its
    # `modulation`, `norm_q`, `norm_k` and `norm3` leaves stay bf16
    FP8_STACKED = ("blocks.",)
    FP8_EXEMPT = ("modulation", "norm_q.", "norm_k.", "norm3.")

    def __init__(self, cfg, patch_embedding: nn.Module, out_features: int,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embedding = patch_embedding
        self.text_embedding = nn.Sequential(nn.Linear(cfg.text_dim, cfg.dim, **f),
                                            nn.GELU(approximate="tanh"),
                                            nn.Linear(cfg.dim, cfg.dim, **f))
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, cfg.dim, **f),
                                            nn.SiLU(),
                                            nn.Linear(cfg.dim, cfg.dim, **f))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(cfg.dim, cfg.dim * 6, **f))
        self.blocks = nn.ModuleList(
            DiTBlock(cfg.dim, cfg.ffn_dim, cfg.num_heads, cfg.eps, **f)
            for _ in range(cfg.num_layers))
        self.head = Head(cfg.dim, out_features, cfg.eps, **f)

    def time_embeds(self, timestep: torch.Tensor):
        """fp32 time embedding and its 6-way projection: (t [B, dim],
        t_mod [B, 6, dim]), both fp32; the caller casts them down."""
        emb = dnn.sinusoidal_embedding_1d(self.cfg.freq_dim, timestep.float())
        fc1, fc2 = self.time_embedding[0], self.time_embedding[2]
        t = F.linear(F.silu(F.linear(emb, fc1.weight.float(), fc1.bias.float())),
                     fc2.weight.float(), fc2.bias.float())
        tp = self.time_projection[1]
        t_mod = F.linear(F.silu(t), tp.weight.float(), tp.bias.float())
        return t, t_mod.reshape(t.shape[0], 6, self.cfg.dim)

    def embed_text(self, context: torch.Tensor) -> torch.Tensor:
        """text_dim -> dim MLP with tanh-GELU."""
        return self.text_embedding(context)


@MODELS.register_module(name="VideoDiT")
class VideoDiT(DiTTower):
    """The video tower (WanModel): Conv3d patchify, 3D RoPE."""

    def __init__(self, cfg: VideoDiTConfig, device=None, dtype=None):
        patch = nn.Conv3d(cfg.in_dim, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                          device=device, dtype=dtype)
        super().__init__(cfg, patch, cfg.out_dim * math.prod(cfg.patch_size),
                         device, dtype)

    def patchify(self, x: torch.Tensor):
        """[B, C, F, H, W] -> (tokens [B, f*h*w, dim], grid)."""
        return dnn.patch_embed_3d(x, self.patch_embedding.weight,
                                  self.patch_embedding.bias, self.cfg.patch_size)

    def unpatchify(self, x: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
        return dnn.unpatchify_3d(x, grid, self.cfg.patch_size, self.cfg.out_dim)
