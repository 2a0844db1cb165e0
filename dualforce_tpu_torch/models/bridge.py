"""Dual-tower conditional bridge (counterpart of `dualforce_tpu/models/bridge.py`).

Per interacting shared layer, two asymmetric cross-attentions read the
pre-interaction hidden states: a2v (q = video, kv = audio) and v2a (q =
audio, kv = video). Each normalises the conditioning sequence, RMS-norms q
and k, applies the time-aligned rotate-half RoPE on each side and adds its
output scaled by the condition scale. Conditioners are named by shared-layer
index (`audio_to_video_conditioners.{layer}`), as in the MOVA state dict.
The pooled-AdaLN variant and the sequence-parallel variants are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.config import BridgeConfig
from dualforce_tpu_torch.models.video_dit import Attention
from dualforce_tpu_torch.ops.attention import attention
from dualforce_tpu_torch.ops.rope import apply_rope_half


def _rotation(freqs):
    """The rotate-half RoPE with the tables `freqs` = (cos, sin), or None."""
    if freqs is None:
        return None
    return lambda t: apply_rope_half(t, *freqs)


class ConditionalCrossAttentionBlock(nn.Module):
    def __init__(self, dim: int, kv_dim: int, num_heads: int, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.y_norm = dnn.LayerNorm(kv_dim, eps, device=device, dtype=dtype)
        self.inner = Attention(dim, kv_dim, eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor, x_freqs, y_freqs,
                attn_impl="auto",
                kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """LayerNorm(y), then cross-attention of x over y with per-side RoPE."""
        b, sx, dim = x.shape
        q, k, v = self.inner.qkv(x, self.y_norm(y), self.num_heads, _rotation(x_freqs),
                                 _rotation(y_freqs))
        out = attention(q, k, v, kv_valid_len=kv_valid_len, impl=attn_impl)
        return self.inner.o(out.reshape(b, sx, dim))


class DualTowerBridge(nn.Module):
    def __init__(self, cfg: BridgeConfig, device=None, dtype=None):
        super().__init__()
        if cfg.pooled_adaln:
            raise NotImplementedError("pooled_adaln bridges are not ported")
        self.cfg = cfg
        f = dict(device=device, dtype=dtype)
        v_heads = cfg.visual_hidden_dim // cfg.head_dim
        a_heads = cfg.audio_hidden_dim // cfg.head_dim
        layers = [str(i) for i in cfg.interaction_layers()]
        self.audio_to_video_conditioners = nn.ModuleDict({
            i: ConditionalCrossAttentionBlock(cfg.visual_hidden_dim, cfg.audio_hidden_dim,
                                              v_heads, cfg.eps, **f) for i in layers})
        self.video_to_audio_conditioners = nn.ModuleDict({
            i: ConditionalCrossAttentionBlock(cfg.audio_hidden_dim, cfg.visual_hidden_dim,
                                              a_heads, cfg.eps, **f) for i in layers})
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
                    params: Optional[Dict[str, torch.Tensor]] = None):
        """One interaction at shared layer `layer`: both directions read the
        pre-interaction states. `params`: optional {name: tensor} in place of
        the bridge's own parameters (names from the bridge, see `nn.call`)."""
        a2v, v2a = "audio_to_video_conditioners", "video_to_audio_conditioners"
        dv = dnn.call(getattr(self, a2v)[str(layer)], params, f"{a2v}.{layer}.",
                      visual_x, audio_x, visual_freqs, audio_freqs, attn_impl)
        da = dnn.call(getattr(self, v2a)[str(layer)], params, f"{v2a}.{layer}.",
                      audio_x, visual_x, audio_freqs, visual_freqs, attn_impl)
        return (visual_x + dv * a2v_scale.to(visual_x.device, visual_x.dtype),
                audio_x + da * v2a_scale.to(audio_x.device, audio_x.dtype))
