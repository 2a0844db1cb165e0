"""Interleaved dual-tower forward (counterpart of `dualforce_tpu/models/dual_tower.py`).

Per shared layer: the bridge (a2v, then v2a) when the layer interacts, then
a video block, then an audio block; then the video-only tail. The JAX
package scans the "full" strategy and unrolls the sparse ones; here one
Python loop serves both, looking each layer's conditioners up by index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dualforce_tpu_torch.models.bridge import DualTowerBridge


def forward_dual_tower(
    video_blocks,              # nn.ModuleList of the video tower's blocks
    audio_blocks,              # nn.ModuleList of the audio tower's blocks
    bridge: DualTowerBridge,
    visual_x: torch.Tensor,    # [B, Lv, V]
    audio_x: torch.Tensor,     # [B, La, A]
    visual_ctx: torch.Tensor,
    audio_ctx: torch.Tensor,
    visual_t_mod: torch.Tensor,
    audio_t_mod: torch.Tensor,
    visual_rope,
    audio_rope,
    cross_rope=None,           # ((cos_v, sin_v), (cos_a, sin_a)) or None
    condition_scale: Optional[float] = None,
    a2v_condition_scale: Optional[float] = None,
    v2a_condition_scale: Optional[float] = None,
    attn_impl="auto",
    ctx_valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    bcfg = bridge.cfg
    interact = set(bcfg.interaction_layers())
    vis_freqs = cross_rope[0] if cross_rope is not None else None
    aud_freqs = cross_rope[1] if cross_rope is not None else None
    a2v_scale = bridge.resolve_condition_scale(
        a2v_condition_scale if a2v_condition_scale is not None else condition_scale)
    v2a_scale = bridge.resolve_condition_scale(
        v2a_condition_scale if v2a_condition_scale is not None else condition_scale)

    for layer in range(bcfg.min_layers):
        if layer in interact:
            visual_x, audio_x = bridge.layer_apply(
                layer, visual_x, audio_x, vis_freqs, aud_freqs, a2v_scale, v2a_scale,
                attn_impl)
        visual_x = video_blocks[layer](visual_x, visual_ctx, visual_t_mod, visual_rope,
                                       attn_impl, ctx_valid_len)
        audio_x = audio_blocks[layer](audio_x, audio_ctx, audio_t_mod, audio_rope,
                                      attn_impl, ctx_valid_len)
    for layer in range(bcfg.min_layers, len(video_blocks)):
        visual_x = video_blocks[layer](visual_x, visual_ctx, visual_t_mod, visual_rope,
                                       attn_impl, ctx_valid_len)
    return visual_x, audio_x
