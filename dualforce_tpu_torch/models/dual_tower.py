"""Interleaved dual-tower forward (counterpart of `dualforce_tpu/models/dual_tower.py`).

Per shared layer: the bridge (a2v, then v2a) when the layer interacts, then
a video block, then an audio block; then the video-only tail. The JAX
package scans the "full" strategy and unrolls the sparse ones; here one
Python loop serves both, looking each layer's conditioners up by index.
With `remat`, each shared layer and each tail layer runs under
`torch.utils.checkpoint` (non-reentrant), the counterpart of the JAX
package's `jax.checkpoint` around its scan bodies: the backward recomputes
the layer instead of keeping its activations. Under
`ops.flash_attention.remat_save_attention` the checkpoint keeps the flash
forward's outputs (`checkpoint_context`), so the recompute skips it.

Under sequence parallelism (`sp_axis`, from `parallel/sp.sp_forward_blocks`)
the hidden states are this rank's token chunks: video self-attention runs
as a ring, audio self-attention gathers its K/V, text cross-attention stays
local, and the bridge takes `layer_apply_sp` (JAX's `sp_axis` overrides).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.models.bridge import DualTowerBridge
from dualforce_tpu_torch.ops.flash_attention import checkpoint_context
from dualforce_tpu_torch.parallel import mesh as pm
from dualforce_tpu_torch.parallel.ring_attention import (gather_kv_attention,
                                                         inner_for_impl, ring_attention)


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
    remat: bool = False,
    params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    video_grid: Optional[Tuple[int, int, int]] = None,
    layers: Optional[Tuple[int, int]] = None,
    sp_axis: Optional[pm.MeshAxis] = None,
    sp_video_valid: Optional[int] = None,
    sp_audio_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """layers: run only layers [s0, s1) of the stack (all by default), the
    counterpart of JAX's `shared_layers`/`interact_override`: the layer-group
    streamed pass (`diffusion/streamed.py`) calls it once per group. Layer
    indices stay global: `video_blocks` and `audio_blocks` need only hold
    the range's layers under their global indices (a list or a {layer:
    block} mapping), the bridge only their conditioners. A layer below the
    bridge's shared depth is a shared layer, the rest are the video tail.

    video_grid: the video's (frames, height, width) token grid, which a
    pooled-AdaLN bridge pools over.

    params: optional {"video" | "audio" | "bridge": {name: tensor}}, tensors
    that stand in for the towers' and the bridge's own parameters of those
    names (named from the tower, `blocks.{i}.self_attn.q.weight`, and from
    the bridge): the LoRA-merged weights of training. They are read inside
    each (rematerialised) layer, so a recompute sees them too; a mapping that
    computes each as it is read (`engine.lora.MergedWeights`) is computed
    there, again in the recompute, and not kept between; one that gathers
    each from its fsdp shards (`parallel.sharding.GatheredWeights`) is the
    counterpart of JAX's `layer_param_map`.

    sp_axis: the mesh axis the token sequences are sharded over; the
    inputs are then this rank's chunks and sp_video_valid / sp_audio_valid
    the global token counts where the padded lengths exceed them."""
    bcfg = bridge.cfg
    interact = set(bcfg.interaction_layers())
    vis_freqs = cross_rope[0] if cross_rope is not None else None
    aud_freqs = cross_rope[1] if cross_rope is not None else None
    a2v_scale = bridge.resolve_condition_scale(
        a2v_condition_scale if a2v_condition_scale is not None else condition_scale)
    v2a_scale = bridge.resolve_condition_scale(
        v2a_condition_scale if v2a_condition_scale is not None else condition_scale)
    params = params or {}
    vp, ap = params.get("video"), params.get("audio")
    v_self_impl = a_self_impl = attn_impl
    cross_impl = None                  # the block's own rule
    if sp_axis is not None:
        ring_inner = inner_for_impl(attn_impl)
        cross_impl = attn_impl         # the text context is whole: local attention

        def v_self_impl(q, k, v, kv_valid_len=None):    # noqa: F811: the ring
            return ring_attention(q, k, v, sp_axis, ring_inner, sp_video_valid)

        def a_self_impl(q, k, v, kv_valid_len=None):    # noqa: F811: gathered K/V
            return gather_kv_attention(q, k, v, sp_axis, sp_audio_valid, attn_impl)

    def video_layer(vx, layer):
        return dnn.call(video_blocks[layer], vp, f"blocks.{layer}.", vx, visual_ctx,
                        visual_t_mod, visual_rope, v_self_impl, ctx_valid_len, cross_impl)

    def shared_layer(vx, ax, layer):
        if layer in interact and sp_axis is not None:
            vx, ax = bridge.layer_apply_sp(layer, vx, ax, vis_freqs, aud_freqs, a2v_scale,
                                           v2a_scale, sp_axis, attn_impl,
                                           params.get("bridge"), video_grid,
                                           sp_video_valid, sp_audio_valid)
        elif layer in interact:
            vx, ax = bridge.layer_apply(layer, vx, ax, vis_freqs, aud_freqs, a2v_scale,
                                        v2a_scale, attn_impl, params.get("bridge"),
                                        video_grid)
        vx = video_layer(vx, layer)
        ax = dnn.call(audio_blocks[layer], ap, f"blocks.{layer}.", ax, audio_ctx,
                      audio_t_mod, audio_rope, a_self_impl, ctx_valid_len, cross_impl)
        return vx, ax

    def run(fn, *args):
        if not remat:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=checkpoint_context)

    s0, s1 = layers if layers is not None else (0, len(video_blocks))
    for layer in range(s0, s1):
        if layer < bcfg.min_layers:
            visual_x, audio_x = run(shared_layer, visual_x, audio_x, layer)
        else:
            visual_x = run(video_layer, visual_x, layer)
    return visual_x, audio_x
