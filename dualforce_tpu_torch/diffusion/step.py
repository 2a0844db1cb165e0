"""One dual-tower denoise step (counterpart of `dualforce_tpu/diffusion/step.py`).

fp32 time embeddings -> per-tower text embeddings -> patchify + RoPE ->
interleaved dual-tower forward -> heads -> unpatchify. The RoPE tables
depend only on the generation geometry: build them once per generation with
`make_rope_pack` and pass them to every step.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from dualforce_tpu_torch import resolve_device
from dualforce_tpu_torch.config import AudioDiTConfig, BridgeConfig, VideoDiTConfig
from dualforce_tpu_torch.models.audio_dit import AudioDiT
from dualforce_tpu_torch.models.bridge import DualTowerBridge
from dualforce_tpu_torch.models.dual_tower import forward_dual_tower
from dualforce_tpu_torch.models.video_dit import VideoDiT
from dualforce_tpu_torch.ops.rope import (build_aligned_cross_rope, build_audio_freqs,
                                          build_video_freqs, precompute_freqs_1d,
                                          precompute_freqs_3d)


@functools.lru_cache(maxsize=8)
def _video_tables(cfg: VideoDiTConfig):
    return precompute_freqs_3d(cfg.head_dim, end=cfg.rope_max_len)


@functools.lru_cache(maxsize=8)
def _audio_tables(cfg: AudioDiTConfig):
    return precompute_freqs_1d(cfg.head_dim, end=cfg.rope_max_len, variant=cfg.vae_type)


def make_rope_pack(vcfg: VideoDiTConfig, acfg: AudioDiTConfig, bcfg: BridgeConfig,
                   grid: Tuple[int, int, int], audio_tokens: int,
                   video_fps: float = 24.0, device="cuda"):
    """RoPE tables for a generation geometry, built on the host in float64
    and moved to `device` (CUDA unless the caller asks for the CPU) as fp32:
    {"v": (cos, sin), "a": (cos, sin)} and, when the bridge applies cross
    RoPE, "cross": ((cos_v, sin_v), (cos_a, sin_a))."""
    device = resolve_device(device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    v_cos, v_sin = build_video_freqs(_video_tables(vcfg), grid)
    a_cos, a_sin = build_audio_freqs(_audio_tables(acfg), audio_tokens)
    pack = {"v": (dev(v_cos), dev(v_sin)),
            "a": (dev(a_cos.copy()), dev(a_sin.copy()))}
    if bcfg.apply_cross_rope:
        (cv, sv), (ca, sa) = build_aligned_cross_rope(
            video_fps=video_fps, grid=grid, audio_steps=audio_tokens,
            audio_fps=bcfg.audio_fps, head_dim=bcfg.head_dim, theta=bcfg.rope_theta,
            first_frame_bias=bcfg.apply_first_frame_bias_in_rope)
        pack["cross"] = ((dev(cv), dev(sv)), (dev(ca), dev(sa)))
    return pack


def dual_tower_step(
    video: VideoDiT,
    audio: AudioDiT,
    bridge: DualTowerBridge,
    visual_latents: torch.Tensor,   # [B, C_in, F, H, W] (noisy z + mask + cond)
    audio_latents: torch.Tensor,    # [B, C_a, T]
    context: torch.Tensor,          # [B, L, text_dim]
    timestep: torch.Tensor,         # [B]
    audio_timestep: Optional[torch.Tensor] = None,
    video_fps: float = 24.0,
    condition_scale: Optional[float] = None,
    a2v_condition_scale: Optional[float] = None,
    v2a_condition_scale: Optional[float] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl="auto",
    ctx_valid_len: Optional[torch.Tensor] = None,
    rope_pack=None,
    remat: bool = False,
    params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (visual prediction [B, out, F, H, W], audio prediction
    [B, out, T]) in the compute dtype. `remat` and `params` (tensors in place
    of the layers' own parameters, e.g. LoRA-merged weights) go to
    `forward_dual_tower`."""
    if audio_timestep is None:
        audio_timestep = timestep
    v_t, v_t_mod = video.time_embeds(timestep)
    a_t, a_t_mod = audio.time_embeds(audio_timestep)
    v_t, v_t_mod = v_t.to(compute_dtype), v_t_mod.to(compute_dtype)
    a_t, a_t_mod = a_t.to(compute_dtype), a_t_mod.to(compute_dtype)

    ctx = context.to(compute_dtype)
    visual_ctx = video.embed_text(ctx)
    audio_ctx = audio.embed_text(ctx)

    visual_x, grid = video.patchify(visual_latents.to(compute_dtype))
    audio_x, f = audio.patchify(audio_latents.to(compute_dtype))

    if rope_pack is None:
        rope_pack = make_rope_pack(video.cfg, audio.cfg, bridge.cfg, grid, f,
                                   video_fps, visual_x.device)
    visual_x, audio_x = forward_dual_tower(
        video.blocks, audio.blocks, bridge, visual_x, audio_x, visual_ctx, audio_ctx,
        v_t_mod, a_t_mod, rope_pack["v"], rope_pack["a"],
        cross_rope=rope_pack.get("cross"), condition_scale=condition_scale,
        a2v_condition_scale=a2v_condition_scale,
        v2a_condition_scale=v2a_condition_scale, attn_impl=attn_impl,
        ctx_valid_len=ctx_valid_len, remat=remat, params=params)

    visual_out = video.unpatchify(video.head(visual_x, v_t), grid)
    audio_out = audio.unpatchify(audio.head(audio_x, a_t))
    return visual_out, audio_out
