"""Flow-matching denoise loop (counterpart of `dualforce_tpu/diffusion/sampler.py`).

Paired (visual, audio) timesteps, a static switch from the high-noise to the
low-noise video expert at `boundary_step`, text CFG as a second pass, and
per-modality Euler updates on independent sigma columns. The JAX package
compiles the loop into one XLA program; here it is a Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.diffusion.step import dual_tower_step


@dataclass(frozen=True)
class SamplePlan:
    """Static per-generation tables (host-side numpy)."""

    pair_timesteps: np.ndarray   # [N, 2] (visual, audio) timesteps
    sigmas_visual: np.ndarray    # [N+1] incl. terminal sigma
    sigmas_audio: np.ndarray     # [N+1]
    boundary_step: int           # first step index where visual t < boundary

    @property
    def num_steps(self) -> int:
        return self.pair_timesteps.shape[0]


def build_plan(scheduler: FlowMatchPairScheduler, boundary_ratio: float) -> SamplePlan:
    """Derive the static sampling plan from a configured scheduler."""
    pairs = scheduler.get_pairs("timesteps")
    sig_v, sig_a = scheduler.pair_sigma_columns()
    boundary = boundary_ratio * scheduler.num_train_timesteps
    below = np.nonzero(pairs[:, 0] < boundary)[0]
    boundary_step = int(below[0]) if len(below) else pairs.shape[0]
    return SamplePlan(pair_timesteps=pairs.astype(np.float32),
                      sigmas_visual=sig_v, sigmas_audio=sig_a,
                      boundary_step=boundary_step)


def denoise_loop(
    video_high,
    video_low,                   # None for a single-expert model
    audio,
    bridge,
    latents: torch.Tensor,        # [B, 16, F, H, W] fp32
    condition: torch.Tensor,      # [B, 20, F, H, W] (4 mask + 16 cond latents)
    audio_latents: torch.Tensor,  # [B, 128, T] fp32
    ctx_pos: torch.Tensor,        # [B, 512, text_dim]
    ctx_neg: Optional[torch.Tensor],
    plan: SamplePlan,
    cfg_scale: float = 5.0,
    video_fps: float = 24.0,
    cfg_batch: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    rope_pack=None,
    cfg_cache_interval: int = 1,
    cfg_scale_bridge: float = 0.0,
    progress_fn=None,
    ctx_len_pos: Optional[torch.Tensor] = None,
    ctx_len_neg: Optional[torch.Tensor] = None,
    attn_impl="auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs every step of `plan`; returns the fp32 (latents, audio_latents).
    progress_fn(step, total) is called on the host after each step;
    attn_impl goes to every attention (`ops.attention.attention`)."""
    if cfg_batch or cfg_cache_interval != 1 or cfg_scale_bridge != 0.0:
        raise NotImplementedError("cfg_batch, cfg_cache_interval and dual CFG "
                                  "(cfg_scale_bridge) are not ported yet")
    if ctx_len_pos is not None or ctx_len_neg is not None:
        raise NotImplementedError("per-item context lengths (mask_ctx_pad) are "
                                  "not ported yet")
    use_cfg = cfg_scale != 1.0 and ctx_neg is not None
    b = latents.shape[0]
    n = plan.num_steps
    split = plan.boundary_step if video_low is not None else n

    def run(video, ctx, model_in, alat, t, at):
        v, a = dual_tower_step(video, audio, bridge, model_in, alat, ctx,
                               t, at, video_fps=video_fps, compute_dtype=compute_dtype,
                               attn_impl=attn_impl, rope_pack=rope_pack)
        return v.float(), a.float()

    lat, alat = latents, audio_latents
    for i in range(n):
        video = video_high if i < split else video_low
        t = torch.full((b,), float(plan.pair_timesteps[i, 0]), dtype=torch.float32,
                       device=lat.device)
        at = torch.full((b,), float(plan.pair_timesteps[i, 1]), dtype=torch.float32,
                        device=lat.device)
        model_in = torch.cat([lat, condition], dim=1)
        v_pred, a_pred = run(video, ctx_pos, model_in, alat, t, at)
        if use_cfg:
            v_neg, a_neg = run(video, ctx_neg, model_in, alat, t, at)
            v_pred = v_neg + cfg_scale * (v_pred - v_neg)
            a_pred = a_neg + cfg_scale * (a_pred - a_neg)
        lat = lat + v_pred * float(plan.sigmas_visual[i + 1] - plan.sigmas_visual[i])
        alat = alat + a_pred * float(plan.sigmas_audio[i + 1] - plan.sigmas_audio[i])
        if progress_fn is not None:
            progress_fn(i + 1, n)
    return lat, alat
