"""Flow-matching denoise loop (counterpart of `dualforce_tpu/diffusion/sampler.py`).

Paired (visual, audio) timesteps, a static switch from the high-noise to the
low-noise video expert at `boundary_step`, text CFG as a second pass or
batched with the first, a cached negative pass, dual CFG, per-item context
lengths, and per-modality Euler updates on independent sigma columns. The
JAX package compiles the loop into one XLA program per expert phase; here
it is a Python loop. `denoise_range` runs one expert's phase.
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


def denoise_range(
    video,                        # the one expert active in [start, stop)
    audio,
    bridge,
    latents: torch.Tensor,
    condition: torch.Tensor,
    audio_latents: torch.Tensor,
    ctx_pos: torch.Tensor,
    ctx_neg: Optional[torch.Tensor],
    plan: SamplePlan,
    start: int,
    stop: int,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps [start, stop) of the loop with a single video expert (the
    component offload's phases); keyword arguments as for `denoise_loop`.
    A cached CFG negative is refreshed at `start`."""
    return _denoise([(video, start, stop)], audio, bridge, latents, condition,
                    audio_latents, ctx_pos, ctx_neg, plan, **kwargs)


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
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs every step of `plan`, the high-noise expert before
    `plan.boundary_step` and the low-noise one from there; returns the fp32
    (latents, audio_latents). Keyword arguments:

    cfg_scale (5.0): text CFG against `ctx_neg`; off at 1.0 or without it.
    cfg_batch (False): the positive and negative passes as one batch of 2B.
    cfg_cache_interval (1): above 1, the negative pass runs only at steps
    i with i % interval == 0 and at each expert's first step, and its
    prediction is reused in between (never across the expert switch);
    refused with cfg_batch.
    cfg_scale_bridge (0.0): dual CFG, a third pass with the bridge off
    (condition_scale 0) adding s_B * (pos - pos_bridge_off).
    ctx_len_pos, ctx_len_neg: optional [B] valid context lengths; the text
    cross-attentions mask the keys past them.
    video_fps, compute_dtype, rope_pack, attn_impl (to every attention),
    progress_fn(step, total) (on the host after each step)."""
    n = plan.num_steps
    split = plan.boundary_step if video_low is not None else n
    return _denoise([(video_high, 0, split), (video_low, split, n)], audio, bridge,
                    latents, condition, audio_latents, ctx_pos, ctx_neg, plan, **kwargs)


def _denoise(phases, audio, bridge, latents, condition, audio_latents, ctx_pos, ctx_neg,
             plan: SamplePlan, cfg_scale: float = 5.0, video_fps: float = 24.0,
             cfg_batch: bool = False, compute_dtype: torch.dtype = torch.bfloat16,
             rope_pack=None, cfg_cache_interval: int = 1, cfg_scale_bridge: float = 0.0,
             progress_fn=None, ctx_len_pos: Optional[torch.Tensor] = None,
             ctx_len_neg: Optional[torch.Tensor] = None, attn_impl="auto"):
    """The loop over `phases`, [(video expert, start, stop)], in order."""
    use_cfg = cfg_scale != 1.0 and ctx_neg is not None
    use_dual = cfg_scale_bridge != 0.0
    cache_neg = use_cfg and cfg_cache_interval > 1
    if cache_neg and cfg_batch:
        raise ValueError("cfg_cache_interval > 1 requires cfg_batch=False "
                         "(the cache replaces the second pass entirely)")
    b = latents.shape[0]
    if ctx_len_pos is not None:
        ctx_len_pos = ctx_len_pos.to(torch.int32).reshape(b)
    if ctx_len_neg is not None:
        ctx_len_neg = ctx_len_neg.to(torch.int32).reshape(b)
    if use_cfg and cfg_batch:
        ctx_both = torch.cat([ctx_pos, ctx_neg])
        len_both = (torch.cat([ctx_len_pos, ctx_len_neg])
                    if ctx_len_pos is not None and ctx_len_neg is not None else None)

    def run(video, ctx, model_in, alat, t, at, ctx_len, bridge_scale=None):
        v, a = dual_tower_step(video, audio, bridge, model_in, alat, ctx, t, at,
                               video_fps=video_fps, condition_scale=bridge_scale,
                               compute_dtype=compute_dtype, attn_impl=attn_impl,
                               ctx_valid_len=ctx_len, rope_pack=rope_pack)
        return v.float(), a.float()

    lat, alat = latents, audio_latents
    for video, start, stop in phases:
        neg = None
        for i in range(start, stop):
            t = torch.full((b,), float(plan.pair_timesteps[i, 0]), dtype=torch.float32,
                           device=lat.device)
            at = torch.full((b,), float(plan.pair_timesteps[i, 1]), dtype=torch.float32,
                            device=lat.device)
            model_in = torch.cat([lat, condition], dim=1)
            if use_cfg and cfg_batch:
                v, a = run(video, ctx_both, torch.cat([model_in, model_in]),
                           torch.cat([alat, alat]), t.repeat(2), at.repeat(2), len_both)
                v_pos, v_neg, a_pos, a_neg = v[:b], v[b:], a[:b], a[b:]
            else:
                v_pos, a_pos = run(video, ctx_pos, model_in, alat, t, at, ctx_len_pos)
                if use_cfg:
                    if neg is None or not cache_neg or i % cfg_cache_interval == 0:
                        neg = run(video, ctx_neg, model_in, alat, t, at, ctx_len_neg)
                    v_neg, a_neg = neg
            if use_cfg:
                v_pred = v_neg + cfg_scale * (v_pos - v_neg)
                a_pred = a_neg + cfg_scale * (a_pos - a_neg)
            else:
                v_pred, a_pred = v_pos, a_pos
            if use_dual:
                v_nb, a_nb = run(video, ctx_pos, model_in, alat, t, at, ctx_len_pos,
                                 bridge_scale=0.0)
                v_pred = v_pred + cfg_scale_bridge * (v_pos - v_nb)
                a_pred = a_pred + cfg_scale_bridge * (a_pos - a_nb)
            lat = lat + v_pred * float(plan.sigmas_visual[i + 1] - plan.sigmas_visual[i])
            alat = alat + a_pred * float(plan.sigmas_audio[i + 1] - plan.sigmas_audio[i])
            if progress_fn is not None:
                progress_fn(i + 1, plan.num_steps)
    return lat, alat
