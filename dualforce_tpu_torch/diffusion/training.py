"""The LoRA training step of the dual-tower model (counterpart of
`dualforce_tpu/diffusion/training.py`).

Frozen encodes (UMT5, streaming Wan VAE of the clip and of its first frame,
DAC) -> a timestep id in the expert's range (expert 0: high noise, ids
[0, boundary_id); expert 1: the rest) -> flow-match noising -> the LoRA-
merged dual-tower step -> v-target MSE, video plus audio. Randomness comes
from an explicit `torch.Generator` (drawn on the host, so the numbers do not
depend on the device); `jax.random` is not reproduced, so tests pin the
timestep id (`timestep_id`) and the noise (`noise_override`). The base
weights may be stored in fp8 (their LoRA merge runs in the compute dtype,
ROADMAP C caveat 9).

Under a (data, fsdp, cp) mesh (`sp_mesh`, JAX's argument of the same name)
every rank draws the same timestep id and noise for the whole batch from
the trainer's one generator, and the blocks run over the mesh
(`parallel.sp.sp_forward_blocks` slices each rank's part); each rank
differentiates its `sharding.objective_share` of the loss, and
`lora_grads` and `full_ft_grads` return the gradients summed over the
ranks (`sharding.reduce_gradients`): the one-process gradients, on every
rank (an fsdp shard's own slice of them).

Full fine-tuning (`full_finetune_params`: whole modules whose own
parameters train, in place of the frozen ones) has `full_ft_grads`, the
counterpart of `make_full_ft_accum_fns`' grad function, and
`full_ft_step`, of `make_full_ft_step`: when both video experts train, the
step leaves the one it does not exercise as it is, moments included, while
the optimizer's count advances.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dualforce_tpu_torch import resolve_device
from dualforce_tpu_torch.config import MOVAConfig
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.diffusion.step import dual_tower_step
from dualforce_tpu_torch.engine import lora as lora_mod
from dualforce_tpu_torch.models import dac_vae, umt5, wan_vae
from dualforce_tpu_torch.parallel import sharding


@dataclass(frozen=True)
class TrainTables:
    """Scheduler tables the timestep ids index."""

    timesteps_visual: np.ndarray   # [1000]
    timesteps_audio: np.ndarray
    sigmas_visual: np.ndarray
    sigmas_audio: np.ndarray
    boundary_id: int               # count of train ids with t >= boundary


def build_train_tables(scheduler: FlowMatchPairScheduler,
                       boundary_ratio: float) -> TrainTables:
    pairs = scheduler.get_pairs("timesteps")
    sig = scheduler.get_pairs("sigmas")
    boundary = boundary_ratio * scheduler.num_train_timesteps
    return TrainTables(
        timesteps_visual=pairs[:, 0].astype(np.float32),
        timesteps_audio=pairs[:, 1].astype(np.float32),
        sigmas_visual=sig[:, 0].astype(np.float32),
        sigmas_audio=sig[:, 1].astype(np.float32),
        boundary_id=int((pairs[:, 0] >= boundary).sum()),
    )


@dataclass(frozen=True)
class TimestepConfig:
    """SD3-style timestep densities: "uniform" (the reference trainer's
    setting), "logit_normal" or "mode"."""

    weighting_scheme: str = "uniform"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.0


def sample_timestep_id(generator: torch.Generator, tables: TrainTables, expert: int,
                       tscfg: Optional[TimestepConfig] = None) -> int:
    """A timestep id in the expert's range: u in [lo/n, hi/n) under the
    configured density, id = floor(u * n) clamped to [lo, hi). logit_normal
    is the truncated normal on [logit(lo/n), logit(hi/n)] by its inverse
    CDF; "mode" needs the full range. One uniform draw from `generator`."""
    tscfg = tscfg or TimestepConfig()
    n = len(tables.timesteps_visual)
    if expert == 0:
        lo, hi = 0, max(tables.boundary_id, 1)
    else:
        lo, hi = min(tables.boundary_id, n - 1), n
    min_b, max_b = lo / n, hi / n
    r = float(torch.rand((), generator=generator, dtype=torch.float64))
    if tscfg.weighting_scheme == "logit_normal":
        eps = 1e-7

        def logit(x):
            x = min(max(x, eps), 1 - eps)
            return math.log(x / (1 - x))

        def cdf(x):
            return 0.5 * math.erfc(-(x - tscfg.logit_mean) / (tscfg.logit_std * math.sqrt(2)))

        ca, cb = cdf(logit(min_b)), cdf(logit(max_b))
        p = min(max(ca + r * (cb - ca), eps), 1 - eps)
        x = tscfg.logit_mean + tscfg.logit_std * float(
            torch.special.ndtri(torch.tensor(p, dtype=torch.float64)))
        u = 1 / (1 + math.exp(-x))
    elif tscfg.weighting_scheme == "mode":
        if lo != 0 or hi != n:
            raise ValueError("the mode weighting scheme only supports the full [0, 1] "
                             "range; it cannot be combined with expert boundaries")
        u = 1 - r - tscfg.mode_scale * (math.cos(math.pi * r / 2) ** 2 - 1 + r)
    elif tscfg.weighting_scheme == "uniform":
        u = min_b + r * (max_b - min_b)
    else:
        raise ValueError(f"unknown weighting scheme {tscfg.weighting_scheme!r}")
    return min(max(int(math.floor(u * n)), lo), hi - 1)


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


@torch.no_grad()
def encode_batch(modules: Dict[str, torch.nn.Module], cfg: MOVAConfig,
                 batch: Dict[str, Any], compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Frozen encodes of one batch: {video [B, T, H, W, 3] in [-1, 1],
    audio [B, 1, S], text_ids [B, L], text_mask [B, L]} (numpy or tensors) ->
    {context [B, L, d] (compute dtype, zero past the mask), video_latents
    [B, 16, F, h, w], condition [B, 20, F, h, w] (4-channel first-frame mask
    plus the first frame's latents), audio_latents [B, D, T]}, fp32. The VAEs
    run in fp32 (the Wan VAE streaming, the DAC whole)."""
    device = resolve_device(device)
    video = _tensor(batch["video"], device).float()
    mask = _tensor(batch["text_mask"], device)
    context = umt5.encode(modules["text_encoder"], _tensor(batch["text_ids"], device), mask,
                          compute_dtype=compute_dtype)
    context = context * mask[:, :, None].to(context.dtype)

    vae, vcfg = modules["video_vae"], cfg.video_vae
    latents = wan_vae.encode_mode_streaming(vae, video)
    latents = wan_vae.normalize_latents(latents, vcfg).permute(0, 4, 1, 2, 3)
    # the first frame and zeros after it; the clip is let go before that
    # encode (2.1 GB each in fp32 at 1280x720, 193 frames)
    first = torch.zeros_like(video)
    first[:, :1] = video[:, :1]
    del video
    y = wan_vae.encode_mode_streaming(vae, first)
    del first
    y = wan_vae.normalize_latents(y, vcfg).permute(0, 4, 1, 2, 3)
    # the training mask: frame 0 set on all 4 channels (not the inference mask)
    msk = torch.zeros((y.shape[0], 4) + tuple(y.shape[2:]), dtype=y.dtype, device=device)
    msk[:, :, 0] = 1.0
    audio = dac_vae.encode_mode(modules["audio_vae"], _tensor(batch["audio"], device))
    return {"context": context, "video_latents": latents.float(),
            "condition": torch.cat([msk, y], dim=1), "audio_latents": audio.float()}


def training_loss(lora: Optional[lora_mod.Lora], modules: Dict[str, torch.nn.Module],
                  cfg: MOVAConfig, tables: TrainTables, encoded: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator], expert: int,
                  lora_alpha: float = 16.0, video_fps: float = 24.0,
                  compute_dtype: torch.dtype = torch.bfloat16, remat: bool = True,
                  attn_impl="auto", full_finetune_params=None, rope_pack=None,
                  timestep_config: Optional[TimestepConfig] = None,
                  noise_override: Optional[Tuple[Any, Any]] = None,
                  timestep_id: Optional[int] = None, device="cuda", sp_mesh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss of one step on `device`, differentiable in the LoRA factors.

    `encoded` (tensors or numpy) is `encode_batch`'s output. The timestep id
    is drawn from `generator` unless `timestep_id` pins it; the video and
    then the audio noise are drawn from it (on the host) unless
    `noise_override` = (video noise, audio noise) gives them. The LoRA is
    merged into each target where its layer reads it
    (`engine.lora.MergedWeights`). `modules` may hold fp8-stored weights
    (`nn.cast_modules_fp8`), whose merged targets are in `compute_dtype`,
    and may be staged copies of host-resident modules.
    `full_finetune_params`, {name: module}, takes the place of those
    modules (no LoRA): the loss is then differentiable in their parameters.
    `sp_mesh`: the (data, fsdp, cp) mesh the blocks run over (the module
    docstring); the loss is the whole batch's on every rank."""
    if full_finetune_params is not None:
        if lora:
            raise ValueError("training_loss takes a LoRA or full_finetune_params, not both")
        modules = {**modules, **full_finetune_params}
    device = resolve_device(device)
    encoded = {k: _tensor(v, device) for k, v in encoded.items()}
    x_v, x_a = encoded["video_latents"], encoded["audio_latents"]
    tid = (timestep_id if timestep_id is not None
           else sample_timestep_id(generator, tables, expert, timestep_config))
    t_vis, t_aud = float(tables.timesteps_visual[tid]), float(tables.timesteps_audio[tid])
    sig_v, sig_a = float(tables.sigmas_visual[tid]), float(tables.sigmas_audio[tid])
    if noise_override is not None:
        noise_v, noise_a = (_tensor(n, device).float() for n in noise_override)
    else:
        noise_v = torch.randn(x_v.shape, generator=generator).to(device)
        noise_a = torch.randn(x_a.shape, generator=generator).to(device)
    noisy_v = (1 - sig_v) * x_v + sig_v * noise_v
    noisy_a = (1 - sig_a) * x_a + sig_a * noise_a

    tower = "video_dit" if expert == 0 or "video_dit_2" not in modules else "video_dit_2"
    params = None
    if lora:
        # merged where each layer reads its weights (inside its remat block)
        params = {key: lora_mod.MergedWeights(modules[m], lora[m], lora_alpha,
                                              upcast=compute_dtype)
                  for key, m in (("video", tower), ("audio", "audio_dit"), ("bridge", "bridge"))
                  if lora.get(m)}
    b = x_v.shape[0]
    model_in = torch.cat([noisy_v.to(compute_dtype),
                          encoded["condition"].to(compute_dtype)], dim=1)
    v_pred, a_pred = dual_tower_step(
        modules[tower], modules["audio_dit"], modules["bridge"], model_in,
        noisy_a.to(compute_dtype), encoded["context"],
        torch.full((b,), t_vis, device=device), torch.full((b,), t_aud, device=device),
        video_fps=video_fps, compute_dtype=compute_dtype, attn_impl=attn_impl,
        rope_pack=rope_pack, remat=remat, params=params, sp_mesh=sp_mesh)
    video_loss = (v_pred.float() - (noise_v - x_v)).square().mean()
    audio_loss = (a_pred.float() - (noise_a - x_a)).square().mean()
    return video_loss + audio_loss, {"video_loss": video_loss, "audio_loss": audio_loss,
                                     "timestep": torch.tensor(t_vis)}


def lora_grads(lora: lora_mod.Lora, *args, **kwargs
               ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradients of `training_loss` for every factor in `lora_parameters`
    order, metrics with "loss"). A factor the loss does not reach (the
    inactive expert's) gets exact zeros, as `jax.grad` gives it. Under
    `sp_mesh` the gradients are summed over the ranks (the module
    docstring)."""
    params = lora_mod.lora_parameters(lora)
    loss, metrics = training_loss(lora, *args, **kwargs)
    grads, extra = _grads(loss, params, [None] * len(params), kwargs.get("sp_mesh"))
    return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                   **extra}


def _grads(loss: torch.Tensor, params: List[torch.Tensor], shards, mesh):
    """(d loss / d params, zeros where the loss does not reach a parameter;
    metrics). Under a mesh each rank differentiates its share, the
    gradients are then summed over the ranks, and the metrics hold the
    bytes this rank sent and the seconds it spent in collectives in the
    backward and the reduction (`collective_bwd_bytes`, `collective_bwd_s`)."""
    if mesh is None:
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)], {}
    from dualforce_tpu_torch.parallel.mesh import TRANSFER

    b0, s0 = TRANSFER["bytes"], TRANSFER["seconds"]
    grads = torch.autograd.grad(loss * sharding.objective_share(mesh), params,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    grads = sharding.reduce_gradients(grads, shards, mesh)
    return grads, {"collective_bwd_bytes": torch.tensor(float(TRANSFER["bytes"] - b0)),
                   "collective_bwd_s": torch.tensor(TRANSFER["seconds"] - s0)}


def accumulate(acc: Optional[Sequence[torch.Tensor]], grads: Sequence[torch.Tensor],
               accum_steps: int) -> List[torch.Tensor]:
    """Fold one micro-batch's grads into a running mean over `accum_steps`:
    acc + g / accum_steps (acc None: start from zeros)."""
    scale = 1.0 / accum_steps
    if acc is None:
        return [g * scale for g in grads]
    return [a.add_(g, alpha=scale) for a, g in zip(acc, grads)]


def trainable_parameters(trainable: Dict[str, torch.nn.Module]) -> List[torch.Tensor]:
    """The parameters of full fine-tuning's modules, in the order the
    optimizer and the gradients take them: by module name, then each
    module's own order."""
    return [p for m in sorted(trainable) for p in trainable[m].parameters()]


def held_expert(trainable: Dict[str, torch.nn.Module], expert: int) -> List[bool]:
    """Per parameter of `trainable_parameters`: True for the video expert a
    step on `expert` does not run, where both experts train."""
    held = ("video_dit_2" if expert == 0 else "video_dit") \
        if {"video_dit", "video_dit_2"} <= set(trainable) else None
    return [m == held for m in sorted(trainable) for _ in trainable[m].parameters()]


def full_ft_grads(trainable: Dict[str, torch.nn.Module], *args, **kwargs
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradients of `training_loss(None, *args, full_finetune_params=
    trainable, **kwargs)` for every parameter of `trainable_parameters`,
    metrics with "loss"). A parameter the loss does not reach (the inactive
    expert's) gets exact zeros, as `jax.grad` gives it. Under `sp_mesh` the
    gradients are summed over the ranks, an fsdp shard's its own slice."""
    params = trainable_parameters(trainable)
    loss, metrics = training_loss(None, *args, full_finetune_params=trainable, **kwargs)
    grads, extra = _grads(loss, params, sharding.shards_of(trainable, params),
                          kwargs.get("sp_mesh"))
    return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                   **extra}


def full_ft_step(trainable: Dict[str, torch.nn.Module], optimizer,
                 modules: Dict[str, torch.nn.Module], cfg: MOVAConfig, tables: TrainTables,
                 encoded: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                 expert: int, **kwargs) -> Dict[str, torch.Tensor]:
    """One full fine-tuning step on one batch (`make_full_ft_step`):
    `full_ft_grads`, then the optimizer, the modules updated in place.
    Where both video experts train, the one the step does not run is held
    (`held_expert`: its parameters and optimizer state stay, the count
    advances), so weight decay does not move it. Returns the metrics with
    "grad_norm"."""
    grads, metrics = full_ft_grads(trainable, modules, cfg, tables, encoded, generator,
                                   expert, **kwargs)
    norm = optimizer.step(grads, frozen=held_expert(trainable, expert))
    return {**metrics, "grad_norm": norm}


def lora_step(lora: lora_mod.Lora, optimizer, *args, **kwargs) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch: `lora_grads`, then the optimizer
    (clip, AdamW) in place. Returns the metrics with "grad_norm"."""
    grads, metrics = lora_grads(lora, *args, **kwargs)
    return {**metrics, "grad_norm": optimizer.step(grads)}
