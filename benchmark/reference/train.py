"""Plain fp32 reference of MOVA's LoRA training step, from its recipe and
independent of the code under test (nothing of the port is imported): the
frozen encodes (`reference.encoders`), a timestep id drawn in the active
expert's range of the 1000-step training table, flow-matching noise, the
LoRA-merged dual-tower pass (`reference.mova`), the v-target MSE of video
plus audio, its gradients in the LoRA factors (autograd), clipping by the
global norm and AdamW (decoupled weight decay) under a linear-warmup cosine
schedule.

The draws follow the recipe's order on one host generator, as the benchmark
seeds it: per step one uniform float64 for the timestep, then the video and
the audio noise, standard normal float32 on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import encoders, mova, rope, schedule


def train_tables(cfg: dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """(timesteps [T], sigmas [T], boundary id) of the training table: the
    scheduler's shifted ramp over its T train steps, and the count of ids
    whose timestep is at or above boundary_ratio * T (the high-noise
    expert's range)."""
    sc = cfg["scheduler"]
    n = sc["num_train_timesteps"]
    sigmas = schedule.shifted(sc, n, sc["shift"])
    timesteps = sigmas * n
    return timesteps, sigmas, int((timesteps >= cfg["boundary_ratio"] * n).sum())


def timestep_id(r: float, n: int, boundary: int, expert: int) -> int:
    """A uniform id in the expert's range: expert 0 [0, boundary), expert 1
    [boundary, n); u = lo/n + r (hi - lo)/n, id = floor(u n) clamped."""
    lo, hi = (0, max(boundary, 1)) if expert == 0 else (min(boundary, n - 1), n)
    u = lo / n + r * (hi / n - lo / n)
    return min(max(int(math.floor(u * n)), lo), hi - 1)


def encode(cfg: dict, p: Dict[str, mova.Params], batch: dict) -> Dict[str, torch.Tensor]:
    """The frozen encodes of one clip: the text context [L, text_dim], the
    clip's latents [16, F, h, w], the condition [20, F, h, w] (a 4-channel
    mask set on the first latent frame, then the latents of the clip's first
    frame followed by zero frames) and the audio latents [D, T]."""
    with torch.no_grad():
        ctx = encoders.umt5(p["text_encoder"], cfg["text_encoder"], batch["text_ids"][0],
                            batch["text_mask"][0])
        video = batch["video"][0].float()
        x_v = encoders.wan_encode(p["video_vae"], cfg["video_vae"], video)
        first = torch.zeros_like(video)
        first[:1] = video[:1]
        y = encoders.wan_encode(p["video_vae"], cfg["video_vae"], first)
        mask = torch.zeros((4,) + tuple(y.shape[1:]), device=y.device)
        mask[:, 0] = 1.0
        x_a = encoders.dac_encode(p["audio_vae"], cfg["audio_vae"], batch["audio"][0, 0].float())
    return {"context": ctx, "video": x_v, "condition": torch.cat([mask, y]), "audio": x_a}


def loss(cfg: dict, video: mova.Params, audio: mova.Params, bridge: mova.Params,
         enc: Dict[str, torch.Tensor], t: float, sigma: float, noise_v: torch.Tensor,
         noise_a: torch.Tensor) -> torch.Tensor:
    """The flow-matching loss at one timestep: the latents noised to sigma,
    the pass's predictions against the velocity noise - x, the video and the
    audio mean squares summed."""
    x_v, x_a = enc["video"], enc["audio"]
    noisy_v = (1 - sigma) * x_v + sigma * noise_v
    noisy_a = (1 - sigma) * x_a + sigma * noise_a
    tables = rope.tables(cfg, x_v.shape[1:], x_a.shape[-1], x_v.device)
    v, a = mova.dual_tower_pass(cfg, video, audio, bridge, torch.cat([noisy_v, enc["condition"]]),
                                noisy_a, enc["context"], t, t, tables)
    return (v - (noise_v - x_v)).square().mean() + (a - (noise_a - x_a)).square().mean()


def lr_at(count: int, base: float, warmup: int, total: int) -> float:
    """The learning rate of update `count`: linear from 0 over the warmup,
    then a cosine to 0 over the remaining steps."""
    warmup = max(warmup, 1)
    if count < warmup:
        return base * count / warmup
    decay = max(total, warmup + 1) - warmup
    return base * 0.5 * (1 + math.cos(math.pi * min(count - warmup, decay) / decay))


class AdamW:
    """Clipping by the global norm (g * max / norm where norm >= max), then
    AdamW: p -= lr * wd * p, then p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: List[torch.Tensor], betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float = 1.0):
        self.params, self.betas, self.eps = params, betas, eps
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """Applies one update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        if norm >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        b1, b2 = self.betas
        self.count += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** self.count)).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.count))
        return grads
