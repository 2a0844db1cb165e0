"""Wan-style audio DiT (counterpart of `dualforce_tpu/models/audio_dit.py`).

The video tower's block, embeddings and head with a 1D patchify (Conv1d as a
reshape and a matrix product); its 1D RoPE tables ("dac" full-dim or
"oobleck") come from `diffusion/step.make_rope_pack`.
"""

from __future__ import annotations

import torch
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.config import AudioDiTConfig
from dualforce_tpu_torch.models.video_dit import DiTTower
from dualforce_tpu_torch.registry import MODELS


@MODELS.register_module(name="AudioDiT")
class AudioDiT(DiTTower):
    """The audio tower (WanAudioModel)."""

    def __init__(self, cfg: AudioDiTConfig, device=None, dtype=None):
        patch = nn.Conv1d(cfg.in_dim, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                          device=device, dtype=dtype)
        super().__init__(cfg, patch, cfg.out_dim * cfg.patch_size, device, dtype)

    def patchify(self, x: torch.Tensor):
        """[B, C, T] -> (tokens [B, T//p, dim], T//p)."""
        return dnn.patch_embed_1d(x, self.patch_embedding.weight,
                                  self.patch_embedding.bias, self.cfg.patch_size)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        return dnn.unpatchify_1d(x, self.cfg.patch_size, self.cfg.out_dim)
