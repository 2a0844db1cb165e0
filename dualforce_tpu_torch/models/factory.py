"""Random-weight pipeline modules (counterpart of `dualforce_tpu/models/factory.py`).

Modules are built on the meta device, materialised on the target device and
drawn there from a seeded `torch.Generator`, so a full-width model never
passes through host memory. Linear and conv weights and biases are uniform
in +-1/sqrt(fan_in) (PyTorch's default bound), embeddings standard normal,
AdaLN modulation tables normal / sqrt(dim), and norm, snake and scale
parameters ones (biases zeros). The DiTs, bridge and text encoder take
`dtype`; the VAEs stay fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch import resolve_device
from dualforce_tpu_torch.config import MOVAConfig
from dualforce_tpu_torch.models.audio_dit import AudioDiT
from dualforce_tpu_torch.models.bridge import DualTowerBridge
from dualforce_tpu_torch.models.dac_vae import DACVAE
from dualforce_tpu_torch.models.umt5 import UMT5Encoder
from dualforce_tpu_torch.models.video_dit import VideoDiT
from dualforce_tpu_torch.models.wan_vae import WanVAE

_CONVS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d)


@torch.no_grad()
def _init_weights(module: nn.Module, gen: torch.Generator) -> None:
    for p in module.parameters():
        p.fill_(1.0)
    for m in module.modules():
        if isinstance(m, _CONVS):
            w = m.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            if isinstance(m, nn.ConvTranspose1d):
                fan_in = w.shape[0] * w.shape[2]
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=gen)
        elif isinstance(m, dnn.LayerNorm):
            m.bias.zero_()
    for name, p in module.named_parameters():
        if name.endswith("modulation"):
            p.normal_(generator=gen).div_(math.sqrt(p.shape[-1]))


def _build(cls, cfg, device, dtype, gen) -> nn.Module:
    with torch.device("meta"):
        module = cls(cfg, dtype=dtype)
    module = module.to_empty(device=device)
    _init_weights(module, gen)
    return module.eval().requires_grad_(False)


def init_pipeline_params(cfg: MOVAConfig, device="cuda",
                         dtype: torch.dtype = torch.bfloat16, seed: int = 0, *,
                         with_vaes: bool = True, with_text: bool = True,
                         two_video_towers: Optional[bool] = None
                         ) -> Dict[str, nn.Module]:
    """{"video_dit", "video_dit_2" (two experts), "audio_dit", "bridge",
    "video_vae", "audio_vae", "text_encoder"} with random weights."""
    device = resolve_device(device)
    if two_video_towers is None:
        two_video_towers = cfg.two_video_towers
    gen = torch.Generator(device).manual_seed(seed)
    mods = {"video_dit": _build(VideoDiT, cfg.video_dit, device, dtype, gen)}
    if two_video_towers:
        mods["video_dit_2"] = _build(VideoDiT, cfg.video_dit, device, dtype, gen)
    mods["audio_dit"] = _build(AudioDiT, cfg.audio_dit, device, dtype, gen)
    mods["bridge"] = _build(DualTowerBridge, cfg.bridge, device, dtype, gen)
    if with_vaes:
        mods["video_vae"] = _build(WanVAE, cfg.video_vae, device, torch.float32, gen)
        mods["audio_vae"] = _build(DACVAE, cfg.audio_vae, device, torch.float32, gen)
    if with_text:
        mods["text_encoder"] = _build(UMT5Encoder, cfg.text_encoder, device, dtype, gen)
    return mods
