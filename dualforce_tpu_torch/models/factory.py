"""Random-weight pipeline modules (counterpart of `dualforce_tpu/models/factory.py`).

Modules are built on the meta device, materialised on the target device and
drawn there from a seeded `torch.Generator`, so a full-width model never
passes through host memory. Linear and conv weights and biases are uniform
in +-1/sqrt(fan_in) (PyTorch's default bound), embeddings standard normal,
AdaLN modulation tables normal / sqrt(dim), and norm, snake and scale
parameters ones (biases zeros). The DiTs, bridge and text encoder take
`dtype`; the VAEs stay fp32, as in the JAX package. An fp8 `dtype` is
storage only, as the JAX loader's: those modules are drawn in bf16 and cast
by `nn.cast_modules_fp8`.

With `host=True` each module is drawn on the device and moved into host
memory (page-locked when the device is a CUDA card) before the next one is
drawn: the card never holds more than one module, and the values are those
of a resident init from the same seed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch import offload, resolve_device
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


def _build(cls, cfg, device, dtype, gen, host: bool = False) -> nn.Module:
    fp8 = dtype in dnn.FP8_DTYPES
    with torch.device("meta"):
        module = cls(cfg, dtype=torch.bfloat16 if fp8 else dtype)
    module = module.to_empty(device=device)
    _init_weights(module, gen)
    if fp8:
        dnn.cast_modules_fp8(module, dtype)
    module = module.eval().requires_grad_(False)
    if host and device.type != "cpu":
        offload.to_host(module, device)
    return module


def init_pipeline_params(cfg: MOVAConfig, device="cuda",
                         dtype: torch.dtype = torch.bfloat16, seed: int = 0, *,
                         with_vaes: bool = True, with_text: bool = True,
                         two_video_towers: Optional[bool] = None, host: bool = False
                         ) -> Dict[str, nn.Module]:
    """{"video_dit", "video_dit_2" (two experts), "audio_dit", "bridge",
    "video_vae", "audio_vae", "text_encoder"} with random weights, drawn on
    `device`; with `host`, handed back in host memory, one module at a
    time."""
    device = resolve_device(device)
    if two_video_towers is None:
        two_video_towers = cfg.two_video_towers
    gen = torch.Generator(device).manual_seed(seed)

    def build(cls, sub_cfg, sub_dtype):
        return _build(cls, sub_cfg, device, sub_dtype, gen, host)

    mods = {"video_dit": build(VideoDiT, cfg.video_dit, dtype)}
    if two_video_towers:
        mods["video_dit_2"] = build(VideoDiT, cfg.video_dit, dtype)
    mods["audio_dit"] = build(AudioDiT, cfg.audio_dit, dtype)
    mods["bridge"] = build(DualTowerBridge, cfg.bridge, dtype)
    if with_vaes:
        mods["video_vae"] = build(WanVAE, cfg.video_vae, torch.float32)
        mods["audio_vae"] = build(DACVAE, cfg.audio_vae, torch.float32)
    if with_text:
        mods["text_encoder"] = build(UMT5Encoder, cfg.text_encoder, dtype)
    return mods
