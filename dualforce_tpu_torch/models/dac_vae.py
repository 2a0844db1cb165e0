"""DAC audio VAE, continuous (KL) mode: encode (mean of the moments) and
decode (counterpart of `dualforce_tpu/models/dac_vae.py`).

Runs in fp32 on [B, C, T] tensors, as the JAX package runs it (its VAE
parameters stay fp32 and training's `encode_batch` feeds fp32 audio).
Parameter names are those of the MOVA DAC checkpoint (`decoder.model.{i}`,
`encoder.block.{i}`, `quant_conv`, `post_quant_conv`) with plain conv
weights: weight norm is folded before loading, as the JAX package's
converter does. The RVQ mode and `compress`/`decompress` are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dualforce_tpu_torch.config import DACVAEConfig


class Snake1d(nn.Module):
    """snake(x) = x + (alpha + 1e-9)^-1 * sin(alpha * x)^2, in fp32."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.float()
        xf = x.float()
        return (xf + torch.sin(alpha * xf).square() / (alpha + 1e-9)).to(x.dtype)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.Sequential(Snake1d(dim, **f),
                                   nn.Conv1d(dim, dim, 7, dilation=dilation, padding=pad, **f),
                                   Snake1d(dim, **f),
                                   nn.Conv1d(dim, dim, 1, **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        trim = (x.shape[-1] - y.shape[-1]) // 2
        if trim > 0:
            x = x[..., trim:-trim]
        return x + y


class _EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.block = nn.Sequential(
            ResidualUnit(dim // 2, 1, **f), ResidualUnit(dim // 2, 3, **f),
            ResidualUnit(dim // 2, 9, **f), Snake1d(dim // 2, **f),
            nn.Conv1d(dim // 2, dim, 2 * stride, stride=stride,
                      padding=math.ceil(stride / 2), **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _Encoder(nn.Module):
    def __init__(self, cfg: DACVAEConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        d = cfg.encoder_dim
        layers = [nn.Conv1d(1, d, 7, padding=3, **f)]
        for stride in cfg.encoder_rates:
            d *= 2
            layers.append(_EncoderBlock(d, stride, **f))
        layers += [Snake1d(d, **f), nn.Conv1d(d, cfg.latent_dim, 3, padding=1, **f)]
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.block = nn.Sequential(
            Snake1d(cin, **f),
            nn.ConvTranspose1d(cin, cout, 2 * stride, stride=stride,
                               padding=math.ceil(stride / 2),
                               output_padding=stride % 2, **f),
            ResidualUnit(cout, 1, **f), ResidualUnit(cout, 3, **f),
            ResidualUnit(cout, 9, **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _Decoder(nn.Module):
    def __init__(self, cfg: DACVAEConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        ch = cfg.decoder_dim
        layers = [nn.Conv1d(cfg.latent_dim, ch, 7, padding=3, **f)]
        for i, stride in enumerate(cfg.decoder_rates):
            layers.append(_DecoderBlock(ch // 2 ** i, ch // 2 ** (i + 1), stride, **f))
        cout = ch // 2 ** len(cfg.decoder_rates)
        layers += [Snake1d(cout, **f), nn.Conv1d(cout, 1, 7, padding=3, **f), nn.Tanh()]
        self.model = nn.Sequential(*layers)


class DACVAE(nn.Module):
    def __init__(self, cfg: DACVAEConfig, device=None, dtype=None):
        super().__init__()
        if not cfg.continuous:
            raise NotImplementedError("the RVQ (discrete) DAC is not ported")
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = _Encoder(cfg, **f)
        self.decoder = _Decoder(cfg, **f)
        self.quant_conv = nn.Conv1d(cfg.latent_dim, 2 * cfg.latent_dim, 1, **f)
        self.post_quant_conv = nn.Conv1d(cfg.latent_dim, cfg.latent_dim, 1, **f)


def decode(vae: DACVAE, z: torch.Tensor) -> torch.Tensor:
    """z: [B, D, T] latents -> audio [B, 1, T * hop] in [-1, 1], in fp32."""
    return vae.decoder.model(vae.post_quant_conv(z.float()))


def preprocess(audio: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Right-pad the last axis with zeros to a multiple of the hop."""
    pad = -audio.shape[-1] % hop_length
    return torch.nn.functional.pad(audio, (0, pad)) if pad else audio


def encode_moments(vae: DACVAE, audio: torch.Tensor):
    """audio [B, 1, S] -> (mean, logvar) each [B, D, ceil(S / hop)], fp32;
    logvar clipped to [-30, 20]."""
    z = vae.encoder(preprocess(audio.float(), vae.cfg.hop_length))
    mean, logvar = vae.quant_conv(z).chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def encode_mode(vae: DACVAE, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, 1, S] -> latent mean [B, D, ceil(S / hop)], fp32."""
    return encode_moments(vae, audio)[0]
