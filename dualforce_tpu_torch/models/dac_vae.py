"""DAC audio VAE (counterpart of `dualforce_tpu/models/dac_vae.py`): the
continuous (KL) mode MOVA ships, with its moments, mode and sampled encodes
and its decode, and the discrete mode (`continuous=False`): a residual
vector quantizer of `n_codebooks` factorised, cosine-matched codebooks
(`encode_quantized`, `decode_codes`, eval semantics); plus `compress` and
`decompress`, which encode and decode long clips in clamped windows whose
overlap covers the convolutions' receptive field, so the interior equals
the one-pass result.

Runs in fp32 on [B, C, T] tensors, as the JAX package runs it (its VAE
parameters stay fp32 and training's `encode_batch` feeds fp32 audio).
Parameter names are those of the MOVA DAC checkpoint (`decoder.model.{i}`,
`encoder.block.{i}`, `quant_conv`, `post_quant_conv`,
`quantizer.quantizers.{i}.in_proj`, `.out_proj`, `.codebook`) with plain
conv weights: weight norm is folded before loading, as the JAX package's
converter does.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from dualforce_tpu_torch.config import DACVAEConfig
from dualforce_tpu_torch.registry import MODELS


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


class VectorQuantize(nn.Module):
    """One codebook stage: 1x1 projections into and out of a low-dimensional
    code space and the codebook itself."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.in_proj = nn.Conv1d(input_dim, codebook_dim, 1, **f)
        self.out_proj = nn.Conv1d(codebook_dim, input_dim, 1, **f)
        self.codebook = nn.Embedding(codebook_size, codebook_dim, **f)


class ResidualVectorQuantize(nn.Module):
    def __init__(self, cfg: DACVAEConfig, device=None, dtype=None):
        super().__init__()
        self.quantizers = nn.ModuleList(
            VectorQuantize(cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim,
                           device=device, dtype=dtype) for _ in range(cfg.n_codebooks))


@MODELS.register_module(name="DACVAE")
class DACVAE(nn.Module):
    def __init__(self, cfg: DACVAEConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = _Encoder(cfg, **f)
        self.decoder = _Decoder(cfg, **f)
        if cfg.continuous:
            self.quant_conv = nn.Conv1d(cfg.latent_dim, 2 * cfg.latent_dim, 1, **f)
            self.post_quant_conv = nn.Conv1d(cfg.latent_dim, cfg.latent_dim, 1, **f)
        else:
            self.quantizer = ResidualVectorQuantize(cfg, **f)


def decode(vae: DACVAE, z: torch.Tensor) -> torch.Tensor:
    """z: [B, D, T] latents (in the discrete mode the quantized continuous
    representation, which no post_quant_conv follows) -> audio
    [B, 1, T * hop] in [-1, 1], in fp32."""
    z = z.float()
    if vae.cfg.continuous:
        z = vae.post_quant_conv(z)
    return vae.decoder.model(z)


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


def encode_sample(vae: DACVAE, audio: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise, the noise given or drawn from
    `generator` (standard normal, the mean's shape)."""
    mean, logvar = encode_moments(vae, audio)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)


# --- the residual vector quantizer (continuous=False), eval semantics -------

def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-12)


def vq_apply(vq: VectorQuantize, z: torch.Tensor):
    """One stage. z [B, D, T] -> (z_q [B, D, T], commit [B], codebook [B],
    codes [B, T], z_e [B, D_cb, T]): the nearest codebook entry under
    l2-normalisation (cosine), the straight-through sum z_e + (z_q - z_e)
    projected back."""
    z_e = vq.in_proj(z)
    enc = _l2n(z_e.float().transpose(1, 2))
    cb = _l2n(vq.codebook.weight.float())
    codes = (enc @ cb.T).argmax(dim=-1)
    z_q = vq.codebook.weight[codes].to(z_e.dtype).transpose(1, 2)
    loss = (z_e - z_q).square().mean(dim=(1, 2))
    z_q = z_e + (z_q - z_e).detach()
    return vq.out_proj(z_q), loss, loss, codes, z_e


def rvq_apply(rvq: ResidualVectorQuantize, z: torch.Tensor,
              n_quantizers: Union[None, int, torch.Tensor] = None):
    """Residual VQ over the stages. z [B, D, T]; n_quantizers: a count, a
    per-item [B] tensor (each item's stages from that count on are masked
    out of z_q and the losses, the training-time quantizer dropout) or None
    (all). Returns (z_q [B, D, T], codes [B, N, T], latents [B, sum D_cb,
    T], commitment loss, codebook loss), N the stages run."""
    nq = len(rvq.quantizers) if n_quantizers is None else n_quantizers
    per_item = torch.is_tensor(nq) and nq.dim() == 1
    z_q = torch.zeros_like(z)
    residual = z
    commit = torch.zeros((), dtype=torch.float32, device=z.device)
    codebook = torch.zeros((), dtype=torch.float32, device=z.device)
    codes, latents = [], []
    for i, vq in enumerate(rvq.quantizers):
        if not per_item and i >= int(nq):
            break
        z_q_i, c_i, cb_i, idx_i, z_e_i = vq_apply(vq, residual)
        if per_item:
            mask = (i < nq.to(z.device)).to(z.dtype)
            z_q = z_q + z_q_i * mask[:, None, None]
            commit = commit + (c_i * mask).mean()
            codebook = codebook + (cb_i * mask).mean()
        else:
            z_q = z_q + z_q_i
            commit = commit + c_i.mean()
            codebook = codebook + cb_i.mean()
        residual = residual - z_q_i
        codes.append(idx_i)
        latents.append(z_e_i)
    return z_q, torch.stack(codes, dim=1), torch.cat(latents, dim=1), commit, codebook


def rvq_from_codes(rvq: ResidualVectorQuantize, codes: torch.Tensor):
    """codes [B, N, T] -> (z_q [B, D, T], z_p [B, sum D_cb, T])."""
    z_q, z_p = None, []
    for i in range(codes.shape[1]):
        vq = rvq.quantizers[i]
        p = vq.codebook.weight[codes[:, i]].transpose(1, 2)
        q = vq.out_proj(p)
        z_q = q if z_q is None else z_q + q
        z_p.append(p)
    return z_q, torch.cat(z_p, dim=1)


def encode_quantized(vae: DACVAE, audio: torch.Tensor,
                     n_quantizers: Union[None, int, torch.Tensor] = None):
    """The discrete mode's encode: audio [B, 1, S] -> `rvq_apply`'s five
    results for the encoder's latents."""
    z = vae.encoder(preprocess(audio.float(), vae.cfg.hop_length))
    return rvq_apply(vae.quantizer, z, n_quantizers)


def decode_codes(vae: DACVAE, codes: torch.Tensor) -> torch.Tensor:
    """The discrete mode's decode from codes [B, N, T] -> audio [B, 1, S]."""
    return decode(vae, rvq_from_codes(vae.quantizer, codes)[0])


# --- chunked compress / decompress -----------------------------------------

def encoder_receptive_frames(cfg: DACVAEConfig) -> int:
    """One-sided encoder receptive field in latent frames (rounded up)."""
    rf, rate = 7, 1                               # conv_in, k 7
    for stride in cfg.encoder_rates:
        rf += rate * 6 * (1 + 3 + 9)              # three residual units, k 7 dilated
        rf += rate * (2 * stride - 1)             # the strided conv, k 2 * stride
        rate *= stride
    rf += rate * 2                                # conv_out, k 3
    return -(-rf // (2 * cfg.hop_length)) + 1


def decoder_receptive_frames(cfg: DACVAEConfig) -> int:
    """One-sided decoder receptive field in latent frames (rounded up),
    summed in output samples at each stage's rate."""
    rf_s = 7 * cfg.hop_length                     # conv_in, k 7 at the latent rate
    rate_s = cfg.hop_length
    for stride in cfg.decoder_rates:
        rate_s //= stride
        rf_s += rate_s * (2 * stride - 1)         # the transposed conv
        rf_s += rate_s * 6 * (1 + 3 + 9)          # three residual units
    rf_s += 6                                     # conv_out, k 7 at the sample rate
    return -(-rf_s // (2 * cfg.hop_length)) + 1


def _windows(total_t: int, chunk_frames: int, ov: int):
    """(start, offset, take) per window: windows of chunk + 2 * ov frames,
    clamped to the clip, so the edge windows meet its true boundaries and
    every kept frame lies at least `ov` from an inner window edge."""
    win_t = chunk_frames + 2 * ov
    for i in range(-(-total_t // chunk_frames)):
        start = min(max(i * chunk_frames - ov, 0), total_t - win_t)
        yield start, i * chunk_frames - start, min(chunk_frames, total_t - i * chunk_frames)


def compress(vae: DACVAE, audio: torch.Tensor, chunk_frames: int = 512,
             overlap_frames: int = 0) -> torch.Tensor:
    """Encode a long clip in windows. audio [B, 1, S] -> latent means
    [B, D, T] (continuous mode) or codes [B, N, T] (discrete mode),
    T = ceil(S / hop); the interior equals the one-pass encode."""
    cfg = vae.cfg
    ov = overlap_frames or encoder_receptive_frames(cfg)
    hop = cfg.hop_length
    audio = preprocess(audio, hop)
    total_t = audio.shape[-1] // hop

    def enc(a):
        return encode_quantized(vae, a)[1] if not cfg.continuous else encode_mode(vae, a)

    if total_t <= chunk_frames + 2 * ov:
        return enc(audio)
    win_t = chunk_frames + 2 * ov
    return torch.cat([enc(audio[..., start * hop:(start + win_t) * hop])[..., off:off + take]
                      for start, off, take in _windows(total_t, chunk_frames, ov)], dim=-1)


def decompress(vae: DACVAE, z: torch.Tensor, chunk_frames: int = 512,
               overlap_frames: int = 0) -> torch.Tensor:
    """Decode long latents [B, D, T] (or integer codes [B, N, T] of the
    discrete mode) in windows -> audio [B, 1, T * hop]; the interior equals
    `decode`."""
    dec = decode if z.is_floating_point() else decode_codes
    ov = overlap_frames or decoder_receptive_frames(vae.cfg)
    hop = vae.cfg.hop_length
    total_t = z.shape[-1]
    if total_t <= chunk_frames + 2 * ov:
        return dec(vae, z)
    win_t = chunk_frames + 2 * ov
    return torch.cat([dec(vae, z[..., start:start + win_t])[..., off * hop:(off + take) * hop]
                      for start, off, take in _windows(total_t, chunk_frames, ov)], dim=-1)
