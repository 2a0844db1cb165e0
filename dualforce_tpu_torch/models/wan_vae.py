"""Wan 3D-causal video VAE (counterpart of `dualforce_tpu/models/wan_vae.py`).

z = 16, spatial stride 8, temporal stride 4. Encode and decode are streamed
over time with carried causal-conv caches, as the reference's feature cache
does: the first chunk is one frame, each later encoder chunk a multiple of 4
raw frames, each later decoder chunk some latent frames. Every causal time
conv keeps its last (kt - 1) input frames for the next chunk; the temporal
downsample keeps one; the temporal upsample's first chunk bypasses its conv
with zero history ("Rep"). The one-pass encodes (`encode_moments`,
`encode_mode`, `encode_sample`) are the streaming encode with all frames
after the first in one chunk; the sampled ones add exp(logvar / 2) times a
given or drawn noise.

Public functions take and return channels-last tensors ([B, T, H, W, C]),
as the JAX package does; inside, tensors are PyTorch's [B, C, T, H, W].
Parameter names follow the Wan checkpoint (`encoder.conv1`,
`encoder.downsamples.{i}`, `encoder.middle.{i}`, `encoder.head.{i}`, the
decoder's `upsamples` mirrored). Conv weights are cast to the activation
dtype at use, so fp32 weights serve a bf16 decode.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dualforce_tpu_torch.config import WanVAEConfig
from dualforce_tpu_torch.registry import MODELS


class _Cache:
    """Causal-conv input histories, read and written in traversal order.
    `read` is None on the first chunk (zero history)."""

    def __init__(self, read: Optional[List[torch.Tensor]] = None):
        self.read = read
        self.written: List[torch.Tensor] = []
        self.cursor = 0

    def next(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        if self.read is None:
            b, c, _, h, w = x.shape
            cache = x.new_zeros((b, c, frames, h, w))
        else:
            cache = self.read[self.cursor]
        self.cursor += 1
        return cache

    def push(self, history: torch.Tensor) -> None:
        self.written.append(history)


class CausalConv3d(nn.Conv3d):
    """Conv3d with no time padding of its own: time history comes from the
    carried cache; space is padded symmetrically."""

    def __init__(self, cin, cout, kernel, stride=1, device=None, dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, device=device, dtype=dtype)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        _, kh, kw = self.kernel_size
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        (0, kh // 2, kw // 2))

    def stream(self, x: torch.Tensor, cache: _Cache) -> torch.Tensor:
        kt = self.kernel_size[0]
        if kt == 1:
            return self.conv(x)
        xin = torch.cat([cache.next(x, kt - 1), x], dim=2)
        cache.push(xin[:, :, -(kt - 1):])
        return self.conv(xin)


class RMSNormCh(nn.Module):
    """Wan RMS_norm over channels: x / ||x|| * sqrt(C) * gamma (+ bias), fp32
    math. `images=True` gives gamma the 2D shape (C, 1, 1). The per-channel
    bias, gamma's shape, is None unless the VAE was built with `norm_bias`
    (a checkpoint that carries one)."""

    def __init__(self, dim: int, images: bool = False, device=None, dtype=None):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape, device=device, dtype=dtype))
        self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().sum(dim=1, keepdim=True) + 1e-12)
        gamma = self.gamma.float().reshape(1, -1, 1, 1, 1)
        y = n * math.sqrt(x.shape[1]) * gamma
        if self.bias is not None:
            y = y + self.bias.float().reshape(1, -1, 1, 1, 1)
        return y.to(x.dtype)


def _conv2d_frames(conv: nn.Conv2d, x: torch.Tensor, padding) -> torch.Tensor:
    """A Conv2d applied to every frame of [B, C, T, H, W]."""
    b, c, t, h, w = x.shape
    xf = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
    y = F.conv2d(xf, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride, padding)
    return y.reshape(b, t, *y.shape[1:]).permute(0, 2, 1, 3, 4)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        # indices 0, 2, 3, 6 as in the checkpoint (SiLU and dropout hold none)
        self.residual = nn.ModuleList([
            RMSNormCh(cin, **f), nn.SiLU(), CausalConv3d(cin, cout, 3, **f),
            RMSNormCh(cout, **f), nn.SiLU(), nn.Identity(), CausalConv3d(cout, cout, 3, **f)])
        self.shortcut = CausalConv3d(cin, cout, 1, **f) if cin != cout else None

    def forward(self, x: torch.Tensor, cache: _Cache) -> torch.Tensor:
        r = self.residual
        h = r[2].stream(F.silu(r[0](x)), cache)
        h = r[6].stream(F.silu(r[3](h)), cache)
        return (self.shortcut.conv(x) if self.shortcut is not None else x) + h


class AttentionBlock(nn.Module):
    """Single-head per-frame spatial self-attention, plain PyTorch, fp32 softmax."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.norm = RMSNormCh(dim, images=True, **f)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1, **f)
        self.proj = nn.Conv2d(dim, dim, 1, **f)

    def forward(self, x: torch.Tensor, cache: _Cache = None) -> torch.Tensor:
        b, c, t, h, w = x.shape
        qkv = _conv2d_frames(self.to_qkv, self.norm(x), 0)        # [B, 3C, T, H, W]
        qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3 * c)
        q, k, v = qkv.float().split(c, dim=-1)
        probs = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
        o = torch.matmul(probs, v).to(x.dtype).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return x + _conv2d_frames(self.proj, o, 0)


class Resample(nn.Module):
    """Spatial 2x down- or upsampling per frame, with an optional temporal
    2x stage (`time_conv`). `resample.1` is the Conv2d, as in the checkpoint."""

    def __init__(self, dim: int, mode: str, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.mode = mode
        if mode in ("down2d", "down3d"):
            conv = nn.Conv2d(dim, dim, 3, stride=2, **f)
        else:
            conv = nn.Conv2d(dim, dim // 2, 3, **f)
        self.resample = nn.ModuleList([nn.Identity(), conv])
        self.time_conv = None
        if mode == "down3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), **f)
        elif mode == "up3d":
            self.time_conv = CausalConv3d(dim, dim * 2, (3, 1, 1), **f)

    def forward(self, x: torch.Tensor, cache: _Cache, is_first: bool) -> torch.Tensor:
        conv = self.resample[1]
        if self.mode.startswith("down"):
            # ZeroPad2d((0, 1, 0, 1)) + stride-2 conv per frame
            x = _conv2d_frames(conv, F.pad(x, (0, 1, 0, 1)), 0)
            return x if self.time_conv is None else self._down_time(x, cache, is_first)
        if self.time_conv is not None:
            x = self._up_time(x, cache, is_first)
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return _conv2d_frames(conv, x, 1)

    def _down_time(self, x, cache: _Cache, is_first: bool):
        """Stride-2 time conv with a one-frame history; the first chunk passes
        through and primes the history with its frame."""
        history = cache.next(x, 1)
        if is_first:
            cache.push(x[:, :, -1:])
            return x
        xin = torch.cat([history, x], dim=2)
        cache.push(xin[:, :, -1:])
        return self.time_conv.conv(xin)

    def _up_time(self, x, cache: _Cache, is_first: bool):
        """Temporal doubling: the first chunk bypasses the conv (its history
        stays zero); later chunks conv [history(2), x] to 2C channels and
        interleave them into 2T frames."""
        history = cache.next(x, 2)
        if is_first:
            cache.push(history)
            return x
        xin = torch.cat([history, x], dim=2)
        cache.push(xin[:, :, -2:])
        y = self.time_conv.conv(xin)                               # [B, 2C, T, H, W]
        b, c2, t, h, w = y.shape
        return y.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(
            b, c2 // 2, 2 * t, h, w)


def _head(cin: int, cout: int, device, dtype) -> nn.ModuleList:
    return nn.ModuleList([RMSNormCh(cin, device=device, dtype=dtype), nn.SiLU(),
                          CausalConv3d(cin, cout, 3, device=device, dtype=dtype)])


def _middle(dim: int, device, dtype) -> nn.ModuleList:
    return nn.ModuleList([ResidualBlock(dim, dim, device, dtype),
                          AttentionBlock(dim, device, dtype),
                          ResidualBlock(dim, dim, device, dtype)])


def _run(layers, x, cache: _Cache, is_first: bool):
    for layer in layers:
        x = layer(x, cache, is_first) if isinstance(layer, Resample) else layer(x, cache)
    return x


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        dims = [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = CausalConv3d(3, dims[0], 3, device=device, dtype=dtype)
        layers = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            d = din
            for _ in range(cfg.num_res_blocks):
                layers.append(ResidualBlock(d, dout, device, dtype))
                d = dout
            if i != len(cfg.dim_mult) - 1:
                mode = "down3d" if cfg.temperal_downsample[i] else "down2d"
                layers.append(Resample(dout, mode, device, dtype))
        self.downsamples = nn.ModuleList(layers)
        self.middle = _middle(dims[-1], device, dtype)
        self.head = _head(dims[-1], cfg.z_dim * 2, device, dtype)

    def chunk(self, x, cache: _Cache, is_first: bool):
        """One raw-frame chunk -> moments before quant_conv."""
        h = self.conv1.stream(x, cache)
        h = _run(self.downsamples, h, cache, is_first)
        h = _run(self.middle, h, cache, is_first)
        return self.head[2].stream(F.silu(self.head[0](h)), cache)


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        mult = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * u for u in (mult[-1],) + tuple(reversed(mult))]
        temperal_upsample = tuple(reversed(cfg.temperal_downsample))
        self.conv1 = CausalConv3d(cfg.z_dim, dims[0], 3, device=device, dtype=dtype)
        self.middle = _middle(dims[0], device, dtype)
        layers = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            if i in (1, 2, 3):
                din = din // 2  # the previous stage's upsampler halved channels
            d = din
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResidualBlock(d, dout, device, dtype))
                d = dout
            if i != len(mult) - 1:
                mode = "up3d" if temperal_upsample[i] else "up2d"
                layers.append(Resample(dout, mode, device, dtype))
        self.upsamples = nn.ModuleList(layers)
        self.head = _head(dims[-1], 3, device, dtype)

    def chunk(self, z, cache: _Cache, is_first: bool):
        """One latent chunk -> video frames."""
        h = self.conv1.stream(z, cache)
        h = _run(self.middle, h, cache, is_first)
        h = _run(self.upsamples, h, cache, is_first)
        return self.head[2].stream(F.silu(self.head[0](h)), cache)


@MODELS.register_module(name="WanVAE")
class WanVAE(nn.Module):
    """`norm_bias`: every RMS norm holds a per-channel bias (zeros until set or
    loaded), as a checkpoint written with biased norms needs."""

    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None, norm_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, dtype)
        self.decoder = Decoder(cfg, device, dtype)
        self.quant_conv = CausalConv3d(cfg.z_dim * 2, cfg.z_dim * 2, 1, device=device,
                                       dtype=dtype)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, 1, device=device,
                                            dtype=dtype)
        if norm_bias:
            for m in self.modules():
                if isinstance(m, RMSNormCh):
                    m.bias = nn.Parameter(torch.zeros_like(m.gamma))


def _cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of `module` whose parameters are `dtype` copies of its own (on
    their device); the module itself is left as it is."""
    memo = {id(p): nn.Parameter(p.detach().to(dtype), requires_grad=False)
            for p in module.parameters()}
    return copy.deepcopy(module, memo)


def encode_moments_streaming(vae: WanVAE, video: torch.Tensor, chunk: Optional[int] = None,
                             compute_dtype: Optional[torch.dtype] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded encode: video [B, T, H, W, 3] in [-1, 1] -> (mean,
    logvar), each [B, F, H/8, W/8, z], F = (T - 1) / 4 + 1 (logvar as the
    quant conv gives it, unclipped). After the first frame, chunks of
    `chunk` raw frames go through the encoder: by default the largest
    multiple of 4 dividing T - 1 within a 16-frames-at-360p budget scaled by
    the frame's pixel count; a `chunk` that is no multiple of 4 or does not
    divide T - 1 becomes 4.

    compute_dtype None runs in the video's dtype. A dtype runs the encoder
    in it (the video, a copy of the encoder's parameters made for the call,
    the carried caches), as the JAX package's `compute_dtype` does; the
    encoder's output is cast to the quant conv's own dtype, which the quant
    conv keeps. bf16 halves the encode's activation memory at 720p."""
    cfg = vae.cfg
    encoder = vae.encoder
    if compute_dtype is not None:
        encoder = _cast_copy(encoder, compute_dtype)
        video = video.to(compute_dtype)
    x = video.permute(0, 4, 1, 2, 3)
    T = x.shape[2]
    st = 2 ** sum(bool(t) for t in cfg.temperal_downsample)
    if (T - 1) % st:
        raise ValueError(f"num_frames-1 must be divisible by {st}, got T={T}")
    if chunk is None:
        budget = max(st, (16 * 352 * 640) // max(x.shape[3] * x.shape[4], 1) // st * st)
        budget = min(budget, max(T - 1, st))
        chunk = next(k for k in range(budget, 0, -st) if (T - 1) % k == 0)
    elif chunk % st or (T - 1) % chunk:
        chunk = st
    cache = _Cache()
    outs = [encoder.chunk(x[:, :, :1], cache, True)]
    for s in range(1, T, chunk):
        cache = _Cache(cache.written)
        outs.append(encoder.chunk(x[:, :, s:s + chunk], cache, False))
    del cache, encoder
    h = torch.cat(outs, dim=2)
    del outs
    if compute_dtype is not None:
        h = h.to(vae.quant_conv.weight.dtype)
    moments = vae.quant_conv.conv(h)
    return (moments[:, :cfg.z_dim].permute(0, 2, 3, 4, 1),
            moments[:, cfg.z_dim:].permute(0, 2, 3, 4, 1))


def encode_mode_streaming(vae: WanVAE, video: torch.Tensor, chunk: Optional[int] = None,
                          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The mean of `encode_moments_streaming` (sample mode "argmax")."""
    return encode_moments_streaming(vae, video, chunk, compute_dtype)[0]


def _sample(mean: torch.Tensor, logvar: torch.Tensor, noise: Optional[torch.Tensor],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """mean + exp(clip(logvar, -30, 20) / 2) * noise, the noise given or
    drawn from `generator` (standard normal, the mean's shape)."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * noise.to(mean.device, mean.dtype)


def encode_sample_streaming(vae: WanVAE, video: torch.Tensor,
                            noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            chunk: Optional[int] = None,
                            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A draw from the streaming encode's posterior (see `_sample`)."""
    return _sample(*encode_moments_streaming(vae, video, chunk, compute_dtype), noise,
                   generator)


def encode_moments(vae: WanVAE, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encode in one pass over the clip (the JAX package's
    `encode_moments`): the first frame, then every other frame as one chunk,
    which the causal caches make the whole pass. Returns (mean, logvar)."""
    return encode_moments_streaming(vae, video, max(video.shape[1] - 1, 1))


def encode_mode(vae: WanVAE, video: torch.Tensor) -> torch.Tensor:
    return encode_moments(vae, video)[0]


def encode_sample(vae: WanVAE, video: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return _sample(*encode_moments(vae, video), noise, generator)


def decode_streaming(vae: WanVAE, z: torch.Tensor) -> torch.Tensor:
    """Memory-bounded decode in z's dtype: z [B, F, h, w, z] -> video
    [B, (F - 1) * 4 + 1, 8h, 8w, 3]. After the first latent frame, chunks
    go through the decoder: the largest divisor of F - 1 within a
    4-frames-at-360p budget."""
    x = z.permute(0, 4, 1, 2, 3)
    F_ = x.shape[2]
    out_px = (x.shape[3] * 8) * (x.shape[4] * 8)
    budget = max(1, min((4 * 352 * 640) // max(out_px, 1), max(F_ - 1, 1)))
    chunk = next(k for k in range(budget, 0, -1) if (F_ - 1) % k == 0)
    x = vae.post_quant_conv.conv(x)
    cache = _Cache()
    outs = [vae.decoder.chunk(x[:, :, :1], cache, True)]
    for s in range(1, F_, chunk):
        cache = _Cache(cache.written)
        outs.append(vae.decoder.chunk(x[:, :, s:s + chunk], cache, False))
    return torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1)


def normalize_latents(z: torch.Tensor, cfg: WanVAEConfig) -> torch.Tensor:
    """(z - mean) / std with the per-channel config stats; channels-last."""
    mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
    std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
    return (z - mean) / std


def denormalize_latents(z: torch.Tensor, cfg: WanVAEConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
    std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
    return z * std + mean
