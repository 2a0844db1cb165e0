"""Plain fp32 references of MOVA's frozen encoders, written from their
published descriptions and independent of the code under test (nothing of
the port is imported): the UMT5 text encoder (T5 v1.1 with a relative
position bias in every layer), the Wan 2.x causal 3D video VAE's encoder
and the DAC audio VAE's encoder (its continuous mode's mean).

Weights arrive as `mova.Params` over the checkpoints' own names; hidden
states carry a batch axis of 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.mova import Params

# --- UMT5 ----------------------------------------------------------------------


def relative_buckets(length: int, buckets: int, max_distance: int) -> np.ndarray:
    """T5's bidirectional bucket of each (query, key) pair's key - query
    offset: half the buckets per direction, exact below a quarter of them,
    logarithmic up to `max_distance`."""
    pos = np.arange(length)
    rel = pos[None, :] - pos[:, None]
    half = buckets // 2
    out = (rel > 0).astype(np.int64) * half
    n = np.abs(rel)
    exact = half // 2
    large = exact + (np.log(np.maximum(n, 1) / exact) / math.log(max_distance / exact)
                     * (half - exact)).astype(np.int64)
    return out + np.where(n < exact, n, np.minimum(large, half - 1))


def _t5_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def umt5(p: Params, tc: dict, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ids, mask [L] -> the last hidden state [L, d_model], zero past the
    mask: no 1/sqrt(d) attention scale, padded keys masked out."""
    x = p("shared.weight")[ids]
    seq, heads, dk = ids.shape[0], tc["num_heads"], tc["d_kv"]
    bucket = torch.from_numpy(relative_buckets(seq, tc["relative_attention_num_buckets"],
                                               tc["relative_attention_max_distance"]))
    bucket = bucket.to(ids.device)
    masked = torch.where(mask > 0, 0.0, float("-inf"))[None, None, :]
    eps = tc["layer_norm_epsilon"]
    for i in range(tc["num_layers"]):
        a = f"encoder.block.{i}.layer.0."
        h = _t5_norm(x, p(a + "layer_norm.weight"), eps)
        q, k, v = (F.linear(h, p(f"{a}SelfAttention.{n}.weight")).reshape(seq, heads, dk)
                   .permute(1, 0, 2) for n in ("q", "k", "v"))
        bias = p(a + "SelfAttention.relative_attention_bias.weight")[bucket].permute(2, 0, 1)
        probs = torch.softmax(q @ k.transpose(1, 2) + bias + masked, dim=-1)
        o = (probs @ v).permute(1, 0, 2).reshape(seq, heads * dk)
        x = x + F.linear(o, p(a + "SelfAttention.o.weight"))
        f = f"encoder.block.{i}.layer.1."
        h = _t5_norm(x, p(f + "layer_norm.weight"), eps)
        gate = F.gelu(F.linear(h, p(f + "DenseReluDense.wi_0.weight")), approximate="tanh")
        x = x + F.linear(gate * F.linear(h, p(f + "DenseReluDense.wi_1.weight")),
                         p(f + "DenseReluDense.wo.weight"))
    x = _t5_norm(x, p("encoder.final_layer_norm.weight"), eps)
    return x * mask[:, None].to(x.dtype)


# --- the Wan 2.x video VAE's encoder ---------------------------------------------------


def _channel_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Wan's RMS_norm: x / ||x||_channels * sqrt(C) * gamma, over axis 1."""
    gamma = p(name + "gamma").reshape(1, -1, *([1] * (x.dim() - 2)))
    return F.normalize(x, dim=1) * math.sqrt(x.shape[1]) * gamma


def _causal3d(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """A causal conv over [1, C, T, H, W]: kt - 1 zero frames before the
    first, space padded symmetrically."""
    w = p(name + "weight")
    kt, kh, kw = w.shape[2:]
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0))
    return F.conv3d(x, w, p(name + "bias"))


def _frames2d(x: torch.Tensor, fn) -> torch.Tensor:
    """fn over every frame of [1, C, T, H, W] as a batch of images."""
    b, c, t, h, w = x.shape
    y = fn(x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).permute(0, 2, 1, 3, 4)


def _residual(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    h = _causal3d(p, name + "residual.2.", F.silu(_channel_norm(p, name + "residual.0.", x)))
    h = _causal3d(p, name + "residual.6.", F.silu(_channel_norm(p, name + "residual.3.", h)))
    if (name + "shortcut.weight") in p.tensors:
        x = _causal3d(p, name + "shortcut.", x)
    return x + h


def _attention2d(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Single-head self-attention over each frame's positions."""
    c = x.shape[1]

    def per_frame(img):
        n, _, h, w = img.shape
        qkv = F.conv2d(_channel_norm(p, name + "norm.", img), p(name + "to_qkv.weight"),
                       p(name + "to_qkv.bias"))
        q, k, v = qkv.reshape(n, 3 * c, h * w).transpose(1, 2).split(c, dim=-1)
        o = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1) @ v
        o = o.transpose(1, 2).reshape(n, c, h, w)
        return img + F.conv2d(o, p(name + "proj.weight"), p(name + "proj.bias"))

    return _frames2d(x, per_frame)


def _downsample(p: Params, name: str, x: torch.Tensor, temporal: bool) -> torch.Tensor:
    """Spatial: pad right and bottom by one, a stride-2 3x3 conv per frame.
    Temporal: the first frame kept as it is, then a stride-2 time conv
    (kernel 3) over all frames from the first on."""
    x = _frames2d(x, lambda img: F.conv2d(F.pad(img, (0, 1, 0, 1)),
                                          p(name + "resample.1.weight"),
                                          p(name + "resample.1.bias"), stride=2))
    if not temporal:
        return x
    later = F.conv3d(x, p(name + "time_conv.weight"), p(name + "time_conv.bias"),
                     stride=(2, 1, 1))
    return torch.cat([x[:, :, :1], later], dim=2)


def wan_encode(p: Params, vc: dict, video: torch.Tensor) -> torch.Tensor:
    """video [T, H, W, 3] in [-1, 1] -> the posterior mean, normalized by the
    configuration's per-channel latent statistics: [z, F, H/8, W/8],
    F = (T - 1) / 4 + 1."""
    x = video.permute(3, 0, 1, 2)[None]
    x = _causal3d(p, "encoder.conv1.", x)
    i = 0
    stages = len(vc["dim_mult"])
    for stage in range(stages):
        for _ in range(vc["num_res_blocks"]):
            x = _residual(p, f"encoder.downsamples.{i}.", x)
            i += 1
        if stage != stages - 1:
            x = _downsample(p, f"encoder.downsamples.{i}.", x, vc["temperal_downsample"][stage])
            i += 1
    x = _residual(p, "encoder.middle.0.", x)
    x = _attention2d(p, "encoder.middle.1.", x)
    x = _residual(p, "encoder.middle.2.", x)
    x = _causal3d(p, "encoder.head.2.", F.silu(_channel_norm(p, "encoder.head.0.", x)))
    mean = F.conv3d(x, p("quant_conv.weight"), p("quant_conv.bias"))[0, :vc["z_dim"]]
    shape = (-1, 1, 1, 1)
    lm = torch.tensor(vc["latents_mean"], device=mean.device).reshape(shape)
    ls = torch.tensor(vc["latents_std"], device=mean.device).reshape(shape)
    return (mean - lm) / ls


# --- the DAC audio VAE's encoder -----------------------------------------------------------


def _snake(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    alpha = p(name + "alpha")
    return x + torch.sin(alpha * x).square() / (alpha + 1e-9)


def _residual_unit(p: Params, name: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = F.conv1d(_snake(p, name + "block.0.", x), p(name + "block.1.weight"),
                 p(name + "block.1.bias"), dilation=dilation, padding=3 * dilation)
    y = F.conv1d(_snake(p, name + "block.2.", y), p(name + "block.3.weight"),
                 p(name + "block.3.bias"))
    return x + y


def dac_encode(p: Params, ac: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio [S] -> the continuous posterior mean [latent_dim, ceil(S / hop)],
    the audio right-padded with zeros to a whole number of hops."""
    hop = math.prod(ac["encoder_rates"])
    x = F.pad(audio, (0, -audio.shape[-1] % hop))[None, None]
    x = F.conv1d(x, p("encoder.block.0.weight"), p("encoder.block.0.bias"), padding=3)
    for i, stride in enumerate(ac["encoder_rates"]):
        b = f"encoder.block.{i + 1}.block."
        for j, dilation in enumerate((1, 3, 9)):
            x = _residual_unit(p, f"{b}{j}.", x, dilation)
        x = F.conv1d(_snake(p, f"{b}3.", x), p(f"{b}4.weight"), p(f"{b}4.bias"),
                     stride=stride, padding=math.ceil(stride / 2))
    n = len(ac["encoder_rates"])
    x = F.conv1d(_snake(p, f"encoder.block.{n + 1}.", x), p(f"encoder.block.{n + 2}.weight"),
                 p(f"encoder.block.{n + 2}.bias"), padding=1)
    return F.conv1d(x, p("quant_conv.weight"), p("quant_conv.bias"))[0, :ac["latent_dim"]]
