"""Neural-network primitives (counterpart of `dualforce_tpu/nn.py`).

Numerics follow the JAX package: LayerNorm and RMSNorm take their
statistics in fp32 and cast back; patch embedding is a reshape and a matrix
product in the same token order; the sinusoidal embedding puts cos first.
Weights keep PyTorch's layouts (`nn.Linear` is [out, in], the patch
embedding a Conv weight), so a linear layer is `torch.nn.Linear` and
`torch.nn.functional.linear` as they are, and SiLU is `F.silu`. The JAX
package's int8, int4 and fp8 weight paths are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics; affine if given."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm over the last axis: normalise in fp32, scale, cast back."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def call(module: nn.Module, params: Optional[Dict[str, torch.Tensor]], prefix: str,
         *args):
    """`module(*args)` with some parameters replaced: the entries of `params`
    (a flat {name: tensor} dict, named from an enclosing module) whose names
    start with `prefix`, prefix stripped, stand in for the module's own
    parameters of those names for this call (`torch.func.functional_call`).
    The LoRA-merged weights of training reach the layers this way, so the
    base parameters stay as they are. No matching entry: a plain call."""
    sub = ({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
           if params else None)
    if not sub:
        return module(*args)
    return torch.func.functional_call(module, sub, args)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.Module):
    """`layer_norm` with parameters `weight` and `bias`."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.eps, self.weight, self.bias)


class RMSNorm(nn.Module):
    """`rms_norm` with parameter `weight`."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def patch_embed_3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   patch_size: Tuple[int, int, int]):
    """Conv3d with stride == kernel as a reshape and a matrix product.

    x: [B, C, F, H, W]; weight: the conv weight [dim, C, pt, ph, pw].
    Returns tokens [B, f*h*w, dim] in (f, h, w) order, and the grid (f, h, w).
    """
    b, c, F_, H, W = x.shape
    pt, ph, pw = patch_size
    f, h, w = F_ // pt, H // ph, W // pw
    x = x.reshape(b, c, f, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    x = x.reshape(b, f * h * w, c * pt * ph * pw)
    return F.linear(x, weight.reshape(weight.shape[0], -1), bias), (f, h, w)


def unpatchify_3d(x: torch.Tensor, grid: Tuple[int, int, int],
                  patch_size: Tuple[int, int, int], out_dim: int) -> torch.Tensor:
    """[B, f*h*w, pt*ph*pw*out] -> [B, out, F, H, W], channel-last in the patch."""
    f, h, w = grid
    pt, ph, pw = patch_size
    b = x.shape[0]
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def patch_embed_1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   patch_size: int):
    """Conv1d with stride == kernel: x [B, C, T], weight [dim, C, p] ->
    (tokens [B, T//p, dim], T//p)."""
    b, c, T = x.shape
    f = T // patch_size
    x = x.reshape(b, c, f, patch_size).permute(0, 2, 1, 3).reshape(b, f, c * patch_size)
    return F.linear(x, weight.reshape(weight.shape[0], -1), bias), f


def unpatchify_1d(x: torch.Tensor, patch_size: int, out_dim: int) -> torch.Tensor:
    """[B, f, p*out] -> [B, out, f*p]."""
    b, f, _ = x.shape
    x = x.reshape(b, f, patch_size, out_dim).permute(0, 3, 1, 2)
    return x.reshape(b, out_dim, f * patch_size)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] embedding of positions [B] -> [B, dim], in fp32."""
    half = dim // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=position.device) / half
    freqs = torch.pow(torch.tensor(10000.0, device=position.device), exponent)
    sinusoid = position.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)
