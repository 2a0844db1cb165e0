"""Neural-network primitives (counterpart of `dualforce_tpu/nn.py`).

Numerics follow the JAX package: LayerNorm and RMSNorm take their
statistics in fp32 and cast back; patch embedding is a reshape and a matrix
product in the same token order; the sinusoidal embedding puts cos first.
Weights keep PyTorch's layouts (`nn.Linear` is [out, in], the patch
embedding a Conv weight), so a linear layer is `torch.nn.Linear` and
`torch.nn.functional.linear` as they are, and SiLU is `F.silu`.

The serving precision modes are here too: `Int8Linear` (w8a8, the
counterpart of `quantize_linear_int8` / `_linear_int8`), `Int4Linear`
(packed int4 weights dequantised at use, `quantize_linear_int4` /
`_linear_int4`) and `quantize_modules`, the counterpart of
`quantize_tree_int8` / `quantize_tree_int4`. Their arithmetic is JAX's; only
the layout follows PyTorch's [out, in] weights. fp8 weight storage
(`cast_modules_fp8`, `Fp8Linear`) is the counterpart of `cast_tree_fp8` and
`_weight`: weights kept in fp8 and upcast at each use.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def recompute_in_backward(fn, *args):
    """fn(*args) for a chain of elementwise work (the norms and RoPE, which
    widen to fp32; the FFN's GELU with the product after it). Where autograd
    records it, its intermediates are not kept for the backward but
    recomputed there from `args` (a nested non-reentrant
    `torch.utils.checkpoint`): the same arithmetic, so the same values and
    gradients, in about the memory that the JAX package's fused remat holds.
    Every tensor `fn` reads that needs a gradient or comes from a
    `functional_call` must be in `args`: the recompute runs outside that
    call. At 720p training one fp32 [176,400, 5120] intermediate is 3.4 GiB,
    and a video block kept some fifteen of them."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _layer_norm(x, eps, weight, bias):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics; affine if given."""
    return recompute_in_backward(_layer_norm, x, eps, weight, bias)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm over the last axis: normalise in fp32, scale, cast back. The
    attention projections run it inside their own recomputed chain
    (`models/video_dit.Attention.qkv`)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def call(module: nn.Module, params: Optional[Dict[str, torch.Tensor]], prefix: str,
         *args):
    """`module(*args)` with some parameters replaced: the entries of `params`
    (a flat {name: tensor} mapping, named from an enclosing module) whose
    names start with `prefix`, prefix stripped, stand in for the module's
    own parameters of those names for this call (`torch.func.functional_call`).
    The LoRA-merged weights of training reach the layers this way, so the
    base parameters stay as they are; only the matching entries are read
    (`engine.lora.MergedWeights` computes each as it is read). No matching
    entry: a plain call."""
    sub = ({k[len(prefix):]: params[k] for k in params if k.startswith(prefix)}
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
    w2 = weight.reshape(weight.shape[0], -1).to(x.dtype)     # fp8 storage: upcast
    return F.linear(x, w2, bias.to(x.dtype)), (f, h, w)


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
    w2 = weight.reshape(weight.shape[0], -1).to(x.dtype)     # fp8 storage: upcast
    return F.linear(x, w2, bias.to(x.dtype)), f


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


# --- int8 and int4 linears (serving) -----------------------------------------

QUANT_SCOPES = ("self_attn", "cross_attn", "ffn", "inner")
INT4_GROUP = 128   # input-dim group of the int4 scales (MOVA's in-dims all divide it)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 activations of `_linear_int8`: (round(x / s) as int8,
    s = max(absmax / 127, 1e-12) in fp32 with a trailing axis of 1). The
    same fp32 arithmetic as casting x to fp32 first, with fewer passes over
    device memory: |x|'s max is exact in x's dtype, and x / s promotes to
    fp32 element by element."""
    scale = (x.abs().amax(dim=-1, keepdim=True).float() / 127.0).clamp_min(1e-12)
    return torch.round_(x / scale).to(torch.int8), scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] (`torch._int_mm`). CUDA's
    wants more than 16 rows, so fewer are padded with zero rows."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b)[:m]


class Int8Linear(nn.Module):
    """w8a8 linear: int8 weights [out, in] with per-output-channel fp32
    scales; activations quantized per token in fp32 at each call; int8 x int8
    -> int32; dequantised in fp32 as (acc * a_scale) * w_scale, cast to x's
    dtype, then the bias is added. The bias is the source layer's own
    parameter (shared, not copied)."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.bias = bias

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "Int8Linear":
        w = linear.weight.detach().float()
        scale = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
        return cls(torch.round(w / scale[:, None]).to(torch.int8), scale, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ai, a_scale = quantize_activations(x)
        acc = _int_mm(ai.reshape(-1, ai.shape[-1]), self.weight_q.t())
        acc = acc.reshape(*x.shape[:-1], acc.shape[-1])
        y = (acc * a_scale).mul_(self.weight_scale).to(x.dtype)   # acc promotes to fp32
        return y if self.bias is None else y + self.bias.to(y.dtype)   # fp8 storage: upcast


def dequantize_int4(q4: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
                    ) -> torch.Tensor:
    """[out, in/2] packed uint8 (even input index in the high nibble) and
    [out, in/group] scales -> [out, in] in `dtype`, multiplied in `dtype`."""
    hi = (q4 >> 4).to(torch.int8) - 8
    lo = (q4 & 0xF).to(torch.int8) - 8
    w = torch.stack([hi, lo], dim=-1).reshape(q4.shape[0], -1)
    ng = scale.shape[-1]
    wg = w.reshape(w.shape[0], ng, -1).to(dtype) * scale[:, :, None].to(dtype)
    return wg.reshape(w.shape[0], -1)


class Int4Linear(nn.Module):
    """Weights-only int4 linear: values clip(round(w / s), -7, 7) + 8, two
    per byte along the input dim, with fp32 scales per (output channel,
    input group of 128, or the whole input dim where 128 does not divide
    it); dequantised to the activation dtype at each call, then a matrix
    product in that dtype and the bias added in it. The bias is the source
    layer's own parameter."""

    def __init__(self, weight_q4: torch.Tensor, weight_scale4: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("weight_q4", weight_q4)
        self.register_buffer("weight_scale4", weight_scale4)
        self.bias = bias

    @classmethod
    def from_linear(cls, linear: nn.Linear, group: int = INT4_GROUP) -> "Int4Linear":
        w = linear.weight.detach().float()
        dout, din = w.shape
        if din % 2:
            raise ValueError(f"int4 pack needs even in_dim, got {din}")
        g = group if din % group == 0 else din
        wg = w.reshape(dout, din // g, g)
        scale = (wg.abs().amax(dim=2) / 7.0).clamp_min(1e-12)
        q = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7)
        q = (q.reshape(dout, din // 2, 2) + 8.0).to(torch.uint8)
        return cls((q[..., 0] << 4) | q[..., 1], scale, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, dequantize_int4(self.weight_q4, self.weight_scale4, x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


_QUANTIZERS = {"int8": Int8Linear.from_linear, "int4": Int4Linear.from_linear}


def quantize_modules(module: nn.Module, mode: str) -> nn.Module:
    """A copy of `module` in which every `nn.Linear` below a child named in
    `QUANT_SCOPES` (block attention q/k/v/o, FFN, the bridge's inner
    attention) is an `Int8Linear` ("int8") or an `Int4Linear` ("int4"). The
    copy shares every other parameter and buffer with `module`, which is
    left as it was."""
    make = _QUANTIZERS[mode]
    shared = {id(t): t for t in itertools.chain(module.parameters(), module.buffers())}
    out = copy.deepcopy(module, shared)

    def walk(parent: nn.Module, in_scope: bool) -> None:
        for name, child in parent.named_children():
            scoped = in_scope or name in QUANT_SCOPES
            if scoped and isinstance(child, nn.Linear):
                setattr(parent, name, make(child))
            else:
                walk(child, scoped)

    walk(out, False)
    return out


# --- fp8 weight storage ---------------------------------------------------------

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)

# `cast_tree_fp8` stores a leaf of the JAX package's tree in fp8 when it has two
# axes or more and its path holds neither "modulation" nor "norm". Those trees
# stack every block list along a leading layer axis, so each parameter of a
# stacked list has two axes or more there, 1-D biases and UMT5's per-layer bias
# tables and RMSNorm scales included. A model class names its stacked lists
# (`FP8_STACKED`, prefixes of parameter names) and the parameters whose JAX path
# holds "modulation" or "norm" (`FP8_EXEMPT`, name fragments); a module that
# declares neither gets JAX's rule on its own names.


def fp8_stored(module: nn.Module, name: str, p: torch.Tensor) -> bool:
    """Whether `cast_tree_fp8` stores the JAX leaf of `module`'s parameter
    `name` in fp8."""
    stacked = getattr(type(module), "FP8_STACKED", ())
    exempt = getattr(type(module), "FP8_EXEMPT", ("modulation", "norm"))
    return ((name.startswith(stacked) or p.dim() >= 2)
            and not any(k in name for k in exempt))


class Fp8Linear(nn.Linear):
    """A linear whose weight (and, inside a block, bias) is stored in fp8:
    each call upcasts them to the input's dtype, as JAX's `_weight` does, and
    runs the product in that dtype. No upcast copy outlives the call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def _as_fp8_linear(linear: nn.Linear) -> Fp8Linear:
    with torch.device("meta"):
        out = Fp8Linear(linear.in_features, linear.out_features,
                        bias=linear.bias is not None)
    out.weight, out.bias = linear.weight, linear.bias
    return out


def to_fp8(t: torch.Tensor, weight_dtype: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """`t` in `weight_dtype`, values beyond its range saturated to its
    largest finite value (see `cast_modules_fp8`)."""
    top = torch.finfo(weight_dtype).max
    return t.clamp(-top, top).to(weight_dtype)


@torch.no_grad()
def cast_modules_fp8(module: nn.Module,
                     weight_dtype: torch.dtype = torch.float8_e4m3fn) -> nn.Module:
    """The counterpart of `cast_tree_fp8`, in place: the parameters that
    `fp8_stored` names go to `weight_dtype` (those already there stay as
    they are), the rest to bf16, and every `nn.Linear` whose weight is now
    fp8 becomes an `Fp8Linear` holding the same parameters. Values beyond
    the fp8 range saturate to its largest finite value, where the JAX
    package's cast (ml_dtypes) gives NaN; the clamp makes it so whatever
    PyTorch's own cast does (2.11 gives NaN, 2.13 saturates). Returns
    `module`."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        if p.dtype == weight_dtype:
            continue
        if fp8_stored(module, name, p):
            q = to_fp8(p, weight_dtype)
        else:
            q = p.to(torch.bfloat16)
        setattr(sub, leaf, nn.Parameter(q, requires_grad=False))

    def walk(parent: nn.Module) -> None:
        for name, child in parent.named_children():
            if type(child) is nn.Linear and child.weight.dtype in FP8_DTYPES:
                setattr(parent, name, _as_fp8_linear(child))
            else:
                walk(child)

    walk(module)
    return module
