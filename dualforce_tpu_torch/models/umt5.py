"""UMT5 encoder (counterpart of `dualforce_tpu/models/umt5.py`).

T5 conventions: RMS layer norm with fp32 statistics and no mean, no
1/sqrt(d) attention scale, bidirectional relative-position buckets (32
buckets, max distance 128) with a bias table in EVERY layer (the UMT5
difference from T5), gated tanh-GELU FFN, additive -1e9 padding mask.
Parameter names are those of HF `UMT5EncoderModel` (`shared`,
`encoder.block.{i}.layer.0.SelfAttention.q`, ...). Its attention has
D = 64 and runs as plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dualforce_tpu_torch.config import UMT5Config


def _t5_ln(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """HF T5 bidirectional bucket function (host-side; positions are static)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class _T5LayerNorm(nn.Module):
    def __init__(self, dim, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: UMT5Config, device=None, dtype=None):
        super().__init__()
        f = dict(bias=False, device=device, dtype=dtype)
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, **f)
        self.k = nn.Linear(cfg.d_model, inner, **f)
        self.v = nn.Linear(cfg.d_model, inner, **f)
        self.o = nn.Linear(inner, cfg.d_model, **f)
        self.relative_attention_bias = nn.Embedding(
            cfg.relative_attention_num_buckets, cfg.num_heads, device=device, dtype=dtype)


class _AttentionLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, device, dtype)
        self.layer_norm = _T5LayerNorm(cfg.d_model, device, dtype)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        f = dict(bias=False, device=device, dtype=dtype)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **f)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **f)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **f)


class _FFLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg, device, dtype)
        self.layer_norm = _T5LayerNorm(cfg.d_model, device, dtype)


class _Block(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList([_AttentionLayer(cfg, device, dtype),
                                    _FFLayer(cfg, device, dtype)])

    def forward(self, x, bias_idx, mask_add, cfg: UMT5Config, compute_dtype):
        attn, ff = self.layer[0], self.layer[1]
        sa = attn.SelfAttention
        b, s, _ = x.shape
        h, dk = cfg.num_heads, cfg.d_kv
        xn = _t5_ln(x, attn.layer_norm.weight, cfg.layer_norm_epsilon)
        q = sa.q(xn).reshape(b, s, h, dk)
        k = sa.k(xn).reshape(b, s, h, dk)
        v = sa.v(xn).reshape(b, s, h, dk)
        pos_bias = sa.relative_attention_bias.weight[bias_idx]        # [s, s, h]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits + pos_bias.permute(2, 0, 1)[None].float()
        if mask_add is not None:
            logits = logits + mask_add
        probs = torch.softmax(logits, dim=-1).to(compute_dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(compute_dtype)).reshape(b, s, h * dk)
        x = x + sa.o(o).to(x.dtype)

        mlp = ff.DenseReluDense
        xn = _t5_ln(x, ff.layer_norm.weight, cfg.layer_norm_epsilon)
        gelu = F.gelu(mlp.wi_0(xn), approximate="tanh")
        return x + mlp.wo(gelu * mlp.wi_1(xn)).to(x.dtype)


class _Stack(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.block = nn.ModuleList(_Block(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.final_layer_norm = _T5LayerNorm(cfg.d_model, device, dtype)


class UMT5Encoder(nn.Module):
    # fp8 storage (`dnn.fp8_stored`): the JAX tree stacks `encoder.block`, and
    # names its RMSNorm scales `ln1`/`ln2`, so no leaf is exempt (HF's
    # `layer_norm` inside a block is fp8 too; the 1-D final norm stays bf16)
    FP8_STACKED = ("encoder.block.",)
    FP8_EXEMPT = ()

    def __init__(self, cfg: UMT5Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device, dtype=dtype)
        self.encoder = _Stack(cfg, device, dtype)


def encode(model: UMT5Encoder, input_ids: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """input_ids [B, S] -> last hidden state [B, S, d_model]."""
    cfg = model.cfg
    s = input_ids.shape[1]
    x = model.shared.weight[input_ids].to(compute_dtype)
    pos = np.arange(s)
    bias_idx = torch.from_numpy(relative_position_bucket(
        pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)).to(input_ids.device)
    mask_add = None
    if attention_mask is not None:
        mask_add = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
    for block in model.encoder.block:
        x = block(x, bias_idx, mask_add, cfg, compute_dtype)
    return _t5_ln(x, model.encoder.final_layer_norm.weight, cfg.layer_norm_epsilon)
