"""Plain fp32 reference of one MOVA denoise step, written from the model's
published description (the Wan 2.x DiT block, MOVA's dual-tower bridge) and
independent of the code under test: it imports nothing of the port.

Everything is float32 with TF32 off (`no_tf32`). Weights arrive as a flat
{parameter name: tensor} mapping per module in the MOVA state-dict layout
(`reference.layout`) and are upcast where they are read; a weight transform
(`weight_fn`) lets a caller apply a storage format first (fp8 storage, see
`fp8_storage`). Hidden states carry no batch axis: one request, B = 1.

The step: per pass, the video expert, the audio tower and the bridge run
interleaved (per shared layer a2v and v2a read the pre-interaction states,
then the video block, then the audio block; then the video-only tail), the
heads and unpatchify; the passes' text CFG combine; the per-modality Euler
update on the schedule's sigma columns (`reference.schedule`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import rope

# fp32 attention logits one block of query rows may hold
ATTN_BLOCK_BYTES = 1 << 31
# rows of a wide linear (the FFN's up projection) computed at once
FFN_ROWS = 16384
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products and convolutions in full float32 for the
    body; the settings as they were after it, so a program that runs later
    in the process runs as it was set."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])


def fp8_storage(module: str, name: str, w: torch.Tensor) -> torch.Tensor:
    """A weight as the towers' fp8 storage keeps it (e4m3, saturated at its
    largest finite value, no scale): every parameter of the block stacks and
    of the bridge's conditioners, and every other one of two axes or more,
    except modulation tables and norm scales (the rule of the JAX package's
    `cast_tree_fp8`, which the 720p deployment's `--weight_dtype fp8`
    applies); the others are kept in bf16."""
    stacked = name.startswith(("blocks.", "audio_to_video_conditioners.",
                               "video_to_audio_conditioners."))
    exempt = any(k in name for k in ("modulation", "norm_q.", "norm_k.", "norm3.", "y_norm."))
    if (stacked or w.dim() >= 2) and not exempt:
        return w.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    return w.to(torch.bfloat16).float()


class Params:
    """One module's weights, read as float32 through `weight_fn`."""

    def __init__(self, module: str, tensors: Dict[str, torch.Tensor],
                 weight_fn: Optional[Callable] = None):
        self.module, self.tensors, self.weight_fn = module, tensors, weight_fn

    def __call__(self, name: str) -> torch.Tensor:
        w = self.tensors[name]
        return self.weight_fn(self.module, name, w) if self.weight_fn else w.float()


class LoraParams(Params):
    """A module's weights with LoRA factors merged where they are read:
    W + (a b)^T * scale for each weight named in `factors` ({name: {"a":
    [in, r], "b": [r, out]}}), differentiable in the factors."""

    def __init__(self, module: str, tensors: Dict[str, torch.Tensor],
                 factors: Dict[str, Dict[str, torch.Tensor]], scale: float,
                 weight_fn: Optional[Callable] = None):
        super().__init__(module, tensors, weight_fn)
        self.factors, self.scale = factors, scale

    def __call__(self, name: str) -> torch.Tensor:
        w = super().__call__(name)
        ab = self.factors.get(name)
        return w if ab is None else w + (ab["a"] @ ab["b"]).t() * self.scale


# --- primitives ---------------------------------------------------------------

def linear(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p(prefix + "weight"), p(prefix + "bias"))


def layer_norm(x: torch.Tensor, eps: float, weight=None, bias=None) -> torch.Tensor:
    y = F.layer_norm(x, x.shape[-1:], eps=eps)
    return y if weight is None else y * weight + bias


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("qnd,knd->nqk", q * q.shape[-1] ** -0.5, k)
    return torch.einsum("nqk,knd->qnd", torch.softmax(logits, dim=-1), v)


def _attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`attention` for autograd: in blocks of heads whose logits fit, each
    computed again in the backward instead of kept."""
    n = q.shape[1]
    heads = max(1, min(n, ATTN_BLOCK_BYTES // (4 * q.shape[0] * k.shape[0])))
    return torch.cat([checkpoint(_plain_attention, q[:, h:h + heads], k[:, h:h + heads],
                                 v[:, h:h + heads], use_reentrant=False)
                      for h in range(0, n, heads)], dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, non-causal, over [S, N, D] tensors, in
    blocks of heads and query rows so that the logits fit."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _attention_grad(q, k, v)
    sq, n, d = q.shape
    sk = k.shape[0]
    qh = (q * d ** -0.5).permute(1, 0, 2)
    kt = k.permute(1, 2, 0).contiguous()
    vh = v.permute(1, 0, 2).contiguous()
    out = torch.empty((n, sq, d), dtype=q.dtype, device=q.device)
    heads = n
    while heads > 1 and ATTN_BLOCK_BYTES // (4 * heads * sk) < 1024:
        heads = (heads + 1) // 2
    rows = max(1, ATTN_BLOCK_BYTES // (4 * heads * sk))
    for h0 in range(0, n, heads):
        h1 = min(n, h0 + heads)
        for s0 in range(0, sq, rows):
            logits = torch.matmul(qh[h0:h1, s0:s0 + rows], kt[h0:h1])
            logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
            denom = logits.sum(dim=-1, keepdim=True)
            out[h0:h1, s0:s0 + rows] = torch.matmul(logits, vh[h0:h1]).div_(denom)
            del logits
    return out.permute(1, 0, 2)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Channel pairs (2i, 2i+1) rotated as complex numbers; x [S, N, D],
    cos/sin [S, D/2]."""
    s, n, d = x.shape
    xr = x.reshape(s, n, d // 2, 2)
    even, odd = xr[..., 0], xr[..., 1]
    c, si = cos[:, None, :], sin[:, None, :]
    return torch.stack([even * c - odd * si, even * si + odd * c], dim=-1).reshape(s, n, d)


def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE; x [S, N, D], cos/sin [S, D]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


# --- the DiT block (Wan 2.x) -------------------------------------------------------

def _qk(p: Params, prefix: str, x: torch.Tensor, ctx: torch.Tensor, heads: int, eps: float):
    d = x.shape[-1] // heads
    q = rms_norm(linear(p, prefix + "q.", x), p(prefix + "norm_q.weight"), eps)
    k = rms_norm(linear(p, prefix + "k.", ctx), p(prefix + "norm_k.weight"), eps)
    v = linear(p, prefix + "v.", ctx)
    return (q.reshape(x.shape[0], heads, d), k.reshape(ctx.shape[0], heads, d),
            v.reshape(ctx.shape[0], heads, d))


def ffn(p: Params, prefix: str, h: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled():
        return linear(p, prefix + "2.", gelu_tanh(linear(p, prefix + "0.", h)))
    out = torch.empty_like(h)
    for r0 in range(0, h.shape[0], FFN_ROWS):
        up = gelu_tanh(linear(p, prefix + "0.", h[r0:r0 + FFN_ROWS]))
        out[r0:r0 + FFN_ROWS] = linear(p, prefix + "2.", up)
    return out


def dit_block(p: Params, prefix: str, x: torch.Tensor, ctx: torch.Tensor,
              t_mod: torch.Tensor, rope_cs, heads: int, eps: float) -> torch.Tensor:
    """AdaLN-modulated self-attention (RMS-normed q/k, interleaved RoPE),
    text cross-attention (affine LayerNorm before it), tanh-GELU FFN."""
    mod = p(prefix + "modulation")[0] + t_mod
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.unbind(0)
    h = layer_norm(x, eps) * (1 + scale_msa) + shift_msa
    q, k, v = _qk(p, prefix + "self_attn.", h, h, heads, eps)
    q, k = rope_interleaved(q, *rope_cs), rope_interleaved(k, *rope_cs)
    a = attention(q, k, v).reshape(x.shape)
    x = x + gate_msa * linear(p, prefix + "self_attn.o.", a)
    h = layer_norm(x, eps, p(prefix + "norm3.weight"), p(prefix + "norm3.bias"))
    q, k, v = _qk(p, prefix + "cross_attn.", h, ctx, heads, eps)
    x = x + linear(p, prefix + "cross_attn.o.", attention(q, k, v).reshape(x.shape))
    h = layer_norm(x, eps) * (1 + scale_mlp) + shift_mlp
    return x + gate_mlp * ffn(p, prefix + "ffn.", h)


def conditioner(p: Params, prefix: str, x: torch.Tensor, y: torch.Tensor, x_cs, y_cs,
                heads: int, eps: float) -> torch.Tensor:
    """MOVA's bridge cross-attention: x attends over LayerNorm(y), RMS-normed
    q/k, rotate-half RoPE on time-aligned positions on each side."""
    yn = layer_norm(y, eps, p(prefix + "y_norm.weight"), p(prefix + "y_norm.bias"))
    q, k, v = _qk(p, prefix + "inner.", x, yn, heads, eps)
    q, k = rope_half(q, *x_cs), rope_half(k, *y_cs)
    return linear(p, prefix + "inner.o.", attention(q, k, v).reshape(x.shape))


# --- the towers' ends ---------------------------------------------------------------

def sinusoidal(dim: int, t: float, device) -> torch.Tensor:
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64, device=device) / half)
    arg = t * freqs
    return torch.cat([torch.cos(arg), torch.sin(arg)]).float()


def time_embeds(p: Params, t: float, freq_dim: int, dim: int, device):
    e = sinusoidal(freq_dim, t, device)
    temb = linear(p, "time_embedding.2.", F.silu(linear(p, "time_embedding.0.", e)))
    t_mod = linear(p, "time_projection.1.", F.silu(temb)).reshape(6, dim)
    return temb, t_mod


def text_embed(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    return linear(p, "text_embedding.2.", gelu_tanh(linear(p, "text_embedding.0.", ctx)))


def head(p: Params, x: torch.Tensor, temb: torch.Tensor, eps: float) -> torch.Tensor:
    mod = p("head.modulation")[0] + temb
    return linear(p, "head.head.", layer_norm(x, eps) * (1 + mod[1]) + mod[0])


# --- one pass, one step -------------------------------------------------------------

def dual_tower_pass(cfg: dict, video: Params, audio: Params, bridge: Params,
                    model_in: torch.Tensor, alat: torch.Tensor, ctx: torch.Tensor,
                    t: float, at: float, tables) -> Tuple[torch.Tensor, torch.Tensor]:
    """(video prediction [out, F, H, W], audio prediction [out, T]) in fp32
    for one pass: model_in [36, F, H, W], alat [128, T], ctx [L, text_dim]."""
    vc, ac, bc = cfg["video_dit"], cfg["audio_dit"], cfg["bridge"]
    dev = model_in.device
    pt, ph, pw = vc["patch_size"]
    vx = F.conv3d(model_in[None], video("patch_embedding.weight"),
                  video("patch_embedding.bias"), stride=(pt, ph, pw))[0]
    f, h, w = vx.shape[1:]
    vx = vx.reshape(vc["dim"], -1).t().contiguous()
    ax = F.conv1d(alat[None], audio("patch_embedding.weight"), audio("patch_embedding.bias"),
                  stride=ac["patch_size"])[0].t().contiguous()
    v_temb, v_tmod = time_embeds(video, t, vc["freq_dim"], vc["dim"], dev)
    a_temb, a_tmod = time_embeds(audio, at, ac["freq_dim"], ac["dim"], dev)
    v_ctx, a_ctx = text_embed(video, ctx), text_embed(audio, ctx)
    shared = min(bc["visual_layers"], bc["audio_layers"])
    interact = set(rope.interaction_layers(bc["interaction_strategy"], shared))
    vh, ah = vc["num_heads"], ac["num_heads"]
    for layer in range(vc["num_layers"]):
        if layer < shared:
            if layer in interact:
                dv = conditioner(bridge, f"audio_to_video_conditioners.{layer}.", vx, ax,
                                 tables["cross_v"], tables["cross_a"],
                                 bc["visual_hidden_dim"] // bc["head_dim"], bc["eps"])
                da = conditioner(bridge, f"video_to_audio_conditioners.{layer}.", ax, vx,
                                 tables["cross_a"], tables["cross_v"],
                                 bc["audio_hidden_dim"] // bc["head_dim"], bc["eps"])
                vx, ax = vx + dv, ax + da
            vx = dit_block(video, f"blocks.{layer}.", vx, v_ctx, v_tmod, tables["v"], vh,
                           vc["eps"])
            ax = dit_block(audio, f"blocks.{layer}.", ax, a_ctx, a_tmod, tables["a"], ah,
                           ac["eps"])
        else:
            vx = dit_block(video, f"blocks.{layer}.", vx, v_ctx, v_tmod, tables["v"], vh,
                           vc["eps"])
    vo = head(video, vx, v_temb, vc["eps"])
    out = vc["out_dim"]
    vo = vo.reshape(f, h, w, pt, ph, pw, out).permute(6, 0, 3, 1, 4, 2, 5)
    vo = vo.reshape(out, f * pt, h * ph, w * pw)
    ao = head(audio, ax, a_temb, ac["eps"])
    ao = ao.reshape(ax.shape[0], ac["patch_size"], ac["out_dim"]).permute(2, 0, 1)
    return vo, ao.reshape(ac["out_dim"], -1)


def step_update(cfg: dict, video: Params, audio: Params, bridge: Params,
                lat: torch.Tensor, alat: torch.Tensor, condition: torch.Tensor,
                ctx_pos: torch.Tensor, ctx_neg: torch.Tensor, t: float, at: float,
                d_sigma_v: float, d_sigma_a: float, cfg_scale: float,
                neg_state=None):
    """(video update [16, F, H, W], audio update [128, T], the negative
    prediction (video, audio) or None, the positive prediction (video,
    audio)) of one step from latents `lat`,
    `alat`: the positive pass, the negative pass, the text CFG combine
    v_neg + s (v_pos - v_neg), times the sigma step. `neg_state`:
    (latents, audio latents, t, at) of the step whose negative prediction
    this step reuses (a cached negative); the negative pass runs there, else
    at this step's own inputs."""
    tables = rope.tables(cfg, lat.shape[1:], alat.shape[-1], lat.device)
    v_pos, a_pos = dual_tower_pass(cfg, video, audio, bridge, torch.cat([lat, condition]),
                                   alat, ctx_pos, t, at, tables)
    neg, v, a = None, v_pos, a_pos
    if cfg_scale != 1.0:
        nl, na, nt, nat = neg_state if neg_state is not None else (lat, alat, t, at)
        neg = dual_tower_pass(cfg, video, audio, bridge, torch.cat([nl, condition]), na,
                              ctx_neg, nt, nat, tables)
        v = neg[0] + cfg_scale * (v_pos - neg[0])
        a = neg[1] + cfg_scale * (a_pos - neg[1])
    return v * d_sigma_v, a * d_sigma_a, neg, (v_pos, a_pos)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def frame_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 gap over the latent frames (axis 1)."""
    return max(rel_l2(got[:, i], want[:, i]) for i in range(want.shape[1]))


def isfinite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)

