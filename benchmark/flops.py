"""The work of a MOVA pass, counted from a configuration and a cell's shapes,
and the least time an H100 could take for it.

Model FLOPs cover the towers and the bridge: every linear (2 * tokens * in
* out on the tokens it reads), every attention's two products (4 * Sq * Sk
* width), the patch embeddings and the heads. Norms, RoPE, modulation and
the other elementwise work are not counted. A bound is the larger of the
operations at the bf16 tensor-core peak and the bytes at the HBM peak
(the H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s), said with
which of the two binds and beside the card's power limit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
HEAD_DIM = 128
# the attention dispatch's gate: queries this long or longer (at head_dim 128)
# take the flash kernels, shorter ones plain attention
FLASH_MIN_SEQ = 256


class AttnCall(NamedTuple):
    name: str
    heads: int
    sq: int
    sk: int


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, "operations" or "bytes": which peak binds)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_fwd_bound(call: AttnCall, batch: int = 1, lse: bool = False):
    """The forward's least time: bf16 q, k, v read and o written once (the
    fp32 LSE too where it is written) against 4 * Sq * Sk * D flops."""
    b, n, d = batch, call.heads, HEAD_DIM
    nbytes = 2 * b * n * d * (2 * call.sq + 2 * call.sk) + (4 * b * n * call.sq if lse else 0)
    return bound(4 * b * n * call.sq * call.sk * d, nbytes)


def attention_bwd_bound(call: AttnCall, batch: int = 1):
    """The backward's least time (the fused kernel with its delta
    preprocess): q, k, v, o and dO read and dq, dk, dv written once in bf16,
    the fp32 LSE read and the fp32 delta written once, against 2.5 times the
    forward's flops (its five products to the forward's two)."""
    b, n, d = batch, call.heads, HEAD_DIM
    nbytes = 2 * b * n * d * (4 * call.sq + 4 * call.sk) + 8 * b * n * call.sq
    return bound(10 * b * n * call.sq * call.sk * d, nbytes)


def geometry(cfg: dict, traffic: dict) -> dict:
    """Token counts of a generation: video tokens f*h*w after the VAE's
    strides and the patch, audio tokens of the DAC latent, text tokens."""
    vae, vc = cfg["video_vae"], cfg["video_dit"]
    frames = (traffic["num_frames"] - 1) // vae["scale_factor_temporal"] + 1
    lh = traffic["height"] // vae["scale_factor_spatial"]
    lw = traffic["width"] // vae["scale_factor_spatial"]
    pt, ph, pw = vc["patch_size"]
    samples = int(cfg["audio_vae"]["sample_rate"] * traffic["num_frames"] / traffic["video_fps"])
    hop = 1
    for r in cfg["audio_vae"]["encoder_rates"]:
        hop *= r
    audio_t = (samples - 1) // hop + 1
    return {"latent": (frames, lh, lw), "video": (frames // pt) * (lh // ph) * (lw // pw),
            "audio": audio_t // cfg["audio_dit"]["patch_size"], "audio_t": audio_t,
            "text": traffic["text_tokens"]}


def _shared(cfg: dict) -> int:
    bc = cfg["bridge"]
    return min(bc["visual_layers"], bc["audio_layers"])


def attention_calls(cfg: dict, geo: dict) -> List[AttnCall]:
    """Every attention call of one pass, in order."""
    from benchmark.reference.rope import interaction_layers

    vc, ac, bc = cfg["video_dit"], cfg["audio_dit"], cfg["bridge"]
    sv, sa, st = geo["video"], geo["audio"], geo["text"]
    vh, ah = vc["num_heads"], ac["num_heads"]
    shared = _shared(cfg)
    interact = set(interaction_layers(bc["interaction_strategy"], shared))
    calls = []
    for layer in range(vc["num_layers"]):
        if layer < shared and layer in interact:
            calls += [AttnCall("a2v_bridge", bc["visual_hidden_dim"] // bc["head_dim"], sv, sa),
                      AttnCall("v2a_bridge", bc["audio_hidden_dim"] // bc["head_dim"], sa, sv)]
        calls += [AttnCall("video_self", vh, sv, sv), AttnCall("video_text_cross", vh, sv, st)]
        if layer < shared:
            calls += [AttnCall("audio_self", ah, sa, sa), AttnCall("audio_text_cross", ah, sa, st)]
    return calls


def kernel_calls(cfg: dict, geo: dict) -> List[AttnCall]:
    """The calls of one pass that the flash kernels take (the dispatch's gate)."""
    return [c for c in attention_calls(cfg, geo) if c.sq >= FLASH_MIN_SEQ]


class Linear(NamedTuple):
    """One matrix product of a pass: `tokens` rows through an [in, out]
    weight. `lora`: a LoRA target (the q, k, v and o of the blocks' and the
    bridge's attentions). `grad_input`: training needs its input gradient
    (its input lies downstream of a LoRA factor: not the text context, not
    the embeddings' inputs, not the bridge's first interaction layer)."""
    tokens: int
    din: int
    dout: int
    lora: bool
    grad_input: bool


def _tower_linears(tc: dict, tokens: int, text: int, layers: int, patch_in: int,
                   head_out: int, grad_from: int) -> List[Linear]:
    """A tower's products: the patch, text and time embeddings (one token),
    its blocks, its head. Blocks from `grad_from` on take input gradients."""
    d, ffn = tc["dim"], tc["ffn_dim"]
    out = [Linear(tokens, patch_in, d, False, False),
           Linear(text, tc["text_dim"], d, False, False), Linear(text, d, d, False, False),
           Linear(1, tc["freq_dim"], d, False, False), Linear(1, d, d, False, False),
           Linear(1, d, 6 * d, False, False)]
    for layer in range(layers):
        g = layer >= grad_from
        out += [Linear(tokens, d, d, True, g) for _ in range(3)]       # self q, k, v
        out += [Linear(tokens, d, d, True, True) for _ in range(3)]    # self o, cross q, o
        out += [Linear(text, d, d, True, False) for _ in range(2)]     # cross k, v on the text
        out += [Linear(tokens, d, ffn, False, True), Linear(tokens, ffn, d, False, True)]
    return out + [Linear(tokens, d, head_out, False, True)]


def _conditioner(sq: int, sk: int, dq: int, dk: int, first: bool) -> List[Linear]:
    """One side of the bridge: q on its own tokens, k and v on the other
    tower's, o back; `first`: at layer 0, where q, k and v read states no
    factor has touched."""
    return [Linear(sq, dq, dq, True, not first), Linear(sk, dk, dq, True, not first),
            Linear(sk, dk, dq, True, not first), Linear(sq, dq, dq, True, True)]


def pass_linears(cfg: dict, geo: dict) -> List[Linear]:
    """Every matrix product of one pass: the video expert, the audio tower,
    the bridge."""
    from benchmark.reference.rope import interaction_layers

    vc, ac, bc = cfg["video_dit"], cfg["audio_dit"], cfg["bridge"]
    sv, sa, st = geo["video"], geo["audio"], geo["text"]
    pt, ph, pw = vc["patch_size"]
    layers = interaction_layers(bc["interaction_strategy"], _shared(cfg))
    # the first block's self q, k, v read states no factor has touched, unless
    # the bridge's first interaction (whose own q, k, v do) comes before it
    at_zero = 0 in layers
    grad_from = 0 if at_zero else 1
    out = _tower_linears(vc, sv, st, vc["num_layers"], vc["in_dim"] * pt * ph * pw,
                         vc["out_dim"] * pt * ph * pw, grad_from)
    out += _tower_linears(ac, sa, st, ac["num_layers"], ac["in_dim"] * ac["patch_size"],
                          ac["out_dim"] * ac["patch_size"], grad_from)
    vd, ad = bc["visual_hidden_dim"], bc["audio_hidden_dim"]
    for layer in layers:
        out += _conditioner(sv, sa, vd, ad, layer == 0)       # a2v
        out += _conditioner(sa, sv, ad, vd, layer == 0)       # v2a
    return out


def attention_flops(calls: List[AttnCall]) -> float:
    """The two products of each call: 4 * Sq * Sk * heads * head_dim."""
    return sum(4 * c.sq * c.sk * c.heads * HEAD_DIM for c in calls)


def pass_flops(cfg: dict, geo: dict) -> float:
    """Model FLOPs of one pass: the video expert, the audio tower, the
    bridge: every product of `pass_linears` and of `attention_calls`."""
    return (sum(2 * m.tokens * m.din * m.dout for m in pass_linears(cfg, geo))
            + attention_flops(attention_calls(cfg, geo)))


def video_layer_flops(cfg: dict, geo: dict) -> float:
    """One video block at this geometry: its products and its attentions."""
    vc = cfg["video_dit"]
    one = dict(vc, num_layers=1)
    linears = _tower_linears(one, geo["video"], geo["text"], 1, 0, 0, 0)[6:-1]
    calls = [c for c in attention_calls(dict(cfg, video_dit=one), geo)
             if c.name.startswith("video")]
    return sum(2 * m.tokens * m.din * m.dout for m in linears) + attention_flops(calls)


def train_step_flops(cfg: dict, geo: dict, rank: int) -> float:
    """Model FLOPs of one LoRA training step on one clip: the pass; the
    input gradients of the products that need them; each LoRA target's
    weight gradient (2 * tokens * in * out, which the merged weight's
    backward computes) and its factors' (the merge and its two gradients,
    6 * in * out * r); attention's backward at 2.5 times its forward. The
    recompute of rematerialised layers is not counted, nor the encoders."""
    linears = pass_linears(cfg, geo)
    fwd = pass_flops(cfg, geo)
    dx = sum(2 * m.tokens * m.din * m.dout for m in linears if m.grad_input)
    dw = sum(2 * m.tokens * m.din * m.dout + 6 * m.din * m.dout * rank
             for m in linears if m.lora)
    return fwd + dx + dw + 2.5 * attention_flops(attention_calls(cfg, geo))
