"""The MOVA state-dict layout (parameter names and shapes) of the denoise
modules, as the published checkpoints name them: `video_dit` and
`video_dit_2` (the two Wan video experts), `audio_dit`, `bridge`
(`dual_tower_bridge`). Linear weights are [out, in], patch embeddings their
Conv weights."""

from __future__ import annotations

from typing import Dict, Tuple

Shapes = Dict[str, Tuple[int, ...]]


def _linear(out: Shapes, prefix: str, din: int, dout: int) -> None:
    out[prefix + "weight"] = (dout, din)
    out[prefix + "bias"] = (dout,)


def _attention(out: Shapes, prefix: str, dim: int, kv_dim: int) -> None:
    for name, din in (("q", dim), ("k", kv_dim), ("v", kv_dim), ("o", dim)):
        _linear(out, f"{prefix}{name}.", din, dim)
    out[prefix + "norm_q.weight"] = (dim,)
    out[prefix + "norm_k.weight"] = (dim,)


def tower(tc: dict, video: bool) -> Shapes:
    """A DiT tower: patch, text and time embeddings, the blocks, the head."""
    dim = tc["dim"]
    out: Shapes = {}
    if video:
        out["patch_embedding.weight"] = (dim, tc["in_dim"], *tc["patch_size"])
        head_out = tc["out_dim"] * tc["patch_size"][0] * tc["patch_size"][1] * tc["patch_size"][2]
    else:
        out["patch_embedding.weight"] = (dim, tc["in_dim"], tc["patch_size"])
        head_out = tc["out_dim"] * tc["patch_size"]
    out["patch_embedding.bias"] = (dim,)
    _linear(out, "text_embedding.0.", tc["text_dim"], dim)
    _linear(out, "text_embedding.2.", dim, dim)
    _linear(out, "time_embedding.0.", tc["freq_dim"], dim)
    _linear(out, "time_embedding.2.", dim, dim)
    _linear(out, "time_projection.1.", dim, 6 * dim)
    for i in range(tc["num_layers"]):
        p = f"blocks.{i}."
        out[p + "modulation"] = (1, 6, dim)
        _attention(out, p + "self_attn.", dim, dim)
        _attention(out, p + "cross_attn.", dim, dim)
        out[p + "norm3.weight"] = (dim,)
        out[p + "norm3.bias"] = (dim,)
        _linear(out, p + "ffn.0.", dim, tc["ffn_dim"])
        _linear(out, p + "ffn.2.", tc["ffn_dim"], dim)
    out["head.modulation"] = (1, 2, dim)
    _linear(out, "head.head.", dim, head_out)
    return out


def bridge(bc: dict, layers) -> Shapes:
    """The bridge's a2v and v2a conditioners at the interacting layers."""
    vd, ad = bc["visual_hidden_dim"], bc["audio_hidden_dim"]
    if bc.get("pooled_adaln") or bc.get("trainable_condition_scale"):
        raise ValueError("the reference has the plain bridge only")
    out: Shapes = {}
    for i in layers:
        for name, dim, kv in (("audio_to_video_conditioners", vd, ad),
                              ("video_to_audio_conditioners", ad, vd)):
            p = f"{name}.{i}."
            out[p + "y_norm.weight"] = (kv,)
            out[p + "y_norm.bias"] = (kv,)
            _attention(out, p + "inner.", dim, kv)
    return out


def denoise_modules(cfg: dict) -> Dict[str, Shapes]:
    """{module: {name: shape}} of the modules a denoise step reads."""
    from benchmark.reference.rope import interaction_layers

    bc = cfg["bridge"]
    shared = min(bc["visual_layers"], bc["audio_layers"])
    out = {"video_dit": tower(cfg["video_dit"], True)}
    if cfg.get("two_video_towers", True):
        out["video_dit_2"] = tower(cfg["video_dit"], True)
    out["audio_dit"] = tower(cfg["audio_dit"], False)
    out["bridge"] = bridge(bc, interaction_layers(bc["interaction_strategy"], shared))
    return out


def umt5(tc: dict) -> Shapes:
    """The UMT5 encoder as HF's `UMT5EncoderModel` names it."""
    d, inner, ff = tc["d_model"], tc["num_heads"] * tc["d_kv"], tc["d_ff"]
    out: Shapes = {"shared.weight": (tc["vocab_size"], d)}
    for i in range(tc["num_layers"]):
        a = f"encoder.block.{i}.layer.0."
        for name in ("q", "k", "v"):
            out[f"{a}SelfAttention.{name}.weight"] = (inner, d)
        out[a + "SelfAttention.o.weight"] = (d, inner)
        out[a + "SelfAttention.relative_attention_bias.weight"] = (
            tc["relative_attention_num_buckets"], tc["num_heads"])
        out[a + "layer_norm.weight"] = (d,)
        f = f"encoder.block.{i}.layer.1."
        out[f + "DenseReluDense.wi_0.weight"] = (ff, d)
        out[f + "DenseReluDense.wi_1.weight"] = (ff, d)
        out[f + "DenseReluDense.wo.weight"] = (d, ff)
        out[f + "layer_norm.weight"] = (d,)
    out["encoder.final_layer_norm.weight"] = (d,)
    return out


def _conv(out: Shapes, prefix: str, cout: int, cin: int, *kernel: int) -> None:
    out[prefix + "weight"] = (cout, cin, *kernel)
    out[prefix + "bias"] = (cout,)


def _wan_residual(out: Shapes, prefix: str, cin: int, cout: int) -> None:
    out[prefix + "residual.0.gamma"] = (cin, 1, 1, 1)
    _conv(out, prefix + "residual.2.", cout, cin, 3, 3, 3)
    out[prefix + "residual.3.gamma"] = (cout, 1, 1, 1)
    _conv(out, prefix + "residual.6.", cout, cout, 3, 3, 3)
    if cin != cout:
        _conv(out, prefix + "shortcut.", cout, cin, 1, 1, 1)


def wan_encoder(vc: dict) -> Shapes:
    """The Wan 2.x VAE's encoder and quant conv, as its checkpoint names them
    (the decoder is not read by an encode)."""
    dims = [vc["base_dim"] * m for m in [1] + list(vc["dim_mult"])]
    out: Shapes = {}
    _conv(out, "encoder.conv1.", dims[0], 3, 3, 3, 3)
    i = 0
    stages = len(vc["dim_mult"])
    for stage in range(stages):
        d = dims[stage]
        for _ in range(vc["num_res_blocks"]):
            _wan_residual(out, f"encoder.downsamples.{i}.", d, dims[stage + 1])
            d = dims[stage + 1]
            i += 1
        if stage != stages - 1:
            _conv(out, f"encoder.downsamples.{i}.resample.1.", d, d, 3, 3)
            if vc["temperal_downsample"][stage]:
                _conv(out, f"encoder.downsamples.{i}.time_conv.", d, d, 3, 1, 1)
            i += 1
    d = dims[-1]
    _wan_residual(out, "encoder.middle.0.", d, d)
    out["encoder.middle.1.norm.gamma"] = (d, 1, 1)
    _conv(out, "encoder.middle.1.to_qkv.", 3 * d, d, 1, 1)
    _conv(out, "encoder.middle.1.proj.", d, d, 1, 1)
    _wan_residual(out, "encoder.middle.2.", d, d)
    out["encoder.head.0.gamma"] = (d, 1, 1, 1)
    _conv(out, "encoder.head.2.", 2 * vc["z_dim"], d, 3, 3, 3)
    _conv(out, "quant_conv.", 2 * vc["z_dim"], 2 * vc["z_dim"], 1, 1, 1)
    return out


def dac_encoder(ac: dict) -> Shapes:
    """The DAC's encoder and quant conv (continuous mode), weight norm folded,
    as MOVA's DAC checkpoint names them."""
    d = ac["encoder_dim"]
    out: Shapes = {}
    _conv(out, "encoder.block.0.", d, 1, 7)
    for i, stride in enumerate(ac["encoder_rates"]):
        b = f"encoder.block.{i + 1}.block."
        for j in range(3):
            out[f"{b}{j}.block.0.alpha"] = (1, d, 1)
            _conv(out, f"{b}{j}.block.1.", d, d, 7)
            out[f"{b}{j}.block.2.alpha"] = (1, d, 1)
            _conv(out, f"{b}{j}.block.3.", d, d, 1)
        out[f"{b}3.alpha"] = (1, d, 1)
        _conv(out, f"{b}4.", 2 * d, d, 2 * stride)
        d *= 2
    n = len(ac["encoder_rates"])
    out[f"encoder.block.{n + 1}.alpha"] = (1, d, 1)
    _conv(out, f"encoder.block.{n + 2}.", ac["latent_dim"], d, 3)
    _conv(out, "quant_conv.", 2 * ac["latent_dim"], ac["latent_dim"], 1)
    return out


def train_modules(cfg: dict) -> Dict[str, Shapes]:
    """{module: {name: shape}} of what a training step reads: the denoise
    modules and the three encoders."""
    return {**denoise_modules(cfg), "text_encoder": umt5(cfg["text_encoder"]),
            "video_vae": wan_encoder(cfg["video_vae"]),
            "audio_vae": dac_encoder(cfg["audio_vae"])}
