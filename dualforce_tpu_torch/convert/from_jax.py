"""Carry the JAX package's weights into the port's modules.

The JAX parameter tree arrives as nested dicts of numpy arrays (stacked
[L, ...] block trees included). `state_dicts` maps it onto the MOVA/HF
state-dict names the port's modules carry: for the DiTs and the bridge this
is the key map of the JAX package's `convert/torch_export.py`, kept here as
its own copy; for UMT5, the Wan VAE and DAC it inverts the JAX package's
converters (`models/umt5.convert_umt5`, `convert/load_checkpoint._convert_wan_vae`,
`convert/torch_import.convert_dac`). `load` loads them with strict=True, so
no key may be missing or extra. `lora` carries a JAX LoRA tree (factors
stacked per layer, `engine/lora.init_pipeline_lora`) into the port's LoRA.
Leaves that `cast_tree_fp8` stored in fp8 (ml_dtypes' float8 arrays) stay
fp8, byte for byte; every other float leaf is read as fp32.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dualforce_tpu_torch.config import (AudioDiTConfig, BridgeConfig, DACVAEConfig,
                                        MOVAConfig, UMT5Config, VideoDiTConfig,
                                        WanVAEConfig)
from dualforce_tpu_torch.engine import lora as lora_mod

Array = np.ndarray
StateDict = Dict[str, Array]
# ml_dtypes' float8 dtypes, by name (the port does not import ml_dtypes)
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _np32(x) -> Array:
    """A float leaf as fp32, or as it is if it is fp8."""
    x = np.asarray(x)
    return x if x.dtype.name in _FP8 else x.astype(np.float32)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# --- DiTs and bridge: the key map of torch_export.py -----------------------

def _lin(sd: StateDict, prefix: str, p) -> None:
    """A linear, or one quantized by the JAX package's `quantize_tree_int8`
    (`kernel_q` [in, out] int8, `kernel_scale` [1, out]) or
    `quantize_tree_int4` (`kernel_q4` [in/2, out] uint8, `kernel_scale4`
    [in/group, out]), into the port's `nn.Linear`, `Int8Linear` or
    `Int4Linear` names and [out, ...] layouts."""
    if "kernel_q" in p:
        sd[f"{prefix}.weight_q"] = np.asarray(p["kernel_q"]).T
        sd[f"{prefix}.weight_scale"] = _np32(p["kernel_scale"]).reshape(-1)
    elif "kernel_q4" in p:
        sd[f"{prefix}.weight_q4"] = np.asarray(p["kernel_q4"]).T
        sd[f"{prefix}.weight_scale4"] = _np32(p["kernel_scale4"]).T
    else:
        sd[f"{prefix}.weight"] = _np32(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np32(p["bias"])


def _ln(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _np32(p["scale"])
    sd[f"{prefix}.bias"] = _np32(p["bias"])


def _attn(sd: StateDict, prefix: str, p) -> None:
    for name in ("q", "k", "v", "o"):
        _lin(sd, f"{prefix}.{name}", p[name])
    sd[f"{prefix}.norm_q.weight"] = _np32(p["norm_q"]["scale"])
    sd[f"{prefix}.norm_k.weight"] = _np32(p["norm_k"]["scale"])


def _dit_block(sd: StateDict, prefix: str, p) -> None:
    _attn(sd, f"{prefix}.self_attn", p["self_attn"])
    _attn(sd, f"{prefix}.cross_attn", p["cross_attn"])
    _ln(sd, f"{prefix}.norm3", p["norm3"])
    _lin(sd, f"{prefix}.ffn.0", p["ffn"]["fc1"])
    _lin(sd, f"{prefix}.ffn.2", p["ffn"]["fc2"])
    sd[f"{prefix}.modulation"] = _np32(p["modulation"])


def _tower(params, num_layers: int, patch_weight: Array) -> StateDict:
    sd: StateDict = {}
    _lin(sd, "text_embedding.0", params["text_embedding"]["fc1"])
    _lin(sd, "text_embedding.2", params["text_embedding"]["fc2"])
    _lin(sd, "time_embedding.0", params["time_embedding"]["fc1"])
    _lin(sd, "time_embedding.2", params["time_embedding"]["fc2"])
    _lin(sd, "time_projection.1", params["time_projection"]["fc"])
    _lin(sd, "head.head", params["head"]["head"])
    sd["head.modulation"] = _np32(params["head"]["modulation"])
    sd["patch_embedding.weight"] = patch_weight
    sd["patch_embedding.bias"] = _np32(params["patch_embedding"]["bias"])
    for i in range(num_layers):
        _dit_block(sd, f"blocks.{i}", _unstack(params["blocks"], i))
    return sd


def video_dit_state_dict(params, cfg: VideoDiTConfig) -> StateDict:
    pt, ph, pw = cfg.patch_size
    k = _np32(params["patch_embedding"]["kernel"])  # [c*pt*ph*pw, dim]
    w = k.reshape(cfg.in_dim, pt, ph, pw, -1).transpose(4, 0, 1, 2, 3)
    return _tower(params, cfg.num_layers, w)


def audio_dit_state_dict(params, cfg: AudioDiTConfig) -> StateDict:
    k = _np32(params["patch_embedding"]["kernel"])  # [c*p, dim]
    w = k.reshape(cfg.in_dim, cfg.patch_size, -1).transpose(2, 0, 1)
    return _tower(params, cfg.num_layers, w)


def bridge_state_dict(params, cfg: BridgeConfig) -> StateDict:
    sd: StateDict = {}
    for pos, layer in enumerate(cfg.interaction_layers()):
        for name, key in (("audio_to_video_conditioners", "a2v"),
                          ("video_to_audio_conditioners", "v2a")):
            p = _unstack(params[key], pos)
            _ln(sd, f"{name}.{layer}.y_norm", p["y_norm"])
            _attn(sd, f"{name}.{layer}.inner", p["inner"])
            if "pool" in p:
                pool, pre = p["pool"], f"{name}.{layer}.per_frame_pooling"
                sd[f"{pre}.probe"] = _np32(pool["probe"])
                sd[f"{pre}.attention.in_proj_weight"] = _np32(pool["in_proj"]["kernel"]).T
                sd[f"{pre}.attention.in_proj_bias"] = _np32(pool["in_proj"]["bias"])
                _lin(sd, f"{pre}.attention.out_proj", pool["out_proj"])
                _ln(sd, f"{pre}.layernorm", pool["ln"])
                _lin(sd, f"{name}.{layer}.adaln.linear", p["adaln"]["linear"])
    if "condition_scale" in params:
        sd["condition_scale"] = _np32(params["condition_scale"])
    return sd


# --- UMT5: inverse of umt5.convert_umt5 ------------------------------------

def umt5_state_dict(params, cfg: UMT5Config) -> StateDict:
    sd: StateDict = {"shared.weight": _np32(params["embed"]),
                     "encoder.final_layer_norm.weight": _np32(params["final_ln"]["scale"])}
    for i in range(cfg.num_layers):
        p = _unstack(params["layers"], i)
        pre = f"encoder.block.{i}.layer"
        for n in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{n}.weight"] = _np32(p["attn"][n]["kernel"]).T
        sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = \
            _np32(p["attn"]["rel_bias"])
        sd[f"{pre}.0.layer_norm.weight"] = _np32(p["ln1"]["scale"])
        for n in ("wi_0", "wi_1", "wo"):
            sd[f"{pre}.1.DenseReluDense.{n}.weight"] = _np32(p["mlp"][n]["kernel"]).T
        sd[f"{pre}.1.layer_norm.weight"] = _np32(p["ln2"]["scale"])
    return sd


# --- Wan VAE: inverse of load_checkpoint._convert_wan_vae -------------------

def wan_vae_state_dict(params, cfg: WanVAEConfig) -> StateDict:
    sd: StateDict = {}

    def conv(prefix, p, conv2d: bool = False):
        k = _np32(p["kernel"])                         # [t, h, w, i, o]
        sd[f"{prefix}.weight"] = (k[0].transpose(3, 2, 0, 1) if conv2d
                                  else k.transpose(4, 3, 0, 1, 2))
        sd[f"{prefix}.bias"] = _np32(p["bias"])

    def norm(prefix, p, images: bool = False):
        shape = (-1, 1, 1) if images else (-1, 1, 1, 1)
        sd[f"{prefix}.gamma"] = _np32(p["gamma"]).reshape(shape)
        if "bias" in p:
            sd[f"{prefix}.bias"] = _np32(p["bias"]).reshape(shape)

    def res_block(prefix, p):
        norm(f"{prefix}.residual.0", p["norm1"])
        conv(f"{prefix}.residual.2", p["conv1"])
        norm(f"{prefix}.residual.3", p["norm2"])
        conv(f"{prefix}.residual.6", p["conv2"])
        if "shortcut" in p:
            conv(f"{prefix}.shortcut", p["shortcut"])

    def middle(prefix, p):
        res_block(f"{prefix}.0", p["rb1"])
        norm(f"{prefix}.1.norm", p["attn"]["norm"], images=True)
        conv(f"{prefix}.1.to_qkv", p["attn"]["to_qkv"], conv2d=True)
        conv(f"{prefix}.1.proj", p["attn"]["proj"], conv2d=True)
        res_block(f"{prefix}.2", p["rb2"])

    def stages(prefix, stage_list, resample_key):
        idx = 0
        for stage in stage_list:
            for bp in stage["blocks"]:
                res_block(f"{prefix}.{idx}", bp)
                idx += 1
            if resample_key in stage:
                rp = stage[resample_key]
                conv(f"{prefix}.{idx}.resample.1", rp["conv"], conv2d=True)
                if "time_conv" in rp:
                    conv(f"{prefix}.{idx}.time_conv", rp["time_conv"])
                idx += 1

    enc, dec = params["encoder"], params["decoder"]
    conv("encoder.conv1", enc["conv1"])
    stages("encoder.downsamples", enc["stages"], "down")
    middle("encoder.middle", enc["mid"])
    norm("encoder.head.0", enc["head_norm"])
    conv("encoder.head.2", enc["head_conv"])
    conv("decoder.conv1", dec["conv1"])
    middle("decoder.middle", dec["mid"])
    stages("decoder.upsamples", dec["stages"], "up")
    norm("decoder.head.0", dec["head_norm"])
    conv("decoder.head.2", dec["head_conv"])
    conv("quant_conv", params["quant_conv"])
    conv("post_quant_conv", params["post_quant_conv"])
    return sd


# --- DAC: inverse of torch_import.convert_dac (weight norm already folded) ---

def dac_state_dict(params, cfg: DACVAEConfig) -> StateDict:
    sd: StateDict = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = _np32(p["kernel"]).transpose(2, 1, 0)   # [k,i,o] -> [o,i,k]
        sd[f"{prefix}.bias"] = _np32(p["bias"])

    def conv_t(prefix, p):
        # pre-flipped [k, in, out] -> torch ConvTranspose1d [in, out, k]
        w = _np32(p["kernel"]).transpose(1, 2, 0)[:, :, ::-1]
        sd[f"{prefix}.weight"] = np.ascontiguousarray(w)
        sd[f"{prefix}.bias"] = _np32(p["bias"])

    def snake(prefix, p):
        sd[f"{prefix}.alpha"] = _np32(p["alpha"]).reshape(1, -1, 1)

    def unit(prefix, p):
        snake(f"{prefix}.block.0", p["snake1"])
        conv(f"{prefix}.block.1", p["conv1"])
        snake(f"{prefix}.block.2", p["snake2"])
        conv(f"{prefix}.block.3", p["conv2"])

    enc, dec = params["encoder"], params["decoder"]
    n_enc, n_dec = len(enc["blocks"]), len(dec["blocks"])
    conv("encoder.block.0", enc["conv_in"])
    for i, b in enumerate(enc["blocks"]):
        pre = f"encoder.block.{1 + i}.block"
        for j, ru in enumerate(("ru1", "ru2", "ru3")):
            unit(f"{pre}.{j}", b[ru])
        snake(f"{pre}.3", b["snake"])
        conv(f"{pre}.4", b["down"])
    snake(f"encoder.block.{1 + n_enc}", enc["snake_out"])
    conv(f"encoder.block.{2 + n_enc}", enc["conv_out"])
    conv("decoder.model.0", dec["conv_in"])
    for i, b in enumerate(dec["blocks"]):
        pre = f"decoder.model.{1 + i}.block"
        snake(f"{pre}.0", b["snake"])
        conv_t(f"{pre}.1", b["up"])
        for j, ru in enumerate(("ru1", "ru2", "ru3")):
            unit(f"{pre}.{2 + j}", b[ru])
    snake(f"decoder.model.{1 + n_dec}", dec["snake_out"])
    conv(f"decoder.model.{2 + n_dec}", dec["conv_out"])
    if "quantizer" in params:
        for i, q in enumerate(params["quantizer"]):
            pre = f"quantizer.quantizers.{i}"
            conv(f"{pre}.in_proj", q["in_proj"])
            conv(f"{pre}.out_proj", q["out_proj"])
            sd[f"{pre}.codebook.weight"] = _np32(q["codebook"])
    else:
        conv("quant_conv", params["quant_conv"])
        conv("post_quant_conv", params["post_quant_conv"])
    return sd


def state_dicts(params: Dict[str, Any], cfg: MOVAConfig) -> Dict[str, StateDict]:
    """Per-module state dicts for every module present in `params`."""
    makers = {
        "video_dit": lambda p: video_dit_state_dict(p, cfg.video_dit),
        "video_dit_2": lambda p: video_dit_state_dict(p, cfg.video_dit),
        "audio_dit": lambda p: audio_dit_state_dict(p, cfg.audio_dit),
        "bridge": lambda p: bridge_state_dict(p, cfg.bridge),
        "text_encoder": lambda p: umt5_state_dict(p, cfg.text_encoder),
        "video_vae": lambda p: wan_vae_state_dict(p, cfg.video_vae),
        "audio_vae": lambda p: dac_state_dict(p, cfg.audio_vae),
    }
    return {name: makers[name](p) for name, p in params.items() if p is not None}


def _tensor(x) -> torch.Tensor:
    """Integer leaves (quantized weights) and fp8 ones as they are, the rest
    as fp32. `torch.from_numpy` takes no float8 array, so an fp8 leaf goes
    over as its bytes."""
    x = np.asarray(x)
    if x.dtype.name in _FP8:
        return torch.from_numpy(np.ascontiguousarray(x).view(np.uint8)).view(_FP8[x.dtype.name])
    return torch.from_numpy(np.array(x, x.dtype if np.issubdtype(x.dtype, np.integer)
                                     else np.float32))


def load(modules: Dict[str, torch.nn.Module], params: Dict[str, Any],
         cfg: MOVAConfig) -> None:
    """Load the JAX tree into `modules` (same keys) with strict=True; each
    parameter keeps its module's dtype and device. A tower tree quantized by
    the JAX package loads into the port's quantized modules
    (`nn.quantize_modules`)."""
    sds = state_dicts(params, cfg)
    if set(sds) != set(modules):
        raise KeyError(f"modules {sorted(modules)} != params {sorted(sds)}")
    for name, module in modules.items():
        module.load_state_dict({k: _tensor(v) for k, v in sds[name].items()}, strict=True)


def lora(tree: Dict[str, Any], cfg: MOVAConfig) -> lora_mod.Lora:
    """The JAX package's LoRA tree ({module: {path: {a: [L, in, r], b:
    [L, r, out]}}}) as the port's LoRA: per-layer fp32 factors on the host,
    keyed by the port's weight names, leaves that require grad."""
    return lora_mod.from_stacked(tree, cfg.bridge.interaction_layers())
