"""Load MOVA checkpoints (the HF DiffusionPipeline directory layout) into the
port's modules (counterpart of `dualforce_tpu/convert/load_checkpoint.py`).

The layout: one directory per module (`video_dit`, `video_dit_2`,
`audio_dit`, `dual_tower_bridge`, `video_vae`, `audio_vae`, `text_encoder`,
`tokenizer`), each with a `config.json` and its weights as `*.safetensors`
shards (or a torch `.bin`/`.pt`/`.pth`), plus an optional `model_index.json`.

The port reads and writes the safetensors format itself: an 8-byte
little-endian header length, a JSON header naming each tensor's dtype, shape
and byte range, then the raw bytes. Each tensor is a view of the file mapped
copy-on-write (copied where its offset is not aligned to its element size),
so no shard is read into memory whole, and BF16 and F8 files read as well
as F32 ones.

The port's modules carry the MOVA/HF state-dict names, so most tensors load
under their own names. The exceptions are those the JAX package's converters
make: UMT5's embedding may be stored as `encoder.embed_tokens.weight`; the
Wan VAE's norm gammas come in any shape, a per-channel norm `bias` builds the
VAE with biased norms (`WanVAE(norm_bias=True)`; a norm given none gets
zeros) while a scalar one is dropped, as the JAX loader reads them, and an
absent `quant_conv`/`post_quant_conv` is the identity; the DAC's
weight-normed convolutions (`weight_g`, `weight_v`, norm over axes 1 and 2,
ConvTranspose1d keeping its input-channel axis) are folded in fp32. A
parameter the checkpoint lacks raises; tensors that no parameter takes are
listed on one log line, as the JAX converters ignore them.

Modules load one at a time, each tensor copied from the map straight into
its parameter in the module's dtype: the towers and UMT5 in `dtype`, the
VAEs in fp32. An fp8 `dtype` stores what `nn.fp8_stored` names in fp8 (cast
from fp32, clamped to the fp8 range), the rest in bf16, as
`nn.cast_modules_fp8` does. The JAX package's Orbax cache is not ported.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch import offload, resolve_device
from dualforce_tpu_torch.config import (AudioDiTConfig, BridgeConfig, DACVAEConfig,
                                        MOVAConfig, UMT5Config, VideoDiTConfig,
                                        WanVAEConfig)
from dualforce_tpu_torch.models.audio_dit import AudioDiT
from dualforce_tpu_torch.models.bridge import DualTowerBridge
from dualforce_tpu_torch.models.dac_vae import DACVAE
from dualforce_tpu_torch.models.umt5 import UMT5Encoder
from dualforce_tpu_torch.models.video_dit import VideoDiT
from dualforce_tpu_torch.models.wan_vae import WanVAE
from dualforce_tpu_torch.utils.misc import host_rss_gib

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
           "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}

# the pipeline's module keys -> (checkpoint directory, model class, its config)
MODULES: Dict[str, Tuple[str, type, Callable[[MOVAConfig], Any]]] = {
    "video_dit": ("video_dit", VideoDiT, lambda c: c.video_dit),
    "video_dit_2": ("video_dit_2", VideoDiT, lambda c: c.video_dit),
    "audio_dit": ("audio_dit", AudioDiT, lambda c: c.audio_dit),
    "bridge": ("dual_tower_bridge", DualTowerBridge, lambda c: c.bridge),
    "video_vae": ("video_vae", WanVAE, lambda c: c.video_vae),
    "audio_vae": ("audio_vae", DACVAE, lambda c: c.audio_vae),
    "text_encoder": ("text_encoder", UMT5Encoder, lambda c: c.text_encoder),
}
VAES = ("video_vae", "audio_vae")

StateDict = Dict[str, torch.Tensor]


# --- the safetensors format -------------------------------------------------

def read_safetensors(path: str) -> Tuple[StateDict, Dict[str, str]]:
    """(tensors, the header's `__metadata__`) of one safetensors file. Each
    tensor views the file, mapped copy-on-write; a tensor whose offset is
    not a multiple of its element size is copied."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    metadata = header.pop("__metadata__", None) or {}
    out: StateDict = {}
    for name, entry in header.items():
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, which the port "
                             f"does not read ({sorted(_DTYPES)})")
        dtype, shape = _DTYPES[entry["dtype"]], entry["shape"]
        begin, end = entry["data_offsets"]
        if end - begin != math.prod(shape) * dtype.itemsize or 8 + n + end > size:
            raise ValueError(f"{path}: {name}'s bytes [{begin}, {end}) do not hold "
                             f"{entry['dtype']} {shape}")
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = 8 + n + begin
        raw = torch.frombuffer(mapped, dtype=torch.uint8, count=end - begin, offset=offset)
        if offset % dtype.itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out, metadata


def _bytes(t: torch.Tensor):
    """A tensor's bytes in memory order, as a host numpy array."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()


def save_state_dict(sd: Mapping[str, torch.Tensor], path: str,
                    metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `sd` as one safetensors file (tensors of wider elements first,
    so every offset is aligned; header padded to 8 bytes). Returns the bytes
    of tensor data written."""
    items = sorted(sd.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: the safetensors writer takes {sorted(_NAMES, key=str)}, "
                             f"not {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(_bytes(t))
    return offset


def load_state_dict(module_dir: str) -> StateDict:
    """Every safetensors shard in a module directory, or else every torch
    `.bin`/`.pt`/`.pth` file (`torch.load(weights_only=True)`)."""
    files = sorted(os.listdir(module_dir))
    sd: StateDict = {}
    shards = [f for f in files if f.endswith(".safetensors")]
    if shards:
        for f in shards:
            sd.update(read_safetensors(os.path.join(module_dir, f))[0])
        return sd
    bins = [f for f in files if f.endswith((".bin", ".pt", ".pth"))]
    if bins:
        for f in bins:
            sd.update(torch.load(os.path.join(module_dir, f), map_location="cpu",
                                 weights_only=True))
        return sd
    raise FileNotFoundError(f"no weight files in {module_dir}")


# --- configs ----------------------------------------------------------------

def _read_config(module_dir: str) -> Dict[str, Any]:
    with open(os.path.join(module_dir, "config.json")) as f:
        return json.load(f)


def config_from_checkpoint(ckpt_dir: str) -> MOVAConfig:
    """The MOVAConfig of a checkpoint, from its modules' config.json files
    (the text encoder's and `model_index.json` optional)."""
    def mod(name):
        return _read_config(os.path.join(ckpt_dir, name))

    v = mod("video_dit")
    a = mod("audio_dit")
    b = mod("dual_tower_bridge")
    vv = mod("video_vae")
    av = mod("audio_vae")
    te_path = os.path.join(ckpt_dir, "text_encoder", "config.json")
    te: Dict[str, Any] = {}
    if os.path.exists(te_path):
        with open(te_path) as f:
            te = json.load(f)
    text_encoder = UMT5Config(
        vocab_size=te.get("vocab_size", 256384),
        d_model=te.get("d_model", 4096),
        d_kv=te.get("d_kv", 64),
        d_ff=te.get("d_ff", 10240),
        num_layers=te.get("num_layers", 24),
        num_heads=te.get("num_heads", 64),
        relative_attention_num_buckets=te.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=te.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=te.get("layer_norm_epsilon", 1e-6),
    )
    pipe_cfg: Dict[str, Any] = {}
    mi = os.path.join(ckpt_dir, "model_index.json")
    if os.path.exists(mi):
        with open(mi) as f:
            pipe_cfg = json.load(f)

    return MOVAConfig(
        video_dit=VideoDiTConfig(
            dim=v["dim"], in_dim=v["in_dim"], ffn_dim=v["ffn_dim"],
            out_dim=v["out_dim"], text_dim=v.get("text_dim", 4096),
            freq_dim=v.get("freq_dim", 256), eps=v.get("eps", 1e-6),
            patch_size=tuple(v["patch_size"]), num_heads=v["num_heads"],
            num_layers=v["num_layers"],
            rope_max_len=v.get("rope_max_len", 1024)),
        audio_dit=AudioDiTConfig(
            dim=a["dim"], in_dim=a["in_dim"], ffn_dim=a["ffn_dim"],
            out_dim=a["out_dim"], text_dim=a.get("text_dim", 4096),
            freq_dim=a.get("freq_dim", 256), eps=a.get("eps", 1e-6),
            patch_size=(a["patch_size"][0] if isinstance(a["patch_size"], (list, tuple))
                        else a["patch_size"]),
            num_heads=a["num_heads"], num_layers=a["num_layers"],
            vae_type=a.get("vae_type", "dac"),
            rope_max_len=a.get("rope_max_len", 8192)),
        bridge=BridgeConfig(
            visual_layers=b.get("visual_layers", v["num_layers"]),
            audio_layers=b.get("audio_layers", a["num_layers"]),
            visual_hidden_dim=b.get("visual_hidden_dim", v["dim"]),
            audio_hidden_dim=b.get("audio_hidden_dim", a["dim"]),
            audio_fps=b.get("audio_fps", 50.0),
            head_dim=b.get("head_dim", 128),
            interaction_strategy=b.get("interaction_strategy", "full"),
            apply_cross_rope=b.get("apply_cross_rope", True),
            apply_first_frame_bias_in_rope=b.get("apply_first_frame_bias_in_rope", False),
            trainable_condition_scale=b.get("trainable_condition_scale", False),
            pooled_adaln=b.get("pooled_adaln", False)),
        video_vae=WanVAEConfig(
            base_dim=vv.get("base_dim", 96), z_dim=vv.get("z_dim", 16),
            dim_mult=tuple(vv.get("dim_mult", (1, 2, 4, 4))),
            num_res_blocks=vv.get("num_res_blocks", 2),
            attn_scales=tuple(vv.get("attn_scales", ())),
            temperal_downsample=tuple(vv.get("temperal_downsample", (False, True, True))),
            **({"latents_mean": tuple(vv["latents_mean"])}
               if vv.get("latents_mean") is not None else {}),
            **({"latents_std": tuple(vv["latents_std"])}
               if vv.get("latents_std") is not None else {})),
        audio_vae=DACVAEConfig(
            encoder_dim=av.get("encoder_dim", 128),
            encoder_rates=tuple(av.get("encoder_rates", (2, 3, 4, 5, 8))),
            decoder_dim=av.get("decoder_dim", 2048),
            decoder_rates=tuple(av.get("decoder_rates", (8, 5, 4, 3, 2))),
            latent_dim=av.get("latent_dim", 128),
            sample_rate=av.get("sample_rate", 48000),
            continuous=av.get("continuous", True),
            n_codebooks=av.get("n_codebooks", 9),
            codebook_size=av.get("codebook_size", 1024),
            codebook_dim=av.get("codebook_dim", 8)),
        text_encoder=text_encoder,
        boundary_ratio=pipe_cfg.get("boundary_ratio", 0.9),
        audio_vae_type=pipe_cfg.get("audio_vae_type", "dac"),
        two_video_towers=os.path.isdir(os.path.join(ckpt_dir, "video_dit_2")),
    )


def config_dicts(cfg: MOVAConfig) -> Dict[str, Dict[str, Any]]:
    """The config.json of each module directory and `model_index.json`, as
    `config_from_checkpoint` reads them back into `cfg`."""
    v, a, te = cfg.video_dit, cfg.audio_dit, cfg.text_encoder
    video = dict(dim=v.dim, in_dim=v.in_dim, ffn_dim=v.ffn_dim, out_dim=v.out_dim,
                 text_dim=v.text_dim, freq_dim=v.freq_dim, eps=v.eps,
                 patch_size=list(v.patch_size), num_heads=v.num_heads,
                 num_layers=v.num_layers, rope_max_len=v.rope_max_len)

    def fields(obj, *names):
        return {n: (list(getattr(obj, n)) if isinstance(getattr(obj, n), tuple)
                    else getattr(obj, n)) for n in names}

    return {
        "video_dit": video, "video_dit_2": video,
        "audio_dit": dict(dim=a.dim, in_dim=a.in_dim, ffn_dim=a.ffn_dim, out_dim=a.out_dim,
                          text_dim=a.text_dim, freq_dim=a.freq_dim, eps=a.eps,
                          patch_size=[a.patch_size], num_heads=a.num_heads,
                          num_layers=a.num_layers, vae_type=a.vae_type,
                          rope_max_len=a.rope_max_len),
        "dual_tower_bridge": fields(
            cfg.bridge, "visual_layers", "audio_layers", "visual_hidden_dim",
            "audio_hidden_dim", "audio_fps", "head_dim", "interaction_strategy",
            "apply_cross_rope", "apply_first_frame_bias_in_rope",
            "trainable_condition_scale", "pooled_adaln"),
        "video_vae": fields(cfg.video_vae, "base_dim", "z_dim", "dim_mult", "num_res_blocks",
                            "attn_scales", "temperal_downsample", "latents_mean",
                            "latents_std"),
        "audio_vae": fields(cfg.audio_vae, "encoder_dim", "encoder_rates", "decoder_dim",
                            "decoder_rates", "latent_dim", "sample_rate", "continuous",
                            "n_codebooks", "codebook_size", "codebook_dim"),
        "text_encoder": fields(te, "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
                               "num_heads", "relative_attention_num_buckets",
                               "relative_attention_max_distance", "layer_norm_epsilon"),
        "model_index": dict(boundary_ratio=cfg.boundary_ratio,
                            audio_vae_type=cfg.audio_vae_type),
    }


# --- checkpoint names -> the port's parameters ------------------------------

def _wn_fold(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, the norm over axes 1 and 2, in fp32 (JAX's
    `_wn_conv1d`; ConvTranspose1d's [in, out, k] keeps its input axis)."""
    g, v = g.float(), v.float()
    return g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()


def _is_norm_bias(key: str, names) -> bool:
    """Whether `key` is the bias of a Wan-VAE RMS norm among `names` (a
    state dict's keys or a module's parameter names)."""
    return key.endswith(".bias") and key[:-len(".bias")] + ".gamma" in names


def _has_norm_bias(sd: StateDict) -> bool:
    """A Wan-VAE checkpoint whose RMS norms carry per-channel biases (the
    scalar 0 of an unbiased norm is dropped, as the JAX loader drops it)."""
    return any(_is_norm_bias(k, sd) and sd[k].dim() for k in sd)


def _sources(name: str, sd: StateDict, module: nn.Module, device: torch.device
             ) -> Tuple[StateDict, list]:
    """({parameter name: tensor to load}, checkpoint keys no parameter takes)."""
    params = dict(module.named_parameters())
    used, out = set(), {}
    for pname, p in params.items():
        prefix = pname.rpartition(".")[0]
        key = pname
        if name == "text_encoder" and pname == "shared.weight" and key not in sd:
            key = "encoder.embed_tokens.weight"
        if name == "video_vae" and _is_norm_bias(pname, params) and (
                key not in sd or not sd[key].dim()):
            out[pname] = torch.zeros(p.shape)      # a norm the checkpoint gives no bias
        elif key in sd:
            out[pname] = sd[key]
            used.add(key)
        elif name == "audio_vae" and pname.endswith(".weight") and f"{prefix}.weight_g" in sd:
            g, v = f"{prefix}.weight_g", f"{prefix}.weight_v"
            out[pname] = _wn_fold(sd[g].to(device), sd[v].to(device))
            used.update((g, v))
        elif name == "video_vae" and prefix in ("quant_conv", "post_quant_conv"):
            shape = p.shape
            out[pname] = (torch.eye(shape[0], shape[1]).reshape(shape)
                          if pname.endswith(".weight") else torch.zeros(shape))
    missing = sorted(set(params) - set(out))
    if missing:
        raise KeyError(f"{name}: the checkpoint lacks {len(missing)} parameters: "
                       f"{missing[:8]}")
    unused = sorted(set(sd) - used)
    for pname, p in params.items():
        x = out[pname]
        if x.shape != p.shape:
            if x.numel() != p.numel() or not (pname.endswith((".gamma", ".alpha"))
                                              or _is_norm_bias(pname, params)):
                raise ValueError(f"{name}: {pname} is {tuple(x.shape)} in the checkpoint, "
                                 f"{tuple(p.shape)} in the module")
            out[pname] = x.reshape(p.shape)
    return out, unused


@torch.no_grad()
def load_module(ckpt_dir: str, name: str, cfg: MOVAConfig,
                dtype: torch.dtype = torch.bfloat16, device="cuda") -> nn.Module:
    """One module of the pipeline (a key of `MODULES`) from its checkpoint
    directory, on `device`, in eval mode with no gradients."""
    device = resolve_device(device)
    subdir, cls, sub_cfg = MODULES[name]
    fp8 = dtype in dnn.FP8_DTYPES
    mdtype = torch.float32 if name in VAES else (torch.bfloat16 if fp8 else dtype)
    sd = load_state_dict(os.path.join(ckpt_dir, subdir))
    kw = {"norm_bias": True} if name == "video_vae" and _has_norm_bias(sd) else {}
    with torch.device("meta"):
        module = cls(sub_cfg(cfg), dtype=mdtype, **kw)
    if list(module.buffers()):
        raise NotImplementedError(f"{name}: modules with buffers are not loaded")
    src, unused = _sources(name, sd, module, device)
    del sd
    if unused:
        print(f"[load] {name}: {len(unused)} checkpoint tensors unused: {unused}")
    for pname, p in list(module.named_parameters()):
        x = src.pop(pname)
        if fp8 and name not in VAES and dnn.fp8_stored(module, pname, p):
            t = dnn.to_fp8(x.to(device).float(), dtype)
        else:
            t = torch.empty(p.shape, dtype=p.dtype, device=device)
            t.copy_(x)
        owner, _, leaf = pname.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    if fp8 and name not in VAES:
        dnn.cast_modules_fp8(module, dtype)
    return module.eval().requires_grad_(False)


def module_names(ckpt_dir: str):
    """The pipeline's modules present in a checkpoint, in loading order."""
    return [n for n in MODULES
            if n != "video_dit_2" or os.path.isdir(os.path.join(ckpt_dir, "video_dit_2"))]


def load_pipeline_params(ckpt_dir: str, cfg: Optional[MOVAConfig] = None,
                         dtype: torch.dtype = torch.bfloat16, device="cuda",
                         host: bool = False,
                         prepare: Optional[Callable[[str, nn.Module], None]] = None
                         ) -> Dict[str, nn.Module]:
    """The modules `MOVAPipeline` takes (the keys of
    `models.factory.init_pipeline_params`), loaded one at a time. With
    `host`, each is loaded on the card and moved into page-locked host
    memory (`offload.to_host`) before the next, for `offload="component"`.
    `prepare(name, module)`, where given, runs on each module on `device`
    once it is loaded and before it is page-locked (the LoRA CLI merges
    there). Prints one line per module: bytes, seconds, rate and the host's
    RSS."""
    device = resolve_device(device)
    cfg = cfg or config_from_checkpoint(ckpt_dir)
    out = {}
    for name in module_names(ckpt_dir):
        t0 = time.perf_counter()
        module = load_module(ckpt_dir, name, cfg, dtype, device)
        if prepare is not None:
            prepare(name, module)
        if host and device.type != "cpu":
            offload.to_host(module, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        gb = offload.nbytes(module) / 1e9
        rss = host_rss_gib()
        print(f"[load] {name}: {gb:.3f} GB in {seconds:.2f} s ({gb / seconds:.2f} GB/s)"
              + ("" if rss is None else f", host RSS {rss:.2f} GiB"), flush=True)
        out[name] = module
    return out


def save_pipeline_params(modules: Mapping[str, nn.Module], cfg: MOVAConfig,
                         ckpt_dir: str, index: bool = True) -> int:
    """Write `modules` as a checkpoint `load_pipeline_params` reads: one
    directory per module with its config.json and `model.safetensors`, and
    (with `index`) `model_index.json`. The towers and UMT5 in the dtype they
    hold, the VAEs in fp32 with the DAC's convolutions weight-normed
    (`weight_g` = the norm of each output channel, or input channel of a
    ConvTranspose1d; `weight_v` = the weight). Returns the bytes of tensor
    data written."""
    configs = config_dicts(cfg)
    total = 0
    for name, module in modules.items():
        subdir = MODULES[name][0]
        path = os.path.join(ckpt_dir, subdir)
        os.makedirs(path, exist_ok=True)
        sd = module.state_dict()
        if name in VAES:
            sd = {k: v.float() for k, v in sd.items()}
        if name == "audio_vae":
            for mname, m in module.named_modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    w = sd.pop(f"{mname}.weight")
                    sd[f"{mname}.weight_g"] = w.square().sum(dim=(1, 2), keepdim=True).sqrt()
                    sd[f"{mname}.weight_v"] = w
        total += save_state_dict(sd, os.path.join(path, "model.safetensors"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(configs[subdir], f, indent=1)
    if index:
        with open(os.path.join(ckpt_dir, "model_index.json"), "w") as f:
            json.dump(configs["model_index"], f, indent=1)
    return total


# the modules full fine-tuning trains and exports
DIFFUSION_MODULES = ("video_dit", "video_dit_2", "audio_dit", "bridge")


def export_trained_modules(trained: Mapping[str, nn.Module], cfg: MOVAConfig,
                           out_dir: str) -> int:
    """Full fine-tuning's per-module export (counterpart of the JAX
    package's `convert/torch_export.export_trained_modules`): each trained
    diffusion module as `out_dir/<its checkpoint directory>/config.json` and
    `model.safetensors` (`dual_tower_bridge/` for the bridge), written by
    `save_pipeline_params` without `model_index.json`. Both packages'
    `load_pipeline_params` read such a directory among a checkpoint's
    others. Returns the bytes of tensor data written."""
    return save_pipeline_params({n: m for n, m in trained.items() if n in DIFFUSION_MODULES},
                                cfg, out_dir, index=False)


def load_tokenizer(ckpt_dir: str):
    """The checkpoint's tokenizer (`tokenizer/`) through `transformers`,
    imported here: the port needs it only for a real checkpoint."""
    path = os.path.join(ckpt_dir, "tokenizer")
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(f"reading the tokenizer in {path} needs the transformers "
                          "package, which is not installed") from e
    return AutoTokenizer.from_pretrained(path)
