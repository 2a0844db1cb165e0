"""LoRAs trained by the reference trainers -> the port's LoRA (counterpart of
`dualforce_tpu/convert/lora_import.py`).

Two on-disk formats:
  1. the accelerate trainer's directory, `lora_weights.pt` (+ optional
     `lora_config.pt` with "alpha" and "rank"), keys
     `{module}.{torch path}.lora_A.weight` or PEFT's
     `.lora_A.default.weight`; A: [r, in], B: [out, r];
  2. the low-resource trainer's state dict, buffer-style keys ending in
     `.lora_A` / `.lora_B`.

Both convert into the JAX package's stacked tree ({module: {path: {"a":
[L, in, r], "b": [L, r, out]}}}, zero factors for layers without trained
ones, as JAX does), which `engine.lora.from_stacked` carries into the
port's per-weight factors. The merge is W + (a b)^T * alpha / r, the torch
LoRALinear's scaling.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dualforce_tpu_torch.config import MOVAConfig
from dualforce_tpu_torch.engine import lora as lora_mod

# reference module name -> the pipeline's module key
_MODULE_MAP = {
    "video_dit": "video_dit",
    "video_dit_2": "video_dit_2",
    "audio_dit": "audio_dit",
    "dual_tower_bridge": "bridge",
}

# reference sub-path -> (JAX stacked path, layer index)
_KEY_RES = [
    (re.compile(r"^blocks\.(\d+)\.(self_attn|cross_attn)\.(q|k|v|o)$"),
     lambda m: (f"blocks/{m.group(2)}/{m.group(3)}/kernel", int(m.group(1)))),
    (re.compile(r"^audio_to_video_conditioners\.(\d+)\.inner\.(q|k|v|o)$"),
     lambda m: (f"a2v/inner/{m.group(2)}/kernel", int(m.group(1)))),
    (re.compile(r"^video_to_audio_conditioners\.(\d+)\.inner\.(q|k|v|o)$"),
     lambda m: (f"v2a/inner/{m.group(2)}/kernel", int(m.group(1)))),
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu").float().numpy()
    return np.asarray(x, dtype=np.float32)


def _parse_key(key: str) -> Optional[Tuple[str, str, str]]:
    """-> (module, reference sub-path, "a" | "b"), or None for a key that is
    no LoRA factor."""
    m = re.match(
        r"^(?:(video_dit_2|video_dit|audio_dit|dual_tower_bridge)\.)?(.+?)"
        r"\.lora_([AB])(?:\.default)?(?:\.weight)?$", key)
    if not m:
        return None
    return m.group(1) or "", m.group(2), "a" if m.group(3) == "A" else "b"


def stacked_tree(sd: Mapping[str, Any], cfg: MOVAConfig
                 ) -> Tuple[Dict[str, Dict[str, Dict[str, np.ndarray]]], Dict[str, List[str]]]:
    """A reference LoRA state dict as the JAX package's stacked tree, and the
    keys skipped by reason ("non_lora", "unmapped")."""
    collected: Dict[Tuple[str, str], Dict[int, Dict[str, np.ndarray]]] = {}
    skipped: Dict[str, List[str]] = {"non_lora": [], "unmapped": []}
    for key, value in sd.items():
        parsed = _parse_key(key)
        if parsed is None:
            skipped["non_lora"].append(key)
            continue
        module, sub, part = parsed
        hit = None
        for rx, to_path in _KEY_RES:
            m = rx.match(sub)
            if m:
                hit = to_path(m)
                break
        if hit is None or (module and module not in _MODULE_MAP):
            skipped["unmapped"].append(key)
            continue
        path, layer = hit
        mod = _MODULE_MAP.get(module, module)
        if not mod:  # a low-resource dict saved per module, without the prefix
            mod = "bridge" if path.startswith(("a2v/", "v2a/")) else "video_dit"
        # lora_A.weight [r, in] -> a [in, r]; lora_B.weight [out, r] -> b [r, out]
        collected.setdefault((mod, path), {}).setdefault(layer, {})[part] = _np(value).T

    bridge_pos = {layer: i for i, layer in enumerate(cfg.bridge.interaction_layers())}

    def num_layers(mod: str, path: str) -> int:
        if path.startswith(("a2v/", "v2a/")):
            return len(bridge_pos)
        return (cfg.video_dit.num_layers if mod.startswith("video")
                else cfg.audio_dit.num_layers)

    tree: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for (mod, path), layers in collected.items():
        n = num_layers(mod, path)
        sample = next((ab for ab in layers.values() if "a" in ab and "b" in ab), None)
        if sample is None:
            skipped["unmapped"].append(f"{mod}:{path} (missing a or b factor)")
            continue
        fan_in, r = sample["a"].shape
        fan_out = sample["b"].shape[1]
        a = np.zeros((n, fan_in, r), np.float32)
        b = np.zeros((n, r, fan_out), np.float32)
        for layer, ab in layers.items():
            if "a" not in ab or "b" not in ab:
                skipped["unmapped"].append(f"{mod}:{path} layer {layer} (missing a or b factor)")
                continue
            pos = bridge_pos.get(layer) if path.startswith(("a2v/", "v2a/")) else layer
            if pos is None or pos >= n:
                skipped["unmapped"].append(f"{mod}:{path} layer {layer}")
                continue
            a[pos] = ab["a"]
            b[pos] = ab["b"]
        tree.setdefault(mod, {})[path] = {"a": a, "b": b}
    return tree, skipped


def convert_lora_state_dict(sd: Mapping[str, Any], cfg: MOVAConfig
                            ) -> Tuple[lora_mod.Lora, Dict[str, List[str]]]:
    """(the port's LoRA, skipped keys by reason) of a reference LoRA state
    dict ({key: tensor or array})."""
    tree, skipped = stacked_tree(sd, cfg)
    return lora_mod.from_stacked(tree, cfg.bridge.interaction_layers()), skipped


def load_reference_lora(path: str, cfg: MOVAConfig) -> Tuple[lora_mod.Lora, Dict[str, float]]:
    """Either reference format from disk (a directory with `lora_weights.pt`
    and optionally `lora_config.pt`, or a bare `.pt` state dict), converted.
    Returns (LoRA, {"alpha", "rank"}): alpha from the config (16 without
    one), the rank from the factors' shapes (the reference's non-FSDP save
    stores a class name under "rank")."""
    weights_path = path
    meta: Dict[str, float] = {"alpha": 16.0, "rank": 16}
    if os.path.isdir(path):
        weights_path = os.path.join(path, "lora_weights.pt")
        config_path = os.path.join(path, "lora_config.pt")
        if os.path.exists(config_path):
            tcfg = torch.load(config_path, map_location="cpu", weights_only=False)
            try:
                meta["alpha"] = float(tcfg.get("alpha", 16.0))
            except (TypeError, ValueError):
                pass
            try:
                meta["rank"] = int(tcfg.get("rank", 16))
            except (TypeError, ValueError):
                pass
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    tree, skipped = stacked_tree(sd, cfg)
    if skipped["unmapped"]:
        print(f"[lora-import] {len(skipped['unmapped'])} unmapped keys "
              f"(first: {skipped['unmapped'][:3]})")
    n = sum(len(v) for v in tree.values())
    print(f"[lora-import] converted {n} LoRA factor pairs "
          f"(rank={meta['rank']}, alpha={meta['alpha']})")
    for paths in tree.values():
        for ab in paths.values():
            meta["rank"] = int(ab["a"].shape[-1])
            break
        break
    return lora_mod.from_stacked(tree, cfg.bridge.interaction_layers()), meta
