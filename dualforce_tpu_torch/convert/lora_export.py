"""The port's LoRA -> the reference trainers' on-disk LoRA formats
(counterpart of `dualforce_tpu/convert/lora_export.py`; the inverse of
`convert/lora_import.py`).

Two formats, as there:
  1. the accelerate trainer's directory: `lora_weights.pt` (keys
     `{module}.{torch path}.lora_A.weight` and `.lora_B.weight`; A: [r, in],
     B: [out, r]) and `lora_config.pt` ({"rank", "alpha"});
  2. the low-resource trainer's single `.pt` state dict, buffer-style keys
     ending in `.lora_A` / `.lora_B`.

The port's factors are keyed by the weight's name in its module, which is
the reference's torch path plus `.weight` (the bridge's at its interaction
layer's index), so each pair maps by name, with no configuration. A
pair whose factors are both zero everywhere (an untrained layer, as the
importer zero-fills them) is left out, as the JAX exporter leaves it out.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from dualforce_tpu_torch.engine import lora as lora_mod

# the pipeline's module key -> the reference's module name
_MODULE_MAP_INV = {
    "video_dit": "video_dit",
    "video_dit_2": "video_dit_2",
    "audio_dit": "audio_dit",
    "bridge": "dual_tower_bridge",
}


def export_lora_state_dict(lora: lora_mod.Lora, style: str = "accelerate"
                           ) -> Dict[str, torch.Tensor]:
    """The port's LoRA as a reference-format state dict of fp32 host tensors
    (A = a^T, B = b^T). style "accelerate": keys `...lora_A.weight`;
    "low_resource": keys `...lora_A`."""
    if style not in ("accelerate", "low_resource"):
        raise ValueError(f"unknown LoRA export style: {style}")
    suffix = ".weight" if style == "accelerate" else ""
    sd: Dict[str, torch.Tensor] = {}
    for module, tree in lora.items():
        if module not in _MODULE_MAP_INV:
            raise ValueError(f"unexportable LoRA module: {module}")
        prefix = _MODULE_MAP_INV[module]
        for name, ab in tree.items():
            if not name.endswith(".weight"):
                raise ValueError(f"non-weight LoRA target: {module}:{name}")
            a, b = (ab[p].detach().to("cpu", torch.float32) for p in ("a", "b"))
            if not (a.any() or b.any()):
                continue
            stem = f"{prefix}.{name[:-len('.weight')]}"
            sd[f"{stem}.lora_A{suffix}"] = a.t().contiguous()
            sd[f"{stem}.lora_B{suffix}"] = b.t().contiguous()
    return sd


def save_reference_lora(lora: lora_mod.Lora, out: str,
                        alpha: float = 16.0, rank: int = 16,
                        style: str = "accelerate") -> str:
    """Write a reference on-disk LoRA. accelerate: the directory `out` with
    `lora_weights.pt` and `lora_config.pt`; low_resource: one state dict at
    `out` (a `.pt` path) or `out/lora_low_resource.pt` (a directory).
    Returns the weights' path."""
    sd = export_lora_state_dict(lora, style=style)
    if style == "accelerate":
        os.makedirs(out, exist_ok=True)
        weights_path = os.path.join(out, "lora_weights.pt")
        torch.save(sd, weights_path)
        torch.save({"rank": int(rank), "alpha": float(alpha)},
                   os.path.join(out, "lora_config.pt"))
    else:
        weights_path = out if out.endswith(".pt") else os.path.join(out, "lora_low_resource.pt")
        os.makedirs(os.path.dirname(weights_path) or ".", exist_ok=True)
        torch.save(sd, weights_path)
    return weights_path
