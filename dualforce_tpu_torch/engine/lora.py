"""LoRA over the port's modules (counterpart of `dualforce_tpu/engine/lora.py`).

The factors live apart from the modules, one {"a": [in, r], "b": [r, out]}
pair per targeted weight, keyed by the weight's name in its module
(`blocks.3.self_attn.q.weight`, `audio_to_video_conditioners.0.inner.k.weight`):
{module: {name: {"a", "b"}}}. The targets are the JAX package's: every q, k,
v and o projection of `self_attn`, `cross_attn` and the bridge's `inner`
attention, nothing under the time or patch embeddings. `a` starts normal /
sqrt(in) and `b` at zero, so the first merge is the identity.

`merge_pipeline_lora` gives W' = W + (a b)^T * alpha / r * scale per targeted
weight in fp32, cast to W's dtype, as {module: {name: W'}}. The training
step hands those to `dual_tower_step(params=...)`, which applies them
functionally (`torch.func.functional_call`), so the base modules stay frozen
and as they are; gradients reach only the factors. `merge_lora_into` writes
the same W' into a module's own weights, one at a time, for inference (the
LoRA CLI), so no second copy of a module is held.

`save_lora` / `load_lora` read and write the JAX package's format: one npz of
`{module}::{path}::{a|b}` arrays stacked over layers ([L, in, r], [L, r, out],
JAX paths such as `blocks/self_attn/q/kernel` and `a2v/inner/q/kernel`) and a
json sidecar with alpha and rank, so LoRAs cross between the two packages.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TARGET_RE = r"(self_attn|cross_attn|inner)\.(q|k|v|o)\.weight$"
EXCLUDE_RE = r"(time_projection|time_embedding|patch_embedding)"
DEFAULT_MODULES = ("video_dit", "video_dit_2", "audio_dit", "bridge")

_BRIDGE_SIDES = (("audio_to_video_conditioners", "a2v"),
                 ("video_to_audio_conditioners", "v2a"))

Lora = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def lora_targets(module: torch.nn.Module) -> List[str]:
    """Names of the module's weights that take a LoRA, in module order."""
    return [n for n, _ in module.named_parameters()
            if re.search(TARGET_RE, n) and not re.search(EXCLUDE_RE, n)]


def init_lora(module: torch.nn.Module, rank: int, generator: torch.Generator
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: {"a": [in, r] normal / sqrt(in), "b": [r, out] zeros}} in fp32
    for every target, drawn on the host from `generator` and moved to the
    module's device, leaves that require grad."""
    out = {}
    for name in lora_targets(module):
        w = module.get_parameter(name)
        fan_out, fan_in = w.shape
        a = torch.randn(fan_in, rank, generator=generator) / math.sqrt(fan_in)
        b = torch.zeros(rank, fan_out)
        out[name] = {"a": a.to(w.device).requires_grad_(),
                     "b": b.to(w.device).requires_grad_()}
    return out


def init_pipeline_lora(modules: Dict[str, torch.nn.Module], rank: int,
                       generator: torch.Generator,
                       names: Sequence[str] = DEFAULT_MODULES) -> Lora:
    """LoRA factors for the trainable modules present in `modules`."""
    return {m: init_lora(modules[m], rank, generator) for m in names if m in modules}


def lora_parameters(lora: Lora) -> List[torch.Tensor]:
    """Every factor, in a fixed order (module, name, then a before b)."""
    return [lora[m][n][part] for m in sorted(lora) for n in sorted(lora[m])
            for part in ("a", "b")]


def _merged(w: torch.Tensor, ab: Dict[str, torch.Tensor], alpha: float,
            scale: float) -> torch.Tensor:
    """W + (a b)^T * alpha / r * scale in fp32 on W's device, cast to W's dtype."""
    a, b = (ab[part].to(w.device, torch.float32) for part in ("a", "b"))
    delta = (a @ b).t() * ((alpha / b.shape[-2]) * scale)
    return (w.float() + delta).to(w.dtype)


def merge_lora(module: torch.nn.Module, tree: Dict[str, Dict[str, torch.Tensor]],
               alpha: float = 16.0, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{name: W + (a b)^T * alpha / r * scale}, in fp32, cast to W's dtype."""
    return {name: _merged(module.get_parameter(name), ab, alpha, scale)
            for name, ab in tree.items()}


def merge_pipeline_lora(modules: Dict[str, torch.nn.Module], lora: Lora,
                        alpha: float = 16.0, names: Optional[Sequence[str]] = None,
                        scale: float = 1.0) -> Dict[str, Dict[str, torch.Tensor]]:
    """Merged weights per module, for the modules in `names` (default: every
    module with factors)."""
    return {m: merge_lora(modules[m], lora[m], alpha, scale)
            for m in (names if names is not None else lora) if m in lora and lora[m]}


@torch.no_grad()
def merge_lora_into(module: torch.nn.Module, tree: Dict[str, Dict[str, torch.Tensor]],
                    alpha: float = 16.0, scale: float = 1.0) -> torch.nn.Module:
    """`merge_lora`'s weights written into `module`'s own parameters, one at
    a time (the factors are moved to each weight's device). Returns
    `module`."""
    for name, ab in tree.items():
        w = module.get_parameter(name)
        w.copy_(_merged(w, ab, alpha, scale))
    return module


# --- the JAX package's stacked layout --------------------------------------

def _jax_path(name: str, bridge_pos: Dict[int, int]) -> Tuple[str, int]:
    """A port weight name -> (JAX kernel path, index on the stacked axis)."""
    m = re.fullmatch(r"blocks\.(\d+)\.(.+)\.weight", name)
    if m:
        return f"blocks/{m.group(2).replace('.', '/')}/kernel", int(m.group(1))
    for port, jax in _BRIDGE_SIDES:
        m = re.fullmatch(rf"{port}\.(\d+)\.(.+)\.weight", name)
        if m:
            return (f"{jax}/{m.group(2).replace('.', '/')}/kernel",
                    bridge_pos[int(m.group(1))])
    raise ValueError(f"no JAX path for LoRA target {name!r}")


def _port_names(path: str, count: int, bridge_layers: Sequence[int]) -> List[str]:
    """A JAX kernel path stacked `count` deep -> the port's weight names."""
    head, _, rest = path.partition("/")
    rest = rest[:-len("/kernel")].replace("/", ".")
    if head == "blocks":
        return [f"blocks.{i}.{rest}.weight" for i in range(count)]
    port = dict((jax, port) for port, jax in _BRIDGE_SIDES)[head]
    if count != len(bridge_layers):
        raise ValueError(f"{path}: {count} stacked layers, the bridge interacts at "
                         f"{list(bridge_layers)}")
    return [f"{port}.{layer}.{rest}.weight" for layer in bridge_layers]


def to_stacked(lora: Lora) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """The port's LoRA as the JAX package's tree of stacked numpy factors."""
    out = {}
    for mod, tree in lora.items():
        layers = sorted({int(re.match(rf"{p}\.(\d+)\.", n).group(1))
                         for n in tree for p, _ in _BRIDGE_SIDES
                         if n.startswith(p + ".")})
        pos = {layer: i for i, layer in enumerate(layers)}
        stacks: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
        for name, ab in tree.items():
            path, i = _jax_path(name, pos)
            stacks.setdefault(path, {})[i] = {
                part: ab[part].detach().float().cpu().numpy() for part in ("a", "b")}
        out[mod] = {path: {part: np.stack([by_i[i][part] for i in sorted(by_i)])
                           for part in ("a", "b")}
                    for path, by_i in stacks.items()}
    return out


def from_stacked(tree, bridge_layers: Sequence[int]) -> Lora:
    """The JAX package's LoRA tree ({module: {path: {a: [L, in, r], b:
    [L, r, out]}}}, numpy or JAX arrays) as the port's LoRA, fp32 on the
    host. bridge_layers: the bridge's interaction layers
    (`cfg.bridge.interaction_layers()`), in the order the bridge factors are
    stacked."""
    out: Lora = {}
    for mod, paths in tree.items():
        out[mod] = {}
        for path, ab in paths.items():
            a, b = (np.asarray(ab[part], np.float32) for part in ("a", "b"))
            for i, name in enumerate(_port_names(path, a.shape[0], bridge_layers)):
                out[mod][name] = {"a": torch.from_numpy(a[i].copy()).requires_grad_(),
                                  "b": torch.from_numpy(b[i].copy()).requires_grad_()}
    return out


def save_lora(lora: Lora, path: str, alpha: float, rank: int) -> None:
    """Write `<path>.npz` (the JAX package's stacked layout) and `<path>.json`."""
    base = path[:-4] if path.endswith(".npz") else path
    flat = {f"{mod}::{p}::{part}": arr
            for mod, tree in to_stacked(lora).items() for p, ab in tree.items()
            for part, arr in ab.items()}
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez(base + ".npz", **flat)
    with open(base + ".json", "w") as f:
        json.dump({"alpha": alpha, "rank": rank}, f)


def load_lora(path: str, bridge_layers: Sequence[int]) -> Tuple[Lora, Dict[str, float]]:
    """Read a LoRA written by `save_lora` here or in the JAX package."""
    base = path[:-4] if path.endswith(".npz") else path
    tree: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    with np.load(base + ".npz") as data:
        for key in data.files:
            mod, p, part = key.split("::")
            tree.setdefault(mod, {}).setdefault(p, {})[part] = data[key]
    with open(base + ".json") as f:
        meta = json.load(f)
    return from_stacked(tree, bridge_layers), meta
