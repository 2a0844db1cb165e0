"""Random weights from a seed, made once by the benchmark and handed alike to
the program and to the reference.

Each module's parameters are drawn as one standard-normal bf16 tensor on the
device from a seeded `torch.Generator` (one call per module, in a fixed
module order) and sliced into the layout's parameters, then scaled: weights
by 1/sqrt(fan_in), biases by 0.02, modulation tables by 1/sqrt(width), norm
scales (and the DAC's Snake frequencies) to 1 + 0.1 z and norm shifts to
0.1 z. The same seed gives the same bits on the same device type.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

NORM_SCALES = ("norm_q.weight", "norm_k.weight", "norm3.weight", "y_norm.weight",
               "layer_norm.weight", "gamma", "alpha")
NORM_SHIFTS = ("norm3.bias", "y_norm.bias")


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one of the run's independent streams
    (0: weights, 1: inputs, 2: the window's draws)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return g


def _scale(name: str, w: torch.Tensor) -> None:
    if name.endswith("modulation"):
        w.mul_(w.shape[-1] ** -0.5)
    elif name.endswith(NORM_SCALES):
        w.mul_(0.1).add_(1.0)
    elif name.endswith(NORM_SHIFTS):
        w.mul_(0.1)
    elif w.dim() == 1:
        w.mul_(0.02)
    else:
        w.mul_(math.prod(w.shape[1:]) ** -0.5)


@torch.no_grad()
def draw(layout: Dict[str, Dict[str, Tuple[int, ...]]], seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {name: tensor}} for every module of `layout`, in its order;
    each module's tensors are views of one buffer."""
    g = generator(seed, device, 0)
    out = {}
    for module, shapes in layout.items():
        total = sum(math.prod(s) for s in shapes.values())
        buf = torch.randn(total, generator=g, device=device, dtype=dtype)
        tensors, at = {}, 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            t = buf[at:at + n].view(shape)
            _scale(name, t)
            tensors[name] = t
            at += n
        out[module] = tensors
    return out
