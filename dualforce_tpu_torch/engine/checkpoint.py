"""Training checkpoints with auto-resume (counterpart of
`dualforce_tpu/engine/checkpoint.py`, which writes Orbax).

Layout: `<save_dir>/step-<N>/state.pt` (`torch.save` of the state: LoRA
factors, optimizer state, generator state) and `meta.json` with
`global_step`, the same `step-N/` directories the JAX package scans.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(save_dir: str, step: int, state: Any, name: str = "state.pt",
                    complete: bool = True) -> str:
    """`state` as `step-<step>/<name>`; with `complete`, `meta.json` after it.
    A rank of a mesh whose state is its own (fsdp shards' optimizer state)
    writes `state.rank<r>.pt` without `meta.json`, before the main rank
    completes the directory."""
    path = os.path.join(os.path.abspath(save_dir), f"step-{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, name))
    if complete:
        # meta.json last: a step directory counts only once it is complete
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"global_step": step}, f)
    return path


def latest_step(save_dir: str) -> Optional[int]:
    """The highest N with a complete `step-N` directory under save_dir."""
    if not os.path.isdir(save_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(save_dir)
             if (m := re.fullmatch(r"step-(\d+)", d))
             and os.path.exists(os.path.join(save_dir, d, "meta.json"))]
    return max(steps) if steps else None


def restore_checkpoint(save_dir: str, step: Optional[int] = None,
                       map_location=None, name: str = "state.pt") -> Tuple[Any, Dict]:
    """(state, meta) of `step`, or of the latest step; `name` as
    `save_checkpoint`'s."""
    if step is None:
        step = latest_step(save_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {save_dir}")
    path = os.path.join(os.path.abspath(save_dir), f"step-{step}")
    state = torch.load(os.path.join(path, name), map_location=map_location,
                       weights_only=True)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, meta
