"""The program's launch counters, read by name in every run: a cell's file
states the launches it expects per pass, and a run whose counts differ is
not correct."""

from __future__ import annotations

from typing import Dict


def _sources():
    from dualforce_tpu_torch.ops import flash_attention as fa
    from dualforce_tpu_torch.ops import sage_attention as sa

    return {"flash_attention.launches": (fa.flash_attention, "launches"),
            "flash_attention.cap_launches": (fa.flash_attention, "cap_launches"),
            "flash_attention_bwd.launches": (fa.flash_attention_bwd, "launches"),
            "flash_attention_bwd.split_launches": (fa.flash_attention_bwd, "split_launches"),
            "flash_bwd_preprocess.launches": (fa.flash_bwd_preprocess, "launches"),
            "sage_attention.launches": (sa.sage_attention, "launches"),
            "sage_quantize.launches": (sa.sage_quantize, "launches")}


def read() -> Dict[str, int]:
    return {name: int(getattr(obj, attr)) for name, (obj, attr) in _sources().items()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    now = read()
    return {name: now[name] - before[name] for name in now}
