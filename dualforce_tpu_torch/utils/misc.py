"""Timing, memory and profiling helpers of the CLIs (counterpart of
`dualforce_tpu/utils/misc.py`): a wall timer that waits for the card, the
card's allocated memory, and a `torch.profiler` trace of a block written to
a directory (the counterpart of JAX's `--profile`)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(name: str = "", device=None):
    """Wall-clock bracket; on a CUDA `device` the card's queued work is
    waited for at both ends. Yields a dict that holds "seconds" after; a
    named timer prints them."""
    _sync(device)
    t0 = time.perf_counter()
    result: Dict[str, float] = {}
    try:
        yield result
    finally:
        _sync(device)
        result["seconds"] = time.perf_counter() - t0
        if name:
            print(f"[timer] {name}: {result['seconds']:.3f}s", flush=True)


def hbm_in_use_gb(device=None) -> float:
    """Memory the caching allocator holds in tensors on the card (GB); 0
    without CUDA."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(device) / 1e9


def host_rss_gib() -> Optional[float]:
    """This process's resident host memory (GiB), where /proc says it."""
    try:
        with open("/proc/self/status") as f:
            kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    except (OSError, StopIteration):
        return None
    return kb / 2**20


def _us(avg, *names: str) -> float:
    """The first of `names` an averaged profiler event has (the attribute
    names moved between PyTorch versions), in microseconds."""
    for n in names:
        v = getattr(avg, n, None)
        if v is not None:
            return float(v)
    return 0.0


def device_ops(prof) -> List[Dict[str, float]]:
    """The profiler's averages by operation name, most self device time
    first: where the event ran ("CPU" for operators, "CUDA" for kernels and
    copies on the card), calls, self and total device microseconds, CPU
    microseconds. An operator's device time is that of the kernels it
    launched, which also have rows of their own."""
    rows = [{"name": a.key, "device_type": str(a.device_type).rpartition(".")[2],
             "calls": int(a.count),
             "self_device_us": _us(a, "self_device_time_total", "self_cuda_time_total"),
             "device_us": _us(a, "device_time_total", "cuda_time_total"),
             "cpu_us": _us(a, "cpu_time_total")}
            for a in prof.key_averages()]
    return sorted(rows, key=lambda r: -r["self_device_us"])


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """`torch.profiler` over the block (CPU, and CUDA where present); at its
    end writes `trace.json` (Chrome trace) and `device_ops.json` (the
    averages, `device_ops`) to `log_dir`. A no-op for None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "device_ops.json"), "w") as f:
        json.dump(device_ops(prof), f)
