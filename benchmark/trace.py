"""The traced run: `torch.profiler` over the window, its events kept in
memory (no trace file is written), reduced to the records the per-layer
readers take: the device time of each kernel class, the busy time (the
union of the device's operation intervals), the window's length, and the
breakdown of the line (the device operations that took the most time, and
the idle gaps by what the host was doing as they began)."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW_SPAN = "benchmark.window"
TOP = 10
# host spans looked back over to name an idle gap
HOST_LOOKBACK = 4096


def classify(name: str, classes: Dict[str, List[str]]) -> str:
    """The first class (in name order) one of whose patterns the kernel's
    name holds, or "other"."""
    low = name.lower()
    for cls, patterns in classes.items():
        if any(p in low for p in patterns):
            return cls
    return "other"


def _annotation(event) -> bool:
    """Whether a device row of the trace is a user annotation, not an
    operation."""
    if getattr(event, "is_user_annotation", None) and event.is_user_annotation():
        return True
    kind = str(event.activity_type()) if hasattr(event, "activity_type") else ""
    return "annotation" in kind.lower()


class Tracer:
    """Profiles the block of `window()`; `reduce` afterwards."""

    def __init__(self):
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                yield
        self.prof = prof

    def span(self, name: str):
        from torch.profiler import record_function

        return record_function(name)

    def events(self) -> Tuple[Tuple[int, int], list, list]:
        """((window start, end) ns, device operations [(name, start, end)]:
        kernels, copies and fills, host events [(name, start, end)]), all on
        the profiler's clock. The device rows that mirror a host span
        (`record_function`'s user annotations) are no operations and are
        left out."""
        window, device, host = None, [], []
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            kind = str(e.device_type()).rpartition(".")[2]
            if e.name() == WINDOW_SPAN and kind == "CPU":
                window = (start, end)
            elif kind == "CPU":
                host.append((e.name(), start, end))
            elif e.duration_ns() > 0 and not _annotation(e):
                device.append((e.name(), start, end))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        return window, device, host


def reduce(window, device, host, classes: Dict[str, List[str]]) -> dict:
    """Records of the window: `window_s`, `busy_s`, `device_s` {class:
    seconds}, `breakdown` {"device_ops", "idle_gaps"}."""
    w0, w1 = window
    clipped = sorted((max(s, w0), min(e, w1), n) for n, s, e in device if e > w0 and s < w1)
    by_class, by_name = defaultdict(float), defaultdict(float)
    for s, e, n in clipped:
        by_class[classify(n, classes)] += (e - s) * 1e-9
        by_name[n] += (e - s) * 1e-9
    busy, gaps, cursor = 0, [], w0
    for s, e, _ in clipped:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        # the innermost host span open as the device fell idle: the latest
        # to start before it that had not ended
        doing = "python"
        i = bisect.bisect_right(starts, g0) - 1
        for name, _, e in reversed(host[max(0, i - HOST_LOOKBACK):i + 1]):
            if e >= g0:
                doing = name
                break
        idle[doing] += (g1 - g0) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "device_s": dict(by_class),
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in gaps_top]}}
