"""Metric loggers (the port's copy of `dualforce_tpu/engine/logging.py`).

Sinks: JSONL (always, unless logging is off) and TensorBoard through
`torch.utils.tensorboard` when the `tensorboard` package is present. Kinds:
"none", "jsonl", "tensorboard".
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class BaseLogger:
    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class DummyLogger(BaseLogger):
    def log_scalars(self, metrics, step):
        pass


class JsonlLogger(BaseLogger):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log_scalars(self, metrics, step):
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorBoardLogger(BaseLogger):
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter  # needs `tensorboard`

        self._writer = SummaryWriter(log_dir)

    def log_scalars(self, metrics, step):
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), step)
        self._writer.flush()

    def close(self):
        self._writer.close()


class CompositeLogger(BaseLogger):
    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = loggers

    def log_scalars(self, metrics, step):
        for lg in self.loggers:
            lg.log_scalars(metrics, step)

    def close(self):
        for lg in self.loggers:
            lg.close()


def build_logger(kind: Optional[str], log_dir: str) -> BaseLogger:
    if kind in (None, "none"):
        return DummyLogger()
    if kind not in ("jsonl", "tensorboard"):
        raise ValueError(f"unknown logger {kind!r} (none, jsonl, tensorboard)")
    loggers: List[BaseLogger] = [JsonlLogger(os.path.join(log_dir, "metrics.jsonl"))]
    if kind == "tensorboard":
        try:
            loggers.append(TensorBoardLogger(log_dir))
        except ImportError as e:
            print(f"[logger] tensorboard requested but unavailable ({e!r}); "
                  "continuing with JSONL only")
    return CompositeLogger(loggers)
