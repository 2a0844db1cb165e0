"""Metric loggers (the port's copy of `dualforce_tpu/engine/logging.py`).

Sinks: JSONL (always, unless logging is off), TensorBoard through
`torch.utils.tensorboard` when the `tensorboard` package is present, and
W&B behind an import guard. Kinds as the JAX package's `build_logger` takes
them: None or "none" (nothing), "tensorboard", "wandb", "both" (TensorBoard
and W&B); any other kind ("jsonl" among them) gives JSONL alone. A sink that
fails to start, whatever the exception, leaves JSONL alone with a message.
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


class WandbLogger(BaseLogger):
    """W&B sink with JAX's lifecycle: `wandb.init(project, name, dir,
    config, resume="allow")`, `wandb.log` per step, the run's `finish`."""

    def __init__(self, log_dir: str, project: str = "dualforce-tpu",
                 run_name: Optional[str] = None, config: Optional[Dict] = None):
        import wandb  # guarded: not a dependency of the port

        self._wandb = wandb
        self._run = wandb.init(project=project, name=run_name, dir=log_dir,
                               config=config or {}, resume="allow")

    def log_scalars(self, metrics, step):
        self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)

    def close(self):
        self._run.finish()


class CompositeLogger(BaseLogger):
    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = loggers

    def log_scalars(self, metrics, step):
        for lg in self.loggers:
            lg.log_scalars(metrics, step)

    def close(self):
        for lg in self.loggers:
            lg.close()


def build_logger(kind: Optional[str], log_dir: str, is_main: bool = True) -> BaseLogger:
    """The `kind` of logger writing under `log_dir`; a rank other than the
    main one of a mesh (`is_main` False) logs nothing."""
    if kind in (None, "none") or not is_main:
        return DummyLogger()
    loggers: List[BaseLogger] = [JsonlLogger(os.path.join(log_dir, "metrics.jsonl"))]
    if kind in ("tensorboard", "both"):
        try:
            loggers.append(TensorBoardLogger(log_dir))
        except Exception as e:  # noqa: BLE001 (any failing sink leaves JSONL, as in JAX)
            print(f"[logger] tensorboard requested but unavailable ({e!r}); "
                  "continuing with JSONL only")
    if kind in ("wandb", "both"):
        try:
            loggers.append(WandbLogger(log_dir))
        except Exception as e:  # noqa: BLE001
            print(f"[logger] wandb requested but unavailable ({e!r}); "
                  "continuing without it")
    return CompositeLogger(loggers)
