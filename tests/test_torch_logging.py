"""The port's metric loggers against the JAX package's (`engine/logging.py`).

`build_logger` of both packages, for every kind JAX's takes and for a
non-main rank, with a recording stand-in for `wandb` and without any:
the same sinks, byte-equal JSONL files (the clock pinned), the same calls
into `wandb`, and the same fallback where `wandb` cannot be imported. Then
a training config with `logger="wandb"` trains in the port.
"""

import sys
import time
import types

import numpy as np
import pytest
import torch

from dualforce_tpu.engine import logging as jlog
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.engine import logging as tlog
from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

METRICS = [({"loss": 0.123456789, "lr": 1e-4, "grad_norm": 3}, 1),
           ({"loss": np.float32(0.25), "lr": 2e-4, "grad_norm": 2.5}, 2)]


def _fake_wandb(calls):
    """A `wandb` module that records init, log and the run's finish."""
    mod = types.ModuleType("wandb")

    def init(**kw):
        calls.append(("init", kw))
        return types.SimpleNamespace(finish=lambda: calls.append(("finish", {})))

    mod.init = init
    mod.log = lambda data, step=None: calls.append(("log", {"data": data, "step": step}))
    return mod


def _sinks(logger):
    if isinstance(logger, (jlog.CompositeLogger, tlog.CompositeLogger)):
        return [type(x).__name__ for x in logger.loggers]
    return [type(logger).__name__]


def _run(pkg, kind, is_main, log_dir):
    logger = pkg.build_logger(kind, str(log_dir), is_main=is_main)
    for metrics, step in METRICS:
        logger.log_scalars(metrics, step)
    logger.close()
    return _sinks(logger)


@pytest.mark.parametrize("wandb", ["fake", "absent"])
@pytest.mark.parametrize("kind,is_main", [
    (None, True), ("none", True), ("jsonl", True), ("tensorboard", True), ("wandb", True),
    ("both", True), ("other", True), ("both", False),
])
def test_build_logger_matches_jax(kind, is_main, wandb, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    calls = {"jax": [], "port": []}
    out = {}
    for name, pkg in (("jax", jlog), ("port", tlog)):
        monkeypatch.setitem(sys.modules, "wandb",
                            _fake_wandb(calls[name]) if wandb == "fake" else None)
        capsys.readouterr()
        sinks = _run(pkg, kind, is_main, tmp_path / name)
        for call, kw in calls[name]:        # each package logs under its own directory
            if call == "init":
                assert kw.pop("dir") == str(tmp_path / name)
        out[name] = (sinks, capsys.readouterr().out.replace("dualforce_tpu_torch", "X")
                     .replace("dualforce_tpu", "X"))
    assert out["port"] == out["jax"]
    sinks, printed = out["port"]
    want = (["DummyLogger"] if kind in (None, "none") or not is_main else
            ["JsonlLogger"] + (["TensorBoardLogger"] if kind in ("tensorboard", "both") else [])
            + (["WandbLogger"] if kind in ("wandb", "both") and wandb == "fake" else []))
    assert sinks == want
    assert ("wandb requested but unavailable" in printed) == (
        wandb == "absent" and is_main and kind in ("wandb", "both"))
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == (
        ["init", "log", "log", "finish"] if "WandbLogger" in want else [])
    files = [tmp_path / name / "metrics.jsonl" for name in ("jax", "port")]
    assert files[0].is_file() == files[1].is_file() == ("JsonlLogger" in want)
    if "JsonlLogger" in want:
        assert files[1].read_bytes() == files[0].read_bytes()


def test_wandb_trainer_config_trains(tmp_path, monkeypatch):
    """`logger="wandb"` (JAX's trainer takes it) builds the W&B sink beside
    JSONL in `LoRATrainer` and logs a step through both."""
    calls = []
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls))
    cfg = tiny_test_config()
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    tcfg = TrainerConfig(max_steps=1, warmup_steps=1, save_interval=100, log_interval=1,
                         save_dir=str(tmp_path), logger="wandb", lora_rank=2,
                         compute_dtype=torch.float32, attn_impl="ref", remat=False, lr=1e-3)
    trainer = LoRATrainer(cfg, mods, tcfg, device="cpu")
    assert _sinks(trainer.logger) == ["JsonlLogger", "WandbLogger"]
    rng = np.random.default_rng(0)
    mask = np.ones((1, 64), np.int64)
    mask[:, 40:] = 0
    batch = {"video": rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32),
             "audio": rng.uniform(-0.3, 0.3, (1, 1, 10000)).astype(np.float32),
             "text_ids": rng.integers(2, 500, (1, 64)), "text_mask": mask}
    assert trainer.train(iter([batch])) == 1
    trainer.logger.close()
    logged = [c[1] for c in calls if c[0] == "log"]
    assert calls[0][0] == "init" and calls[-1][0] == "finish"
    assert [x["step"] for x in logged] == [1] and np.isfinite(logged[0]["data"]["loss"])
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 1
