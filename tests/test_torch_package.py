"""Package-level checks of the PyTorch port: it stands alone from JAX and
from the JAX package, its config copy equals the JAX package's, and its
entry points refuse a missing CUDA device instead of falling back."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dualforce_tpu import config as jax_config

from dualforce_tpu_torch import config, resolve_device

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "dualforce_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", "dualforce_tpu"))


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    """Every module of the package (and chip_smoke.py) imported in a fresh
    process: no jax and no dualforce_tpu module may be loaded. (The test
    process itself has JAX loaded by conftest.py, hence the subprocess.)"""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dualforce_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'dualforce_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dualforce_tpu' or m.startswith('dualforce_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    """Imports anywhere in the source, function bodies included."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


@pytest.mark.parametrize("make", ["mova_360p", "tiny_test_config"])
def test_config_copy_equals_the_jax_package(make):
    assert dataclasses.asdict(getattr(config, make)()) == \
        dataclasses.asdict(getattr(jax_config, make)())


def test_tiny_config_arguments_match():
    kw = dict(visual_layers=4, audio_layers=3, interaction_strategy="distributed",
              apply_cross_rope=False)
    assert dataclasses.asdict(config.tiny_test_config(**kw)) == \
        dataclasses.asdict(jax_config.tiny_test_config(**kw))


def test_cuda_is_never_assumed():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
