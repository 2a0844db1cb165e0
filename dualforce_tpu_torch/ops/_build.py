"""Build the port's CUDA source into a shared library at first use.

`dualforce_tpu_torch/csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into
one shared library with a plain C interface, loaded with `ctypes`. The
library goes to `build/dualforce_tpu_torch/` at the root of the checkout,
named by a hash of the source, every header under `csrc/` (which the sources
include) and the flags (`build_key`): an edited source, header or flag builds
anew, an unchanged one is reused. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dualforce_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path        # the shared library
    seconds: float    # nvcc wall time; 0.0 when an earlier build was reused
    log: str          # nvcc's output (ptxas registers, shared memory, spills)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_key(name: str, csrc: Optional[Path] = None) -> str:
    """The hash that names `<csrc>/<name>.cu`'s library (`csrc` defaults to
    `CSRC`): the flags, the source and every `*.cuh` header beside it (by name
    and bytes, in name order), so that an edited header builds every source
    anew."""
    csrc = CSRC if csrc is None else csrc
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Build `csrc/<name>.cu` unless it is built already. Raises on a failed
    build."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}-{build_key(name)}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return Built(lib, 0.0, log_path.read_text() if log_path.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    log_path.write_text(proc.stdout)
    os.replace(tmp, lib)
    return Built(lib, seconds, proc.stdout)


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The named library, built if needed and loaded once per process."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return _LOADED[name]
