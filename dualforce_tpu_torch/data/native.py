"""The C++ data kernels of `native/dfdata.cpp`, bound with ctypes (the
port's counterpart of `dualforce_tpu/data/native.py`).

The library is built with `g++` (or `$CXX`) from the repository's source,
at first use, into `build/dualforce_tpu_torch/` at the root of the
checkout, named by a hash of the source and the flags; nothing is written
into `native/`. The flags are the `native/Makefile`'s without `-fopenmp`:
the H100 machine's compiler has no OpenMP runtime (libgomp), and each
output element is computed on its own, so the values equal those of the
OpenMP build the JAX package makes; clips are read in parallel by the
prefetch threads instead (ctypes releases the GIL during each call).
A failed build raises: there is no silent fallback, since the dataset's
output depends on which path it takes (the C++ resize is bilinear, PIL's
LANCZOS, up to 0.06 apart on average). Each function has its plain version
beside it (`*_plain`): the PIL path through `data.transforms.crop_and_resize`
and the numpy ones. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from dualforce_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dfdata.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wno-unknown-pragmas",
             "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libdfdata-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is built already; raises on failure."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {SOURCE.name} needs a C++ compiler ({cxx}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i16p = ctypes.POINTER(ctypes.c_int16)
            lib.df_resize_crop_normalize.argtypes = [u8p, i64, i64, i64, i64, i64, f32p]
            lib.df_resize_crop_normalize.restype = None
            lib.df_pcm_resample.argtypes = [i16p, i64, i64, i64, f32p, i64]
            lib.df_pcm_resample.restype = i64
            lib.df_float_to_uint8.argtypes = [f32p, i64, u8p]
            lib.df_float_to_uint8.restype = None
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_crop_normalize(video_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, out_h, out_w, 3] float32 in [-1, 1]: an
    aspect-preserving bilinear scale to cover, a center crop, normalised."""
    video_u8 = np.ascontiguousarray(video_u8, np.uint8)
    if video_u8.ndim != 4 or video_u8.shape[-1] != 3 or min(video_u8.shape[:3]) < 1:
        raise ValueError(f"frames must be [T, H, W, 3], got {video_u8.shape}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_h}x{out_w}")
    t, h, w, _ = video_u8.shape
    out = np.empty((t, out_h, out_w, 3), np.float32)
    _load().df_resize_crop_normalize(_ptr(video_u8, ctypes.c_uint8), t, h, w, out_h, out_w,
                                     _ptr(out, ctypes.c_float))
    return out


def resize_crop_normalize_plain(video_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The PIL path: LANCZOS scale and center crop per frame, normalised."""
    from PIL import Image

    from dualforce_tpu_torch.data.transforms import crop_and_resize

    video_u8 = np.asarray(video_u8, np.uint8)
    out = np.empty((video_u8.shape[0], out_h, out_w, 3), np.float32)
    for i, frame in enumerate(video_u8):
        out[i] = np.asarray(crop_and_resize(Image.fromarray(frame), out_h, out_w),
                            np.float32) / 127.5 - 1.0
    return out


def pcm_resample(pcm_i16: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1], linearly resampled sr_in -> sr_out."""
    pcm_i16 = np.ascontiguousarray(pcm_i16, np.int16).reshape(-1)
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"sample rates {sr_in}, {sr_out}")
    cap = int(np.ceil(len(pcm_i16) * sr_out / sr_in)) + 1
    out = np.empty((cap,), np.float32)
    n = _load().df_pcm_resample(_ptr(pcm_i16, ctypes.c_int16), len(pcm_i16), sr_in, sr_out,
                                _ptr(out, ctypes.c_float), cap)
    return out[:n]


def pcm_resample_plain(pcm_i16: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """numpy: `/ 32768`, then `np.interp` onto the new rate's sample times."""
    f = np.asarray(pcm_i16, np.int16).reshape(-1).astype(np.float32) / 32768.0
    if sr_in == sr_out:
        return f
    t_old = np.arange(len(f)) / sr_in
    t_new = np.arange(int(len(f) * sr_out / sr_in)) / sr_out
    return np.interp(t_new, t_old, f).astype(np.float32)


def float_to_uint8(video_f32: np.ndarray) -> np.ndarray:
    """float video in [-1, 1] -> uint8, (x + 1) * 127.5 rounded half up,
    clamped to [0, 255]."""
    video_f32 = np.ascontiguousarray(video_f32, np.float32)
    out = np.empty(video_f32.shape, np.uint8)
    _load().df_float_to_uint8(_ptr(video_f32, ctypes.c_float), video_f32.size,
                              _ptr(out, ctypes.c_uint8))
    return out


def float_to_uint8_plain(video_f32: np.ndarray) -> np.ndarray:
    """numpy: clip to [-1, 1], scale, round half to even."""
    return ((np.clip(np.asarray(video_f32, np.float32), -1, 1) + 1) * 127.5).round().astype(
        np.uint8)
