"""Disk-backed parameter store for hosts short of memory (counterpart of
`dualforce_tpu/convert/disk_store.py`, the reference's
`--offload_to_disk_path`).

Every tensor of the pipeline's modules is saved as one `.npy` file and
loaded back as a read-only memmap, so the host holds page cache instead of
the weights, and `MOVAPipeline(offload="component" | "group")` stages each
module or layer group from disk to the card for its phase. The staging
copies then read pageable memory: the user asked for a memmap, and a memmap
is not page-locked (`offload.to_host` is the page-locked path, and it still
raises when locking fails).

Layout, the JAX package's: <dir>/manifest.json
    {"fingerprint": <the source's id>,
     "leaves": {key: {"file", "shape", "dtype"}}}
plus one .npy per tensor. A key is "{module}/{state-dict name}"
(`video_dit/blocks.0.self_attn.q.weight`). bf16 and fp8 tensors are stored
as their raw bits (uint16, uint8) under their true dtype name; numpy has no
such dtypes, and the loader views the bits back with torch. The manifest is
written last, so an export cut short never matches. A repeat run reads the
manifest alone (`store_matches` on the fingerprint) and never loads the
checkpoint into host memory.
"""

from __future__ import annotations

import json
import os
import re
import time
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# torch dtypes numpy lacks, stored as same-width unsigned integers
_RAW = {torch.bfloat16: ("bfloat16", np.uint16), torch.float16: ("float16", np.uint16),
        torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8),
        torch.float8_e5m2: ("float8_e5m2", np.uint8)}
_BY_NAME = {name: dtype for dtype, (name, _) in _RAW.items()}
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64, torch.int8: np.int8,
          torch.uint8: np.uint8, torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.bool: np.bool_}


def _dtype_name(dtype: torch.dtype) -> str:
    return _RAW[dtype][0] if dtype in _RAW else np.dtype(_NUMPY[dtype]).name


def _storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array to save, the tensor's true dtype name)."""
    t = t.detach().contiguous().cpu()
    if t.dtype in _RAW:
        arr = t.view(torch.uint8).numpy().view(_RAW[t.dtype][1]).reshape(t.shape)
    else:
        arr = t.numpy()
    return arr, _dtype_name(t.dtype)


def _state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return module.state_dict(keep_vars=True)


def write_module(out_dir: str, name: str, module: nn.Module,
                 leaves: Dict[str, Dict[str, Any]]) -> int:
    """Write one module's tensors as `.npy` files under `out_dir` and add
    their records to `leaves`. Returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    total = 0
    for pname, t in _state(module).items():
        key = f"{name}/{pname}"
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key)[:180] + f".{len(leaves)}.npy"
        arr, dtype_name = _storable(t)
        np.save(os.path.join(out_dir, fname), arr, allow_pickle=False)
        leaves[key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype_name}
        total += arr.nbytes
    return total


def write_manifest(out_dir: str, leaves: Dict[str, Dict[str, Any]],
                   fingerprint: Optional[str] = None) -> None:
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"fingerprint": fingerprint, "leaves": leaves}, f)


def save_params_to_dir(modules: Mapping[str, nn.Module], out_dir: str,
                       fingerprint: Optional[str] = None) -> str:
    """Write every tensor of `modules` and then the manifest. `fingerprint`
    identifies the source (checkpoint path, weight dtype, mtime), so a later
    run can tell a stale store without loading the checkpoint."""
    leaves: Dict[str, Dict[str, Any]] = {}
    for name, module in modules.items():
        write_module(out_dir, name, module, leaves)
    write_manifest(out_dir, leaves, fingerprint)
    return out_dir


def _read_manifest(store_dir: str) -> Optional[Dict[str, Any]]:
    mpath = os.path.join(store_dir, "manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            return json.load(f)
    except json.JSONDecodeError:
        return None


def _load_leaf(store_dir: str, rec: Dict[str, Any]) -> torch.Tensor:
    """One record as a tensor viewing its read-only memmap."""
    mm = np.load(os.path.join(store_dir, rec["file"]), mmap_mode="r")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # torch warns that the memmap is read-only
        t = torch.from_numpy(mm)
    if rec["dtype"] in _BY_NAME:
        t = t.view(_BY_NAME[rec["dtype"]])
    return t


def load_params_mmap_from_manifest(store_dir: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {state-dict name: tensor}} from the manifest alone, each
    tensor a view of its read-only memmap."""
    manifest = _read_manifest(store_dir)
    if manifest is None:
        raise FileNotFoundError(f"no manifest.json under {store_dir}")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, rec in manifest["leaves"].items():
        module, _, pname = key.partition("/")
        out.setdefault(module, {})[pname] = _load_leaf(store_dir, rec)
    return out


def store_matches(modules: Optional[Mapping[str, nn.Module]], store_dir: str,
                  fingerprint: Optional[str] = None) -> bool:
    """Whether the store can stand in for this source. With a `fingerprint`
    it must match; with `modules` as well the key set and every stored
    shape and dtype, so that a store from other weights or another
    `--weight_dtype` is not reused; with neither, no store matches."""
    manifest = _read_manifest(store_dir)
    if manifest is None:
        return False
    if fingerprint is not None and manifest.get("fingerprint") != fingerprint:
        return False
    if modules is None:
        return fingerprint is not None
    want = {f"{n}/{p}": t for n, m in modules.items() for p, t in _state(m).items()}
    recs = manifest["leaves"]
    if set(want) != set(recs):
        return False
    return all(list(t.shape) == recs[key]["shape"] and _dtype_name(t.dtype) == recs[key]["dtype"]
               for key, t in want.items())


@torch.no_grad()
def load_modules_mmap(store_dir: str, cfg) -> Dict[str, nn.Module]:
    """The pipeline's modules (`load_checkpoint.MODULES` keys) with every
    parameter a view of the store's memmaps, in eval mode with no
    gradients; a module stored in fp8 is an fp8 module
    (`nn.cast_modules_fp8`), as the loader makes it."""
    from dualforce_tpu_torch import nn as dnn
    from dualforce_tpu_torch.convert.load_checkpoint import MODULES

    out = {}
    for name, sd in load_params_mmap_from_manifest(store_dir).items():
        _, cls, sub_cfg = MODULES[name]
        fp8 = [t.dtype for t in sd.values() if t.dtype in dnn.FP8_DTYPES]
        dtype = torch.bfloat16 if fp8 else next(iter(sd.values())).dtype
        with torch.device("meta"):
            module = cls(sub_cfg(cfg), dtype=dtype)
        module.load_state_dict(sd, strict=True, assign=True)
        if fp8:
            dnn.cast_modules_fp8(module, fp8[0])
        out[name] = module.eval().requires_grad_(False)
    return out


def export_checkpoint(ckpt_dir: str, cfg, dtype: torch.dtype, device, out_dir: str,
                      fingerprint: Optional[str] = None) -> Tuple[int, float]:
    """Write a checkpoint's modules as a store, one module at a time: each
    loaded on `device` (`load_checkpoint.load_module`, the CLI's dtypes),
    written and freed before the next. Returns (bytes, seconds)."""
    from dualforce_tpu_torch.convert.load_checkpoint import load_module, module_names

    t0 = time.perf_counter()
    leaves: Dict[str, Dict[str, Any]] = {}
    total = 0
    for name in module_names(ckpt_dir):
        module = load_module(ckpt_dir, name, cfg, dtype, device)
        total += write_module(out_dir, name, module, leaves)
        del module
    write_manifest(out_dir, leaves, fingerprint)
    return total, time.perf_counter() - t0
