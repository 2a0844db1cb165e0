"""The disk-backed store (`convert/disk_store.py`, `--offload_to_disk_path`) on
the CPU: fp32, bf16 and fp8 tensors round-trip bit for bit as read-only
memmaps; the JAX package's `load_params_mmap_from_manifest` reads the port's
store, every leaf bit-equal to the port's tensor (one layout); `store_matches`
decides as the JAX package's does; and a tiny CLI request from the store
under `--offload component` gives the bits of the same request without it.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dualforce_tpu.convert import disk_store as jax_store

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.cli import inference_single as cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import disk_store
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_pipeline import FakeTokenizer
from test_torch_streamed import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def modules():
    """A bf16 bridge, an fp8-stored audio tower and an fp32 DAC."""
    cfg = tiny_test_config()
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.bfloat16, seed=0,
                                with_text=False, two_video_towers=False)
    fp8 = init_pipeline_params(cfg, device="cpu", dtype=torch.float8_e4m3fn, seed=1,
                               with_vaes=False, with_text=False, two_video_towers=False)
    return cfg, {"bridge": mods["bridge"], "audio_dit": fp8["audio_dit"],
                 "audio_vae": mods["audio_vae"]}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.uint8).numpy()


def test_round_trip_bit_equal(modules, tmp_path):
    cfg, mods = modules
    store = str(tmp_path / "store")
    disk_store.save_params_to_dir(mods, store, fingerprint="src")
    dtypes = {t.dtype for m in mods.values() for t in m.state_dict().values()}
    assert {torch.float32, torch.bfloat16, torch.float8_e4m3fn} <= dtypes
    loaded = disk_store.load_params_mmap_from_manifest(store)
    assert set(loaded) == set(mods)
    for name, m in mods.items():
        sd = m.state_dict()
        assert set(loaded[name]) == set(sd)
        for k, t in sd.items():
            got = loaded[name][k]
            assert got.dtype == t.dtype and got.shape == t.shape
            np.testing.assert_array_equal(_bits(got), _bits(t), err_msg=k)
    rebuilt = disk_store.load_modules_mmap(store, cfg)
    assert any(isinstance(x, dnn.Fp8Linear) for x in rebuilt["audio_dit"].modules())
    for name, m in mods.items():
        for (k, a), (k2, b) in zip(m.state_dict().items(), rebuilt[name].state_dict().items()):
            assert k == k2 and a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def test_jax_reads_the_port_store(modules, tmp_path):
    _, mods = modules
    store = str(tmp_path / "store")
    disk_store.save_params_to_dir(mods, store)
    tree = jax_store.load_params_mmap_from_manifest(store)
    for name, m in mods.items():
        for k, t in m.state_dict().items():
            leaf = tree[name][k]
            assert leaf.dtype.name == str(t.dtype).removeprefix("torch."), k
            np.testing.assert_array_equal(np.asarray(leaf).reshape(-1).view(np.uint8),
                                          _bits(t).reshape(-1), err_msg=k)


def test_store_matches_as_jax(modules, tmp_path):
    """The same answers for the same stores and templates: no store, the
    fingerprint alone (equal, different, none), the template (equal, a
    shape changed, a dtype changed, a key missing)."""
    _, mods = modules
    store = str(tmp_path / "store")

    def jax_tree(ms):
        out = {}
        for n, m in ms.items():
            out[n] = {}
            for k, t in m.state_dict().items():
                arr, name = disk_store._storable(t)
                out[n][k] = arr.view(jax_store._resolve_dtype(name)) if arr.dtype.name != name \
                    else arr
        return out

    def both(template, fp):
        port = disk_store.store_matches(template, store, fingerprint=fp)
        jax = jax_store.store_matches(None if template is None else jax_tree(template),
                                      store, fingerprint=fp)
        assert port == jax
        return port

    assert both(mods, None) is False and both(None, "src") is False
    disk_store.save_params_to_dir(mods, store, fingerprint="src")
    assert both(None, "src") is True
    assert both(None, "other") is False
    assert both(None, None) is False
    assert both(mods, None) is True and both(mods, "src") is True
    shrunk = {"bridge": torch.nn.Linear(3, 2)}
    assert both(shrunk, None) is False
    fp32 = init_pipeline_params(tiny_test_config(), device="cpu", dtype=torch.float32,
                                seed=0, with_vaes=False, with_text=False,
                                two_video_towers=False)["bridge"]
    assert both(dict(mods, bridge=fp32), None) is False
    assert both({n: m for n, m in mods.items() if n != "bridge"}, None) is False
    with open(os.path.join(store, "manifest.json"), "w") as f:
        f.write("{not json")
    assert both(None, "src") is False


def test_cli_component_from_store_bit_equal(tmp_path, capsys):
    """`--offload component --offload_to_disk_path DIR`: the first run
    exports the store, a repeat run reads the manifest alone (no export);
    both give the bits of the request without the store. The flag without
    --offload exits as the JAX CLI does."""
    cfg = tiny_test_config()
    ckpt = tmp_path / "ckpt"
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(ckpt))
    png = tmp_path / "ref.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (32, 32, 3), np.uint8)).save(png)
    base = ["--ckpt_path", str(ckpt), "--ref_path", str(png), "--prompt", "a cat",
            "--height", "32", "--width", "32", "--num_frames", "5",
            "--num_inference_steps", "2", "--attn_type", "ref", "--device", "cpu"]

    def run(extra):
        return cli.run(cli.parse_args(base + extra), tokenizer=FakeTokenizer(),
                       dtype=torch.float32)[0]

    want = run([])
    store = str(tmp_path / "store")
    for said in ("exporting params", "matches the checkpoint; no export"):
        capsys.readouterr()
        got = run(["--offload", "component", "--offload_to_disk_path", store])
        assert said in capsys.readouterr().out
        np.testing.assert_array_equal(got.video, want.video)
        np.testing.assert_array_equal(got.audio, want.audio)
    with open(os.path.join(store, "manifest.json")) as f:
        assert json.load(f)["fingerprint"] == f"{ckpt}|bf16|" + "%.0f" % max(
            os.path.getmtime(ckpt / e) for e in os.listdir(ckpt))
    with pytest.raises(SystemExit, match="requires --offload"):
        run(["--offload_to_disk_path", store])
