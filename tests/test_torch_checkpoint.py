"""The port's checkpoint loader (`convert/load_checkpoint.py`) against the JAX
package's, on the CPU at the tiny config.

A fixture writes an HF-layout checkpoint from the port's random fp32 modules
with the port's writer; the DAC's convolutions are stored weight-normed
with a per-channel scale folded into `weight_v`, so the fold has work to do.
The JAX package reads the same directory (it reads F32 safetensors through
`safetensors.numpy`, which cannot read BF16), and `convert.from_jax` carries
its tree back to the port's names. The port's loaded modules must equal it:
exactly (the DAC's folded weights, fp32 sums in another order, within 1e-6
relative), in bf16 byte for byte as `cast_tree` rounds, and in fp8 byte for
byte as `cast_tree_fp8` casts values in range. The port's safetensors
reader and writer are held against `safetensors.torch` on every dtype the
port reads.
"""

import dataclasses
import json
import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.convert import load_checkpoint as jax_lc

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

FOLD_REL_TOL = 1e-6


def _rewrite(path, edit):
    """Read a safetensors file, apply `edit` to its dict, write it back."""
    sd, meta = lc.read_safetensors(path)
    sd = {k: v.clone() for k, v in sd.items()}
    edit(sd)
    lc.save_state_dict(sd, path, meta)


def _scale_weight_v(sd):
    """weight_v *= a positive scale per dim-0 channel: the folded weight is
    unchanged, a loader that ignored weight_g would not be."""
    rng = np.random.default_rng(3)
    for k in [k for k in sd if k.endswith(".weight_v")]:
        s = rng.uniform(0.5, 2.0, (sd[k].shape[0], 1, 1)).astype(np.float32)
        sd[k] = sd[k] * torch.from_numpy(s)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = dataclasses.replace(tiny_test_config(), boundary_ratio=0.875)
    source = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    root = tmp_path_factory.mktemp("ckpt")
    lc.save_pipeline_params(source, cfg, str(root))
    _rewrite(str(root / "audio_vae" / "model.safetensors"), _scale_weight_v)
    return dict(cfg=cfg, source=source, root=root)


def _variant(ckpt, tmp_path, name):
    """A copy of the fixture with one optional piece taken away."""
    d = tmp_path / name
    shutil.copytree(ckpt["root"], d, ignore=(shutil.ignore_patterns("video_dit_2")
                                             if name == "one_expert" else None))
    if name == "no_text_config":
        os.remove(d / "text_encoder" / "config.json")
    elif name == "no_model_index":
        os.remove(d / "model_index.json")
    elif name == "no_quant_conv":
        _rewrite(str(d / "video_vae" / "model.safetensors"),
                 lambda sd: [sd.pop(k) for k in list(sd) if "quant_conv." in k])
    return str(d)


@pytest.mark.parametrize("variant", ["full", "no_text_config", "no_model_index",
                                     "one_expert"])
def test_config_matches_jax(ckpt, tmp_path, variant):
    d = _variant(ckpt, tmp_path, variant)
    got = dataclasses.asdict(lc.config_from_checkpoint(d))
    assert got == dataclasses.asdict(jax_lc.config_from_checkpoint(d))
    if variant == "full":
        assert got == dataclasses.asdict(ckpt["cfg"])


def _jax_state_dicts(d, cfg, dtype):
    params = jax_lc.load_pipeline_params(d, dtype=dtype, to_device=False)
    return from_jax.state_dicts(params, cfg)


def _assert_module_equal(name, module, want):
    got = module.state_dict()
    assert set(got) == set(want), name
    for k, v in got.items():
        w = np.asarray(want[k])
        if w.dtype.name.startswith("float8"):
            assert v.dtype in (torch.float8_e4m3fn, torch.float8_e5m2), (name, k)
            np.testing.assert_array_equal(v.view(torch.uint8).numpy(),
                                          np.ascontiguousarray(w).view(np.uint8),
                                          err_msg=f"{name}.{k}")
            continue
        assert v.dtype not in (torch.float8_e4m3fn, torch.float8_e5m2), (name, k)
        got32 = v.float().numpy()
        if name == "audio_vae" and k.endswith(".weight"):
            rel = np.abs(got32 - w).max() / np.abs(w).max()
            assert rel <= FOLD_REL_TOL, (k, rel)
        else:
            np.testing.assert_array_equal(got32, w, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("variant", ["full", "no_quant_conv"])
def test_fp32_load_matches_jax(ckpt, tmp_path, variant):
    d = _variant(ckpt, tmp_path, variant)
    cfg = lc.config_from_checkpoint(d)
    want = _jax_state_dicts(d, cfg, jnp.float32)
    modules = lc.load_pipeline_params(d, cfg, dtype=torch.float32, device="cpu")
    assert list(modules) == list(want)
    for name, module in modules.items():
        _assert_module_equal(name, module, want[name])
    if variant == "full":   # and the folded DAC is the module it was written from
        src = ckpt["source"]
        for name, module in modules.items():
            for k, v in module.state_dict().items():
                s = src[name].state_dict()[k]
                if name == "audio_vae":
                    assert float((v - s).abs().max() / s.abs().max()) <= FOLD_REL_TOL, k
                else:
                    assert torch.equal(v, s), (name, k)
    else:
        eye = modules["video_vae"].quant_conv.weight
        assert torch.equal(eye.reshape(eye.shape[0], -1), torch.eye(eye.shape[0]))


def test_bf16_and_fp8_loads_match_jax_casts(ckpt):
    d, cfg = str(ckpt["root"]), ckpt["cfg"]
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float8_e4m3fn, jnp.float8_e4m3fn)):
        want = _jax_state_dicts(d, cfg, jdtype)
        modules = lc.load_pipeline_params(d, cfg, dtype=dtype, device="cpu")
        for name, module in modules.items():
            _assert_module_equal(name, module, want[name])
        fp8 = {n for n, m in modules.items()
               if any(p.dtype == torch.float8_e4m3fn for p in m.parameters())}
        assert fp8 == (set() if dtype == torch.bfloat16 else
                       {"video_dit", "video_dit_2", "audio_dit", "bridge", "text_encoder"})


def test_bf16_file_matches_jax(ckpt, tmp_path):
    """A checkpoint written in bf16 (towers and UMT5; the VAEs stay fp32)
    loads bit-equal to the bf16 modules it was written from, and equal to
    the JAX package's load of it: `safetensors.numpy` reads BF16 once
    ml_dtypes has registered the type with numpy, which importing jax does."""
    d, cfg = str(tmp_path / "bf16"), ckpt["cfg"]
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    lc.save_pipeline_params(modules, cfg, d)
    with open(os.path.join(d, "video_dit", "model.safetensors"), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        assert {e["dtype"] for k, e in json.loads(f.read(n)).items()} == {"BF16"}
    loaded = lc.load_pipeline_params(d, cfg, dtype=torch.bfloat16, device="cpu")
    want = _jax_state_dicts(d, cfg, jnp.bfloat16)
    for name, module in loaded.items():
        _assert_module_equal(name, module, want[name])
        if name not in ("video_vae", "audio_vae"):
            for k, v in module.state_dict().items():
                assert v.dtype == torch.bfloat16
                assert torch.equal(v, modules[name].state_dict()[k]), (name, k)


def test_checkpoint_name_variants_and_strictness(ckpt, tmp_path, capsys):
    """UMT5's embedding stored as `encoder.embed_tokens.weight`, the Wan VAE's
    gammas stored flat with a scalar norm bias, an extra tensor: all load
    (the extras listed on one line); a missing tensor raises."""
    d = _variant(ckpt, tmp_path, "names")
    cfg = ckpt["cfg"]

    def rename_embed(sd):
        sd["encoder.embed_tokens.weight"] = sd.pop("shared.weight")

    def flatten_gammas(sd):
        for k in [k for k in sd if k.endswith(".gamma")]:
            sd[k] = sd[k].reshape(-1).clone()
        sd["encoder.head.0.bias"] = torch.zeros(())

    _rewrite(os.path.join(d, "text_encoder", "model.safetensors"), rename_embed)
    _rewrite(os.path.join(d, "video_vae", "model.safetensors"), flatten_gammas)
    _rewrite(os.path.join(d, "dual_tower_bridge", "model.safetensors"),
             lambda sd: sd.update(condition_scale=torch.ones(1)))
    for name in ("text_encoder", "video_vae", "bridge"):
        got = lc.load_module(d, name, cfg, torch.float32, "cpu").state_dict()
        for k, v in ckpt["source"][name].state_dict().items():
            assert torch.equal(got[k], v), (name, k)
    out = capsys.readouterr().out
    assert "encoder.head.0.bias" in out and "condition_scale" in out

    _rewrite(os.path.join(d, "dual_tower_bridge", "model.safetensors"),
             lambda sd: sd.pop("audio_to_video_conditioners.0.inner.q.weight"))
    with pytest.raises(KeyError, match="inner.q.weight"):
        lc.load_module(d, "bridge", cfg, torch.float32, "cpu")


# --- the safetensors format ---------------------------------------------------

READ_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn,
               torch.float8_e5m2, torch.int8, torch.uint8, torch.int32, torch.int64]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dtype in enumerate(READ_DTYPES):
        x = torch.randn(3, 5 + i, generator=g) * 10
        out[f"t.{i}.{str(dtype)[6:]}"] = x.to(dtype) if dtype.is_floating_point else \
            x.round().clamp(0 if dtype == torch.uint8 else -100, 100).to(dtype)
    out["odd.bf16"] = torch.randn(7, generator=g).bfloat16()   # 14 bytes: next one unaligned
    out["empty"] = torch.zeros(0, 4)
    out["scalar"] = torch.tensor(2.5)
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k


def test_reader_matches_safetensors_torch(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    want = _tensors()
    path = str(tmp_path / "a.safetensors")
    st.save_file(want, path, metadata={"format": "pt", "note": "x"})
    got, meta = lc.read_safetensors(path)
    _assert_same(got, want)
    assert meta == {"format": "pt", "note": "x"}
    # two shards of one module directory
    d = tmp_path / "module"
    d.mkdir()
    other = {k + ".b": v for k, v in _tensors(1).items()}
    st.save_file(want, str(d / "model-00001-of-00002.safetensors"))
    st.save_file(other, str(d / "model-00002-of-00002.safetensors"))
    _assert_same(lc.load_state_dict(str(d)), {**want, **other})


def test_writer_round_trips_through_safetensors_torch(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    from safetensors import safe_open

    want = _tensors(2)
    path = str(tmp_path / "w.safetensors")
    nbytes = lc.save_state_dict(want, path, metadata={"step": 3})
    assert nbytes == sum(v.numel() * v.element_size() for v in want.values())
    _assert_same(st.load_file(path), want)
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"step": "3"}
    _assert_same(lc.read_safetensors(path)[0], want)


def test_reader_copies_misaligned_tensors(tmp_path):
    """A header whose length leaves the data section off a 4-byte boundary
    (allowed by the format, not written by the reference writer)."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) - 2.5
    y = torch.arange(3, dtype=torch.int64) * 7
    header = json.dumps({"x": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]},
                         "y": {"dtype": "I64", "shape": [3], "data_offsets": [24, 48]}}).encode()
    header += b" " * ((3 - len(header)) % 8)     # 8 + len(header) = 3 mod 8
    path = tmp_path / "m.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + x.numpy().tobytes()
                     + y.numpy().tobytes())
    got, _ = lc.read_safetensors(str(path))
    assert torch.equal(got["x"], x) and torch.equal(got["y"], y)
    assert got["x"].data_ptr() % 4 == 0 and got["y"].data_ptr() % 8 == 0


def test_torch_bin_fallback(tmp_path):
    want = {"a": torch.randn(3, 2), "b": torch.arange(4)}
    torch.save(want, tmp_path / "pytorch_model.bin")
    _assert_same(lc.load_state_dict(str(tmp_path)), want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        lc.load_state_dict(str(tmp_path / "empty"))
