"""A Wan-VAE checkpoint whose RMS norms carry per-channel biases, on the
CPU in fp32 at the tiny config: the port's loader
(`convert/load_checkpoint.load_module`) and the JAX package's
(`load_state_dict` + `_convert_wan_vae`) read the same files, and the
port's streaming encode and decode match JAX's on them at
`tests/test_torch_encoders.py`'s tolerance (1e-4 relative, 1e-5 absolute).
The biases are nonzero and differ per channel. Also: the port writes the
biases back (`save_pipeline_params`) and carries them from a JAX tree
(`convert/from_jax`); a checkpoint that gives only some norms a bias loads
the others with zeros, as JAX's adds none; a scalar norm bias is dropped by
both loaders, as before.
"""

import jax
import numpy as np
import pytest
import torch

from dualforce_tpu.convert import load_checkpoint as jax_lc
from dualforce_tpu.models import wan_vae as jax_wan

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.models import wan_vae
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = tiny_test_config()
VCFG = CFG.video_vae


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _norm_biases(vae):
    params = dict(vae.named_parameters())
    return {n: p for n, p in params.items()
            if n.endswith(".bias") and n[:-len(".bias")] + ".gamma" in params}


def _biased_vae(seed=5):
    vae = init_pipeline_params(CFG, device="cpu", dtype=torch.float32, seed=3,
                               with_text=False, vae_norm_bias=True)["video_vae"]
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in _norm_biases(vae).values():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return vae


def _write(vae, root, sd=None):
    lc.save_pipeline_params({"video_vae": vae}, CFG, str(root), index=False)
    if sd is not None:
        lc.save_state_dict(sd, str(root / "video_vae" / "model.safetensors"))
    return str(root / "video_vae")


@pytest.fixture(scope="module")
def biased(tmp_path_factory):
    vae = _biased_vae()
    root = tmp_path_factory.mktemp("vae_bias")
    path = _write(vae, root)
    loaded = lc.load_module(str(root), "video_vae", CFG, device="cpu")
    params = jax_lc._convert_wan_vae(jax_lc.load_state_dict(path), VCFG)
    return vae, loaded, params


def test_biases_load_in_both_packages(biased):
    vae, loaded, params = biased
    biases = _norm_biases(vae)
    norms = sum(isinstance(m, wan_vae.RMSNormCh) for m in vae.modules())
    assert len(biases) == norms == 52 and all(float(b.abs().min()) > 0 for b in biases.values())
    want = dict(vae.named_parameters())
    got = dict(loaded.named_parameters())
    assert set(got) == set(want)
    for k, p in want.items():
        assert torch.equal(got[k], p), k
    assert "bias" in params["encoder"]["head_norm"]
    np.testing.assert_array_equal(params["encoder"]["head_norm"]["bias"],
                                  biases["encoder.head.0.bias"].reshape(-1).numpy())
    # the JAX tree back into the port's module: the biases come across
    again = init_pipeline_params(CFG, device="cpu", dtype=torch.float32, seed=9,
                                 with_text=False, vae_norm_bias=True)["video_vae"]
    again.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           from_jax.wan_vae_state_dict(params, VCFG).items()}, strict=True)
    again = dict(again.named_parameters())
    for k, p in want.items():
        assert torch.equal(again[k], p), k


@pytest.mark.parametrize("frames", [5, 9])
def test_biased_encode_and_decode_match_jax(biased, frames):
    _, vae, params = biased
    video = np.random.default_rng(frames).uniform(-1, 1, (1, frames, 32, 32, 3)
                                                  ).astype(np.float32)
    mean, logvar = wan_vae.encode_moments_streaming(vae, torch.from_numpy(video))
    jmean, jlogvar = jax.jit(lambda p, x: jax_wan.encode_moments_streaming(p, VCFG, x))(
        params, video)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), **TOL)
    z = np.random.default_rng(10 + frames).standard_normal(mean.shape).astype(np.float32)
    want = jax.jit(lambda p, x: jax_wan.decode_streaming(p, VCFG, x))(params, z)
    got = wan_vae.decode_streaming(vae, torch.from_numpy(z))
    assert got.shape == want.shape == (1, frames, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the biases matter: the same weights without them decode elsewhere
    plain = init_pipeline_params(CFG, device="cpu", dtype=torch.float32, seed=3,
                                 with_text=False)["video_vae"]
    assert not np.allclose(wan_vae.decode_streaming(plain, torch.from_numpy(z)).numpy(),
                           np.asarray(want), **TOL)


def test_some_norms_biased_and_a_scalar_bias(tmp_path):
    """Only the head norms carry a bias, and the encoder's first norm a
    scalar one: the port loads zeros where JAX adds nothing and drops the
    scalar as JAX does; the encodes agree."""
    vae = _biased_vae(seed=8)
    biases = _norm_biases(vae)
    sd = {k: v for k, v in vae.state_dict().items() if k not in biases or ".head." in k}
    sd["encoder.downsamples.0.residual.0.bias"] = torch.tensor(0.0)
    path = _write(vae, tmp_path, sd)
    loaded = lc.load_module(str(tmp_path), "video_vae", CFG, device="cpu")
    params = jax_lc._convert_wan_vae(jax_lc.load_state_dict(path), VCFG)
    assert "bias" not in params["encoder"]["stages"][0]["blocks"][0]["norm1"]
    assert "bias" in params["decoder"]["head_norm"]
    for k, p in _norm_biases(loaded).items():
        assert torch.equal(p, biases[k] if ".head." in k else torch.zeros_like(p)), k
    video = np.random.default_rng(2).uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    mean, _ = wan_vae.encode_moments_streaming(loaded, torch.from_numpy(video))
    jmean, _ = jax.jit(lambda p, x: jax_wan.encode_moments_streaming(p, VCFG, x))(params,
                                                                                 video)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)


def test_unbiased_checkpoint_builds_no_bias(tmp_path):
    vae = init_pipeline_params(CFG, device="cpu", dtype=torch.float32, seed=3,
                               with_text=False)["video_vae"]
    assert not _norm_biases(vae)
    sd = dict(vae.state_dict(), **{"decoder.head.0.bias": torch.tensor(0.0)})
    _write(vae, tmp_path, sd)
    loaded = lc.load_module(str(tmp_path), "video_vae", CFG, device="cpu")
    assert not _norm_biases(loaded)
    got = dict(loaded.named_parameters())
    for k, p in vae.named_parameters():
        assert torch.equal(got[k], p), k
