"""The port's UMT5 encoder, streaming Wan VAE and DAC decoder held against
the JAX package on the CPU, in fp32, at the tiny config.

Weights are the port's random modules read into JAX trees by the JAX
package's own checkpoint converters (which also checks the port's parameter
names). The Wan VAE runs at 5 and 9 frames, so the temporal caches carry
across one and two later chunks. Tolerance: 1e-4 relative (fp32 round-off
through a few dozen convolutions), with an absolute floor of 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.convert.load_checkpoint import _convert_wan_vae
from dualforce_tpu.convert.torch_import import convert_dac
from dualforce_tpu.models import dac_vae as jax_dac
from dualforce_tpu.models import umt5 as jax_umt5
from dualforce_tpu.models import wan_vae as jax_wan

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.models import dac_vae, umt5, wan_vae
from dualforce_tpu_torch.models.factory import _build
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = tiny_test_config()


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off: the same
    math, compiled in about two thirds of the time at these sizes. The
    setting is restored for the test files that follow."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _module(cls, cfg, seed=3):
    return _build(cls, cfg, torch.device("cpu"), torch.float32,
                  torch.Generator().manual_seed(seed))


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_umt5_encode():
    model = _module(umt5.UMT5Encoder, CFG.text_encoder)
    params = jax_umt5.convert_umt5(_sd(model), CFG.text_encoder)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG.text_encoder.vocab_size, (2, 40))
    mask = np.zeros((2, 40), np.int64)
    mask[0, :33], mask[1, :7] = 1, 1
    want = jax.jit(lambda p, i, m: jax_umt5.encode(p, CFG.text_encoder, i, m,
                                                   compute_dtype=jnp.float32))(
        params, ids, mask)
    got = umt5.encode(model, torch.from_numpy(ids), torch.from_numpy(mask),
                      compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def wan():
    vae = _module(wan_vae.WanVAE, CFG.video_vae)
    return vae, _convert_wan_vae(_sd(vae), CFG.video_vae)


@pytest.mark.parametrize("frames", [5, 9])
def test_wan_vae_encode_streaming(wan, frames):
    vae, params = wan
    video = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_wan.encode_mode_streaming(p, CFG.video_vae, x))(
        params, video)
    got = wan_vae.encode_mode_streaming(vae, torch.from_numpy(video))
    assert got.shape == want.shape == (1, (frames - 1) // 4 + 1, 4, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("frames", [5, 9])
def test_wan_vae_decode_streaming(wan, frames):
    vae, params = wan
    f = (frames - 1) // 4 + 1
    z = np.random.default_rng(10 + frames).standard_normal((1, f, 4, 4, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_wan.decode_streaming(p, CFG.video_vae, x))(params, z)
    got = wan_vae.decode_streaming(vae, torch.from_numpy(z))
    assert got.shape == want.shape == (1, frames, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wan_latent_normalisation():
    z = np.random.default_rng(1).standard_normal((1, 2, 3, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        wan_vae.normalize_latents(torch.from_numpy(z), CFG.video_vae).numpy(),
        np.asarray(jax_wan.normalize_latents(z, CFG.video_vae)), rtol=1e-6)
    np.testing.assert_allclose(
        wan_vae.denormalize_latents(torch.from_numpy(z), CFG.video_vae).numpy(),
        np.asarray(jax_wan.denormalize_latents(z, CFG.video_vae)), rtol=1e-6)


def test_dac_decode():
    vae = _module(dac_vae.DACVAE, CFG.audio_vae)
    with torch.no_grad():   # snake alphas away from 1, so the fp32 math is exercised
        for name, p in vae.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.5, 1.5)
    params = convert_dac(_sd(vae), CFG.audio_vae)
    z = np.random.default_rng(2).standard_normal((1, CFG.audio_vae.latent_dim, 5)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jax_dac.decode(p, CFG.audio_vae, x))(params, z)
    with torch.no_grad():
        got = dac_vae.decode(vae, torch.from_numpy(z))
    assert got.shape == want.shape == (1, 1, 5 * CFG.audio_vae.hop_length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
