"""The one-pass and sampled VAE encodes on the CPU in fp32 at the tiny config,
against the JAX package on the same weights: the Wan VAE's
`encode_moments`, `encode_mode`, `encode_sample`, `encode_moments_streaming`
and `encode_sample_streaming`, and the DAC's `encode_moments`,
`encode_mode` and `encode_sample`. The sampled encodes take JAX's own draw,
`jax.random.normal(key, shape)`, as their noise. Tolerance as
`tests/test_torch_encoders.py`: 1e-4 relative, 1e-5 absolute. The streaming
mode encode stays the mean of the streaming moments, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from dualforce_tpu.convert.load_checkpoint import _convert_wan_vae
from dualforce_tpu.convert.torch_import import convert_dac
from dualforce_tpu.models import dac_vae as jax_dac
from dualforce_tpu.models import wan_vae as jax_wan

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.models import dac_vae, wan_vae

from test_torch_encoders import _module, _sd
from test_torch_streamed import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = tiny_test_config()
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wan_vae_encodes_match_jax():
    vae = _module(wan_vae.WanVAE, CFG.video_vae)
    params = _convert_wan_vae(_sd(vae), CFG.video_vae)
    video = np.random.default_rng(9).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    tv, c = torch.from_numpy(video), CFG.video_vae
    for name, one_pass in (("encode_moments", True), ("encode_moments_streaming", False)):
        mean, logvar = getattr(wan_vae, name)(vae, tv)
        jmean, jlogvar = jax.jit(lambda p, x, f=getattr(jax_wan, name): f(p, c, x))(params,
                                                                                   video)
        assert mean.shape == jmean.shape == (1, 3, 4, 4, 16)
        _close(mean, jmean)
        _close(logvar, jlogvar)
        noise = jax.random.normal(KEY, jmean.shape, jmean.dtype)
        sample = (wan_vae.encode_sample(vae, tv, torch.from_numpy(np.array(noise)))
                  if one_pass else
                  wan_vae.encode_sample_streaming(vae, tv, torch.from_numpy(np.array(noise))))
        jfn = jax_wan.encode_sample if one_pass else jax_wan.encode_sample_streaming
        _close(sample, jax.jit(lambda p, x: jfn(p, c, x, KEY))(params, video))
        mode = wan_vae.encode_mode(vae, tv) if one_pass else wan_vae.encode_mode_streaming(vae,
                                                                                         tv)
        assert torch.equal(mode, mean)
    g = torch.Generator().manual_seed(0)
    drawn = wan_vae.encode_sample_streaming(vae, tv, generator=g)
    mean, logvar = wan_vae.encode_moments_streaming(vae, tv)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(drawn, mean + torch.exp(0.5 * logvar.clamp(-30, 20))
                       * torch.randn(mean.shape, generator=g))


def test_dac_encodes_match_jax():
    vae = _module(dac_vae.DACVAE, CFG.audio_vae)
    params = convert_dac(_sd(vae), CFG.audio_vae)
    c = CFG.audio_vae
    audio = np.random.default_rng(3).uniform(-0.5, 0.5, (1, 1, 5 * c.hop_length - 7)
                                             ).astype(np.float32)
    ta = torch.from_numpy(audio)
    mean, logvar = dac_vae.encode_moments(vae, ta)
    jmean, jlogvar = jax.jit(lambda p, x: jax_dac.encode_moments(p, c, x))(params, audio)
    _close(mean, jmean)
    _close(logvar, jlogvar)
    assert torch.equal(dac_vae.encode_mode(vae, ta), mean)
    noise = np.array(jax.random.normal(KEY, jmean.shape, jmean.dtype))
    _close(dac_vae.encode_sample(vae, ta, torch.from_numpy(noise)),
           jax.jit(lambda p, x: jax_dac.encode_sample(p, c, x, KEY))(params, audio))
