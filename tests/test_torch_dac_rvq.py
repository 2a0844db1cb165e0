"""The DAC's discrete mode and the windowed compress/decompress
(`models/dac_vae.py`) on the CPU in fp32, against the JAX package on the
same weights (the port's modules read by JAX's own converter).

A narrow RVQ DAC (rates (2, 3), 3 codebooks of 16 x 4): `rvq_apply`'s codes
equal JAX's and z_q, latents and losses within 1e-5, with all stages, a
static count and a per-item count; `encode_quantized` and `decode_codes`
likewise (audio within 1e-5); the receptive-field integers equal for three
configs. `compress` and `decompress` with windows forced (chunks of 4
frames): in both modes equal to JAX's and to the one-pass encode and decode
(codes exactly, values within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.config import DACVAEConfig as JaxDACConfig
from dualforce_tpu.convert.torch_import import convert_dac
from dualforce_tpu.models import dac_vae as jax_dac

from dualforce_tpu_torch.config import DACVAEConfig, tiny_test_config
from dualforce_tpu_torch.models import dac_vae
from dualforce_tpu_torch.models.factory import _build

from test_torch_streamed import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(encoder_dim=4, encoder_rates=(2, 3), decoder_dim=16, decoder_rates=(3, 2),
              latent_dim=8, continuous=False, n_codebooks=3, codebook_size=16, codebook_dim=4)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _pair(cfg_kw, seed=3):
    cfg, jcfg = DACVAEConfig(**cfg_kw), JaxDACConfig(**cfg_kw)
    vae = _build(dac_vae.DACVAE, cfg, torch.device("cpu"), torch.float32,
                 torch.Generator().manual_seed(seed))
    params = convert_dac({k: v.numpy() for k, v in vae.state_dict().items()}, jcfg)
    return vae, params, jcfg


@pytest.fixture(scope="module")
def rvq():
    return _pair(NARROW)


def _audio(frames, hop, seed=0, batch=2):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (batch, 1, frames * hop - 5)
                                               ).astype(np.float32)


@pytest.mark.parametrize("nq", [None, 2, "per_item"])
def test_rvq_apply_matches_jax(rvq, nq):
    vae, params, jcfg = rvq
    z = np.random.default_rng(1).standard_normal((2, 8, 30)).astype(np.float32)
    jnq = tnq = nq
    if nq == "per_item":
        jnq, tnq = jnp.asarray([3, 1]), torch.tensor([3, 1])
    got = dac_vae.rvq_apply(vae.quantizer, torch.from_numpy(z), tnq)
    want = jax_dac.rvq_apply(params["quantizer"], jnp.asarray(z.transpose(0, 2, 1)), jnq)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]).transpose(0, 2, 1), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]).transpose(0, 2, 1), **TOL)
    for i in (3, 4):
        np.testing.assert_allclose(float(got[i]), float(want[i]), **TOL)
    zq, zp = dac_vae.rvq_from_codes(vae.quantizer, got[1])
    jzq, jzp = jax_dac.rvq_from_codes(params["quantizer"], want[1])
    np.testing.assert_allclose(zq.numpy(), np.asarray(jzq).transpose(0, 2, 1), **TOL)
    np.testing.assert_allclose(zp.numpy(), np.asarray(jzp).transpose(0, 2, 1), **TOL)


def test_encode_quantized_and_decode_codes_match_jax(rvq):
    vae, params, jcfg = rvq
    audio = _audio(20, jcfg.hop_length)
    zq, codes, latents, commit, cb = dac_vae.encode_quantized(vae, torch.from_numpy(audio))
    want = jax_dac.encode_quantized(params, jcfg, audio)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[1]))
    for got, w in ((zq, want[0]), (latents, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    wav = dac_vae.decode_codes(vae, codes)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jax_dac.decode_codes(params, jcfg,
                                                                            want[1])), **TOL)
    # decode of z_q is decode_codes: z_q's straight-through sum is the codebook path
    np.testing.assert_allclose(dac_vae.decode(vae, zq).numpy(), wav.numpy(), **TOL)


def test_receptive_frames_match_jax():
    for kw in (NARROW, {}, dataclasses.asdict(tiny_test_config().audio_vae)):
        cfg, jcfg = DACVAEConfig(**kw), JaxDACConfig(**kw)
        assert dac_vae.encoder_receptive_frames(cfg) == jax_dac.encoder_receptive_frames(jcfg)
        assert dac_vae.decoder_receptive_frames(cfg) == jax_dac.decoder_receptive_frames(jcfg)


@pytest.mark.parametrize("mode", ["continuous", "rvq"])
def test_compress_decompress_windows(mode, rvq):
    vae, params, jcfg = (_pair(dict(NARROW, continuous=True)) if mode == "continuous"
                         else rvq)
    hop = jcfg.hop_length
    frames = 2 * (dac_vae.encoder_receptive_frames(vae.cfg) + 4) + 13   # > one window
    audio = _audio(frames, hop, seed=5, batch=1)
    got = dac_vae.compress(vae, torch.from_numpy(audio), chunk_frames=4)
    want = jax_dac.compress(params, jcfg, jnp.asarray(audio), chunk_frames=4)
    whole = (dac_vae.encode_quantized(vae, torch.from_numpy(audio))[1] if mode == "rvq"
             else dac_vae.encode_mode(vae, torch.from_numpy(audio)))
    assert got.shape == whole.shape and got.shape[-1] == frames
    if mode == "rvq":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), whole.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    wav = dac_vae.decompress(vae, got, chunk_frames=4)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jax_dac.decompress(
        params, jcfg, jnp.asarray(got.numpy()), chunk_frames=4)), **TOL)
    one_pass = dac_vae.decode_codes(vae, got) if mode == "rvq" else dac_vae.decode(vae, got)
    assert wav.shape == one_pass.shape == (1, 1, frames * hop)
    np.testing.assert_allclose(wav.numpy(), one_pass.numpy(), **TOL)
