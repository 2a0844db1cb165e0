"""The bf16 VAE encode (`--vae_encode_dtype bf16`) against the JAX package on
the CPU at the tiny config, fp32 weights, the same numpy-seeded inputs:

- `wan_vae.encode_moments_streaming(compute_dtype=torch.bfloat16)` against
  JAX's with `compute_dtype=jnp.bfloat16`: mean and logvar within 2e-2
  relative L2 (two frameworks' bf16 convolutions round differently); the
  returned moments fp32 (the quant conv's dtype) and the VAE's own fp32
  parameters untouched; the mode and sampled encodes follow the moments;
- `MOVAPipeline(vae_encode_dtype="bf16")`: the prepared condition against
  JAX's pipeline with the same flag, and a tiny request's final latents
  (JAX denoising its own condition from the port's noise) against the port's,
  each within 2e-2 relative L2; the same under component and group
  offload, bit-equal to the resident pipeline, the host masters left fp32;
- None, "fp32", "f32" and "float32" bit-equal to one another and to the
  encode with no dtype;
- an unknown dtype raises ValueError in both packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline
from dualforce_tpu.models import wan_vae as jax_wan

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models import wan_vae
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.offload import to_host

from test_torch_pipeline import FakeTokenizer, _jax_params, _numpy_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

BF16_REL_TOL = 2e-2
CFG = tiny_test_config()
REQUEST = dict(height=32, width=32, num_frames=9, num_inference_steps=2, cfg_scale=5.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def tiny():
    modules = init_pipeline_params(CFG, device="cpu", dtype=torch.float32, seed=0)
    image = np.random.default_rng(5).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    return dict(modules=modules, jparams=_jax_params(modules, jax_tiny_config()),
                image=image)


def test_bf16_encode_matches_jax(tiny):
    vae = tiny["modules"]["video_vae"]
    before = {k: p.clone() for k, p in vae.named_parameters()}
    video = np.random.default_rng(9).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    mean, logvar = wan_vae.encode_moments_streaming(vae, torch.from_numpy(video),
                                                    compute_dtype=torch.bfloat16)
    jmean, jlogvar = jax.jit(lambda p, x: jax_wan.encode_moments_streaming(
        p, CFG.video_vae, x, compute_dtype=jnp.bfloat16))(tiny["jparams"]["video_vae"], video)
    assert mean.dtype == logvar.dtype == torch.float32
    assert mean.shape == jmean.shape == (1, 3, 4, 4, 16)
    assert _rel(mean, jmean) <= BF16_REL_TOL
    assert _rel(logvar, jlogvar) <= BF16_REL_TOL
    # bf16 and not fp32: the encode moved off the fp32 one
    assert _rel(mean, wan_vae.encode_moments_streaming(vae, torch.from_numpy(video))[0]) > 0
    for k, p in vae.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[k]), k
    mode = wan_vae.encode_mode_streaming(vae, torch.from_numpy(video),
                                         compute_dtype=torch.bfloat16)
    assert torch.equal(mode, mean)
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal(mean.shape)
                             .astype(np.float32))
    sample = wan_vae.encode_sample_streaming(vae, torch.from_numpy(video), noise=noise,
                                             compute_dtype=torch.bfloat16)
    assert torch.equal(sample, mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise)


def _prepare(pipe, image, **kw):
    return pipe.prepare_state(["a cat playing piano"], [image], negative_prompts=["blurry"],
                              seeds=[42], **dict(REQUEST, **kw))


def test_fp32_names_are_bit_equal_to_no_dtype(tiny):
    vae = tiny["modules"]["video_vae"]
    video = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 5, 32, 32, 3))
                             .astype(np.float32))
    plain = wan_vae.encode_moments_streaming(vae, video)
    none = wan_vae.encode_moments_streaming(vae, video, compute_dtype=None)
    f32 = wan_vae.encode_moments_streaming(vae, video, compute_dtype=torch.float32)
    for a, b, c in zip(plain, none, f32):
        assert torch.equal(a, b) and torch.equal(a, c)
    conds = []
    for name in (None, "fp32", "f32", "float32"):
        pipe = MOVAPipeline(CFG, tiny["modules"], tokenizer=FakeTokenizer(),
                            compute_dtype=torch.float32, device="cpu", attn_impl="ref",
                            vae_encode_dtype=name)
        assert pipe.vae_encode_dtype is None
        conds.append(_prepare(pipe, tiny["image"])["condition"])
    assert all(torch.equal(c, conds[0]) for c in conds[1:])


@pytest.mark.parametrize("name", ["fp16", "int8", "bf-16"])
def test_unknown_dtype_raises_in_both(tiny, name):
    with pytest.raises(ValueError, match="unknown vae_encode_dtype"):
        MOVAPipeline(CFG, tiny["modules"], device="cpu", vae_encode_dtype=name)
    with pytest.raises(ValueError, match="unknown vae_encode_dtype"):
        JaxPipeline(jax_tiny_config(), tiny["jparams"], vae_encode_dtype=name)


@pytest.fixture(scope="module")
def bf16_run(tiny):
    pipe = MOVAPipeline(CFG, tiny["modules"], tokenizer=FakeTokenizer(),
                        compute_dtype=torch.float32, device="cpu", attn_impl="ref",
                        vae_encode_dtype="bfloat16")
    state = _prepare(pipe, tiny["image"])
    done = pipe.denoise_state(state)
    return dict(pipe=pipe, state=state, done=done)


def test_bf16_pipeline_matches_jax(tiny, bf16_run):
    pipe, state, done = bf16_run["pipe"], bf16_run["state"], bf16_run["done"]
    assert pipe.vae_encode_dtype == torch.bfloat16
    jpipe = JaxPipeline(jax_tiny_config(), tiny["jparams"], tokenizer=FakeTokenizer(),
                        compute_dtype=jnp.float32, attn_impl="ref", vae_encode_dtype="bf16")
    jstate = _numpy_state(_prepare(jpipe, tiny["image"]))
    assert state["condition"].dtype == torch.float32
    err = _rel(state["condition"], jstate["condition"])
    print(f"condition: rel L2 {err:.3e}")
    assert err <= BF16_REL_TOL
    for key in ("ctx_pos", "ctx_neg"):
        np.testing.assert_allclose(state[key].numpy(), jstate[key], rtol=1e-4, atol=1e-5)
    # JAX denoises from the port's noise and its own bf16 condition
    jstate = dict(jstate, latents=state["latents"].numpy(),
                  audio_latents=state["audio_latents"].numpy())
    jdone = _numpy_state(jpipe.denoise_state(jstate))
    for key in ("latents", "audio_latents"):
        err = _rel(done[key], jdone[key])
        print(f"{key}: rel L2 {err:.3e}")
        assert err <= BF16_REL_TOL, key
    # the bf16 encode's condition is not the fp32 one
    fp32 = MOVAPipeline(CFG, tiny["modules"], tokenizer=FakeTokenizer(),
                        compute_dtype=torch.float32, device="cpu", attn_impl="ref")
    assert not torch.equal(_prepare(fp32, tiny["image"])["condition"], state["condition"])


@pytest.mark.parametrize("offload", ["component", "group"])
def test_bf16_under_offload_matches_resident(tiny, bf16_run, offload):
    hosted = {n: to_host(copy.deepcopy(m), torch.device("cpu"))
              for n, m in tiny["modules"].items()}
    pipe = MOVAPipeline(CFG, hosted, tokenizer=FakeTokenizer(), compute_dtype=torch.float32,
                        device="cpu", attn_impl="ref", offload=offload,
                        offload_group_size=1, vae_encode_dtype="bf16")
    state = _prepare(pipe, tiny["image"])
    assert torch.equal(state["condition"], bf16_run["state"]["condition"])
    assert all(p.dtype == torch.float32 for p in hosted["video_vae"].parameters())
