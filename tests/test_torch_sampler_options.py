"""The sampler's serving options against the JAX package's `denoise_loop`, on
the CPU at `tiny_test_config()` in fp32: batched CFG, the cached negative
pass (interval 2 and 3, with the step counts chosen so that the expert
switch falls between two refreshes), dual CFG (`cfg_scale_bridge` 3.5, also
without text CFG) and per-item context lengths (`mask_ctx_pad`, alone and
with batched CFG), in the manner of the JAX package's
`tests/test_pipeline_e2e.py`. JAX's pipeline prepares each request; its
state goes to the port as numpy, and the port's `denoise_state` must give
JAX's latents and audio latents within 1e-4 (fp32 round-off, the tolerance
of `tests/test_torch_pipeline.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_pipeline import FakeTokenizer, _jax_params, _numpy_state

BASE = dict(height=32, width=32, num_frames=5, num_inference_steps=4, cfg_scale=5.0)
CASES = {
    "cfg_batch": (dict(cfg_batch=True), False),
    "cache_interval_2": (dict(cfg_cache_interval=2, num_inference_steps=6), False),
    "cache_interval_3": (dict(cfg_cache_interval=3), False),
    "dual_cfg": (dict(cfg_scale_bridge=3.5), False),
    "dual_cfg_without_text_cfg": (dict(cfg_scale_bridge=3.5, cfg_scale=1.0), False),
    "mask_ctx_pad": (dict(), True),
    "mask_ctx_pad_cfg_batch": (dict(cfg_batch=True), True),
}


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_test_config()
    source = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    jparams = _jax_params(source, jax_tiny_config())
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=1)
    from_jax.load(modules, jparams, cfg)
    image = np.random.default_rng(6).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    return cfg, jparams, modules, image


def _pipes(weights, mask_ctx_pad):
    cfg, jparams, modules, _ = weights
    jpipe = JaxPipeline(jax_tiny_config(), jparams, tokenizer=FakeTokenizer(),
                        compute_dtype=jnp.float32, attn_impl="ref", mask_ctx_pad=mask_ctx_pad)
    pipe = MOVAPipeline(cfg, modules, tokenizer=FakeTokenizer(), compute_dtype=torch.float32,
                        device="cpu", mask_ctx_pad=mask_ctx_pad)
    return jpipe, pipe


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax_denoise_loop(weights, case):
    options, mask_ctx_pad = CASES[case]
    request = dict(BASE, **options)
    jpipe, pipe = _pipes(weights, mask_ctx_pad)
    interval = request.get("cfg_cache_interval", 1)
    if interval > 1:
        plan = pipe._plan_for(dict(num_inference_steps=request["num_inference_steps"],
                                   sigma_shift=5.0, visual_shift=None, audio_shift=None))
        assert plan.boundary_step % interval != 0    # the switch forces its own refresh
    jstate = jpipe.prepare_state(["a cat"], [weights[3]], negative_prompts=["blurry"],
                                 seeds=[42], **request)
    if mask_ctx_pad:
        assert int(jstate["ctx_len_pos"][0]) < 512
        state = pipe.prepare_state(["a cat"], [weights[3]], negative_prompts=["blurry"],
                                   seeds=[42], **request)
        for key in ("ctx_len_pos", "ctx_len_neg"):
            np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]))
    jdone = jpipe.denoise_state(jstate)
    done = pipe.denoise_state(_numpy_state(jstate))
    for key in ("latents", "audio_latents"):
        np.testing.assert_allclose(done[key].numpy(), np.asarray(jdone[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_option_changes_the_result(weights):
    """Each option computes something else than plain CFG (so the matches
    above are not vacuous); `mask_ctx_pad` with a prompt that fills all 512
    positions is bit-equal to the default."""
    _, pipe = _pipes(weights, False)
    _, masked = _pipes(weights, True)
    image = weights[3]

    def latents(p, prompt="a cat", negative="blurry", **kw):
        state = p.prepare_state([prompt], [image], negative_prompts=[negative], seeds=[42],
                                **dict(BASE, **kw))
        return p.denoise_state(state)["latents"]

    base = latents(pipe)
    for kw in (dict(cfg_cache_interval=3), dict(cfg_scale_bridge=3.5)):
        assert not torch.equal(latents(pipe, **kw), base), kw
    assert not torch.equal(latents(masked), base)
    full, neg = "x" * 600, "y" * 600
    assert torch.equal(latents(masked, full, neg), latents(pipe, full, neg))


def test_cache_interval_with_cfg_batch_raises(weights):
    jpipe, pipe = _pipes(weights, False)
    request = dict(BASE, cfg_cache_interval=2, cfg_batch=True)
    for p in (jpipe, pipe):
        state = p.prepare_state(["a cat"], [weights[3]], seeds=[1], **request)
        with pytest.raises(ValueError):
            p.denoise_state(state)
