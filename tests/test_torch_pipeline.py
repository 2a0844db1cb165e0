"""The port's slice as a whole against the JAX package, on the CPU in fp32.

The JAX `MOVAPipeline` prepares a tiny request (32x32, 5 frames, 3 steps,
CFG 5 with a negative prompt, `attn_impl="ref"`); its state goes to the port
as numpy, and the port's `denoise_state` and `finalize_state` are held
against JAX's: latents to 1e-4 (fp32 round-off over 3 steps x 2 passes x 2
towers), audio to 1e-4, and the uint8 video to at most 1 level, with under
1% of values off by that level (fp32 round-off flips a few roundings).
The port's own `prepare_state` must reproduce JAX's condition and text
contexts (its noise comes from a torch generator, so it differs).

The weights start as the port's random modules; the JAX package's own
checkpoint converters read them into the JAX tree, and `convert.from_jax`
carries that tree back, strictly, into fresh modules, which must then hold
the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.convert import torch_import
from dualforce_tpu.convert.load_checkpoint import _convert_wan_vae
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline
from dualforce_tpu.models.umt5 import convert_umt5

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REQUEST = dict(height=32, width=32, num_frames=5, num_inference_steps=3, cfg_scale=5.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off: the same
    math, compiled in about two thirds of the time at these sizes. The
    setting is restored for the test files that follow."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


class FakeTokenizer:
    """Byte-level stand-in for the UMT5 tokenizer (no checkpoint here)."""

    def __call__(self, prompts, padding=None, max_length=512, truncation=True,
                 add_special_tokens=True, return_attention_mask=True, return_tensors="np"):
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            toks = [2 + (b % 500) for b in p.encode()][: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _numpy_state(state):
    return {k: (v if k == "settings" or v is None or isinstance(v, int) else np.asarray(v))
            for k, v in state.items()}


def _jax_params(modules, jcfg):
    """The JAX tree the JAX package's checkpoint converters read from the
    port's state dicts."""
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in modules.items()}
    return {
        "video_dit": torch_import.convert_video_dit(sd["video_dit"], jcfg.video_dit),
        "video_dit_2": torch_import.convert_video_dit(sd["video_dit_2"], jcfg.video_dit),
        "audio_dit": torch_import.convert_audio_dit(sd["audio_dit"], jcfg.audio_dit),
        "bridge": torch_import.convert_bridge(sd["bridge"], jcfg.bridge),
        "text_encoder": convert_umt5(sd["text_encoder"], jcfg.text_encoder),
        "video_vae": _convert_wan_vae(sd["video_vae"], jcfg.video_vae),
        "audio_vae": torch_import.convert_dac(sd["audio_vae"], jcfg.audio_vae),
    }


@pytest.fixture(scope="module")
def slice_run():
    cfg = tiny_test_config()
    source = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    jparams = _jax_params(source, jax_tiny_config())
    jpipe = JaxPipeline(jax_tiny_config(), jparams, tokenizer=FakeTokenizer(),
                        compute_dtype=jnp.float32, attn_impl="ref")
    image = np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    prompt, negative = "a cat playing piano", "blurry"
    jstate = jpipe.prepare_state([prompt], [image], negative_prompts=[negative],
                                 seeds=[42], **REQUEST)
    jdone = jpipe.denoise_state(jstate)
    jres = jpipe.finalize_state(jdone)[0]

    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=1)
    from_jax.load(modules, jparams, cfg)
    pipe = MOVAPipeline(cfg, modules, tokenizer=FakeTokenizer(),
                        compute_dtype=torch.float32, device="cpu")
    return dict(pipe=pipe, image=image, prompt=prompt, negative=negative,
                jstate=_numpy_state(jstate), jdone=_numpy_state(jdone), jres=jres,
                jparams=jparams, cfg=cfg, source=source)


def test_from_jax_loads_strictly(slice_run):
    """Every module of the tiny pipeline takes the JAX tree with no missing
    or extra key and ends up equal to the module the tree came from; a
    missing key is refused."""
    cfg, jparams = slice_run["cfg"], slice_run["jparams"]
    sds = from_jax.state_dicts(jparams, cfg)
    for name, module in slice_run["pipe"].modules.items():
        assert set(sds[name]) == set(module.state_dict()), name
        source = slice_run["source"][name].state_dict()
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), source[k].numpy(), err_msg=k)
    broken = dict(jparams, bridge=dict(jparams["bridge"]))
    del broken["bridge"]["a2v"]["y_norm"]
    with pytest.raises(KeyError):
        from_jax.load({"bridge": slice_run["pipe"].modules["bridge"]},
                      {"bridge": broken["bridge"]}, cfg)


def test_denoise_state_matches_jax(slice_run):
    done = slice_run["pipe"].denoise_state(slice_run["jstate"])
    assert done["step"] == REQUEST["num_inference_steps"]
    for key in ("latents", "audio_latents"):
        np.testing.assert_allclose(done[key].numpy(), slice_run["jdone"][key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_finalize_state_matches_jax(slice_run):
    res = slice_run["pipe"].finalize_state(slice_run["jdone"])[0]
    want = slice_run["jres"]
    assert res.video.shape == want.video.shape == (5, 32, 32, 3)
    assert res.video.dtype == np.uint8
    diff = np.abs(res.video.astype(np.int16) - want.video.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.01
    assert res.audio.shape == want.audio.shape == (int(48000 * 5 / 24),)
    np.testing.assert_allclose(res.audio, want.audio, rtol=1e-4, atol=1e-4)
    assert (res.sample_rate, res.fps) == (want.sample_rate, want.fps)


def test_prepare_state_matches_jax_condition_and_contexts(slice_run):
    s = slice_run
    state = s["pipe"].prepare_state([s["prompt"]], [s["image"]],
                                    negative_prompts=[s["negative"]], seeds=[42],
                                    **REQUEST)
    for key in ("condition", "ctx_pos", "ctx_neg"):
        np.testing.assert_allclose(state[key].numpy(), s["jstate"][key],
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert state["latents"].shape == s["jstate"]["latents"].shape
    assert state["audio_latents"].shape == s["jstate"]["audio_latents"].shape
    assert state["settings"] == s["jstate"]["settings"]


def test_generate_end_to_end_on_cpu(slice_run):
    """The public entry point: deterministic per seed, right shapes."""
    pipe, image = slice_run["pipe"], slice_run["image"]
    kw = dict(REQUEST, num_inference_steps=2)
    r1 = pipe("a dog", image, negative_prompt="noisy", seed=7, **kw)
    r2 = pipe("a dog", image, negative_prompt="noisy", seed=7, **kw)
    assert r1.video.shape == (5, 32, 32, 3) and np.isfinite(r1.audio).all()
    np.testing.assert_array_equal(r1.video, r2.video)
    np.testing.assert_array_equal(r1.audio, r2.audio)
    with pytest.raises(ValueError):
        pipe("a dog", image, cfg_batch=True, cfg_cache_interval=2, **kw)
