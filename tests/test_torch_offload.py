"""Component staging (`MOVAPipeline(offload="component")`, `offload.py`) and
`denoise_range`, on the CPU at `tiny_test_config()` in fp32.

The port's staged pipeline must give the same bits as its resident one (the
staged copies hold the same values and run the same arithmetic), also with
int8 towers, and must stay within `tests/test_torch_pipeline.py`'s
tolerances of the JAX package's `offload="component"` pipeline on the same
weights and prepared state: latents and audio to 1e-4, the uint8 video at
most 1 level off in under 1 % of its values. `denoise_range` over the two
expert phases must equal `denoise_loop` bit for bit.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline

from dualforce_tpu_torch import offload
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion import sampler
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.diffusion.step import make_rope_pack
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.nn import Int8Linear

from test_torch_pipeline import FakeTokenizer, _jax_params, _numpy_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REQUEST = dict(height=32, width=32, num_frames=5, num_inference_steps=3, cfg_scale=5.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    image = np.random.default_rng(2).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    return cfg, modules, image


def _pipe(setup, **kw):
    cfg, modules, _ = setup
    return MOVAPipeline(cfg, modules, tokenizer=FakeTokenizer(),
                        compute_dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_component_offload_bit_equal_to_resident(setup, quantize):
    image = setup[2]
    kw = dict(REQUEST, seed=11)
    resident = _pipe(setup, quantize=quantize)("a cat", image, negative_prompt="blurry", **kw)
    staged = _pipe(setup, quantize=quantize, offload="component")
    if quantize == "int8":
        assert any(isinstance(m, Int8Linear) for m in staged.modules["video_dit"].modules())
    got = staged("a cat", image, negative_prompt="blurry", **kw)
    np.testing.assert_array_equal(got.video, resident.video)
    np.testing.assert_array_equal(got.audio, resident.audio)


def test_component_offload_matches_jax(setup):
    """The same JAX-prepared state through both packages' staged pipelines."""
    cfg, modules, image = setup
    jparams = jax.tree.map(np.asarray, _jax_params(modules, jax_tiny_config()))
    jpipe = JaxPipeline(jax_tiny_config(), jparams, tokenizer=FakeTokenizer(),
                        compute_dtype=jnp.float32, attn_impl="ref", offload="component")
    jstate = jpipe.prepare_state(["a cat playing piano"], [image],
                                 negative_prompts=["blurry"], seeds=[42], **REQUEST)
    jdone = jpipe.denoise_state(jstate)
    jres = jpipe.finalize_state(jdone)[0]

    fresh = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=1)
    from_jax.load(fresh, jparams, cfg)
    pipe = MOVAPipeline(cfg, fresh, tokenizer=FakeTokenizer(), compute_dtype=torch.float32,
                        device="cpu", offload="component")
    done = pipe.denoise_state(_numpy_state(jstate))
    for key in ("latents", "audio_latents"):
        np.testing.assert_allclose(done[key].numpy(), np.asarray(jdone[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    res = pipe.finalize_state(_numpy_state(jdone))[0]
    diff = np.abs(res.video.astype(np.int16) - jres.video.astype(np.int16))
    assert res.video.shape == jres.video.shape and diff.max() <= 1
    assert np.mean(diff > 0) < 0.01
    np.testing.assert_allclose(res.audio, jres.audio, rtol=1e-4, atol=1e-4)


def test_experts_never_staged_together(setup, monkeypatch):
    """A progress hook sees at most one video expert staged at each step, and
    every staged copy is gone (weakrefs) once its phase or the request ends."""
    image = setup[2]
    live = []     # (name, weakref to the staged copy), in staging order
    masters = {id(m): n for n, m in setup[1].items()}
    real = offload.staged

    def spy(module, device):
        cm = real(module, device)

        class Spy:
            def __enter__(self):
                copy = cm.__enter__()
                live.append((masters[id(module)], weakref.ref(copy)))
                return copy

            def __exit__(self, *exc):
                return cm.__exit__(*exc)

        return Spy()

    monkeypatch.setattr(offload, "staged", spy)
    seen = []

    def on_step(step, total):
        gc.collect()
        alive = sorted(n for n, r in live if r() is not None)
        seen.append(alive)

    pipe = _pipe(setup, offload="component")
    pipe.progress_cb = on_step
    res = pipe("a cat", image, negative_prompt="blurry", seed=3, **REQUEST)
    assert np.isfinite(res.audio).all()
    plan = pipe._plan_for(dict(num_inference_steps=3, sigma_shift=5.0, visual_shift=None,
                               audio_shift=None))
    b = plan.boundary_step
    assert 0 < b < 3
    want = [["audio_dit", "bridge", "video_dit"]] * b + \
        [["audio_dit", "bridge", "video_dit_2"]] * (3 - b)
    assert seen == want
    gc.collect()
    assert [n for n, _ in live] == ["video_vae", "text_encoder", "audio_dit", "bridge",
                                    "video_dit", "video_dit_2", "video_vae", "audio_vae"]
    assert all(r() is None for _, r in live)


def test_staged_copy_is_separate_and_freed(setup):
    master = setup[1]["audio_dit"]
    before = {k: v.clone() for k, v in master.state_dict().items()}
    with offload.staged(master, "cpu") as copy:
        params = list(copy.parameters())
        for (k, v), p in zip(master.named_parameters(), params):
            assert p.data_ptr() != v.data_ptr()
            torch.testing.assert_close(p, v, rtol=0, atol=0, msg=k)
    assert all(p.untyped_storage().nbytes() == 0 for p in params)
    for k, v in master.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)


def test_to_host_keeps_values_and_quantized_buffers(setup):
    cfg, modules, _ = setup
    pipe = _pipe(setup, quantize="int8")
    q = pipe.modules["bridge"]
    want = {k: v.clone() for k, v in q.state_dict().items()}
    moved = offload.to_host(q, "cpu")
    assert moved is q
    got = q.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    assert offload.nbytes(q) == sum(v.numel() * v.element_size() for v in want.values())


def test_page_locking_raises_without_cuda(setup):
    """Page-locking never falls back to pageable memory: with no CUDA it
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: page-locking succeeds")
    with pytest.raises((RuntimeError, AssertionError)):
        offload.to_host(setup[1]["audio_dit"], "cuda")


@pytest.mark.parametrize("interval", [1, 2])
def test_denoise_range_phases_equal_denoise_loop(setup, interval):
    cfg, modules, _ = setup
    pipe = _pipe(setup)
    state = pipe.prepare_state(["a cat"], [setup[2]], negative_prompts=["blurry"], seeds=[5],
                               **dict(REQUEST, num_inference_steps=4))
    plan = pipe._plan_for(state["settings"])
    b, n = plan.boundary_step, plan.num_steps
    assert 0 < b < n
    grid = tuple(s // p for s, p in zip(state["latents"].shape[2:], cfg.video_dit.patch_size))
    rope = make_rope_pack(cfg.video_dit, cfg.audio_dit, cfg.bridge, grid,
                          state["audio_latents"].shape[2] // cfg.audio_dit.patch_size,
                          device="cpu")
    kw = dict(cfg_scale=5.0, compute_dtype=torch.float32, rope_pack=rope,
              cfg_cache_interval=interval)
    args = (state["latents"], state["condition"], state["audio_latents"], state["ctx_pos"],
            state["ctx_neg"], plan)
    m = modules
    with torch.no_grad():
        want = sampler.denoise_loop(m["video_dit"], m["video_dit_2"], m["audio_dit"],
                                    m["bridge"], *args, **kw)
        lat, alat = sampler.denoise_range(m["video_dit"], m["audio_dit"], m["bridge"],
                                          *args, 0, b, **kw)
        got = sampler.denoise_range(m["video_dit_2"], m["audio_dit"], m["bridge"], lat,
                                    args[1], alat, *args[3:], b, n, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_partial_denoise_state_ranges_raise(setup):
    pipe = _pipe(setup, offload="component")
    state = pipe.prepare_state(["a cat"], [setup[2]], seeds=[1], **REQUEST)
    with pytest.raises(ValueError):
        pipe.denoise_state(state, max_steps=1)
    with pytest.raises(ValueError):
        pipe.denoise_state(dict(state, step=1))
    assert pipe.denoise_state(dict(state, step=3)) is not None
