"""fp8 weight storage (`nn.cast_modules_fp8`, `nn.Fp8Linear`) against the JAX
package's `cast_tree_fp8`, on the CPU.

The JAX package's own converters read each port module into its stacked
tree; `cast_tree_fp8` casts that tree as `load_pipeline_params` does, and
`convert.from_jax` carries it back by name, fp8 leaves as fp8. The port's
set of fp8 parameters must equal the set JAX casts, and every fp8 byte must
be equal. A tiny pipeline with fp8 towers and UMT5 then runs through both
packages in fp32 compute on the same weights (fp8 values are exact in fp32,
so only the order of fp32 sums differs): latents and audio within 1e-4,
the uint8 video at most 1 level off in under 1 % of its values, the text
contexts within 1e-5, as `tests/test_torch_pipeline.py` holds the bf16-free
path. Out-of-range values are the one deliberate difference: the port
saturates them to 448, JAX's cast (ml_dtypes) makes them NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import nn as jnn
from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_pipeline import FakeTokenizer, _jax_params, _numpy_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

FP8_MODULES = ("video_dit", "video_dit_2", "audio_dit", "bridge", "text_encoder")
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
def trees():
    """fp32 port modules, JAX's converted trees of them cast by
    `cast_tree_fp8`, and the port's own fp8 copies."""
    cfg = tiny_test_config()
    source = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    jparams = _jax_params(source, jax_tiny_config())
    for name in FP8_MODULES:
        jparams[name] = jnn.cast_tree_fp8(jparams[name], jnp.float8_e4m3fn)
    jparams = jax.tree.map(np.asarray, jparams)
    fp8 = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    for name in FP8_MODULES:
        tnn.cast_modules_fp8(fp8[name])
    return cfg, source, jparams, fp8


@pytest.mark.parametrize("name", ["video_dit", "audio_dit", "bridge", "text_encoder"])
def test_fp8_set_and_bytes_match_cast_tree_fp8(trees, name):
    cfg, _, jparams, fp8 = trees
    jax_sd = {k: from_jax._tensor(v)
              for k, v in from_jax.state_dicts({name: jparams[name]}, cfg)[name].items()}
    port_sd = fp8[name].state_dict()
    assert set(jax_sd) == set(port_sd)
    jax_fp8 = {k for k, v in jax_sd.items() if v.dtype == torch.float8_e4m3fn}
    port_fp8 = {k for k, v in port_sd.items() if v.dtype == torch.float8_e4m3fn}
    assert port_fp8 == jax_fp8
    assert all(v.dtype == torch.bfloat16 for k, v in port_sd.items() if k not in port_fp8)
    for k in sorted(port_fp8):
        assert torch.equal(port_sd[k].view(torch.uint8), jax_sd[k].view(torch.uint8)), k


def test_fp8_set_covers_stacked_leaves(trees):
    """JAX's rule catches the stacked 1-D leaves its docstring calls bf16:
    block biases and UMT5's per-layer norm scales and bias tables (ROADMAP C,
    caveat 5); names holding "norm"/"modulation" in JAX stay bf16."""
    fp8 = trees[3]
    dt = {n: {k: v.dtype for k, v in fp8[n].state_dict().items()} for n in FP8_MODULES}
    e4 = torch.float8_e4m3fn
    assert dt["video_dit"]["blocks.0.self_attn.q.bias"] == e4
    assert dt["video_dit"]["blocks.0.ffn.0.bias"] == e4
    assert dt["video_dit"]["text_embedding.0.bias"] == torch.bfloat16
    assert dt["video_dit"]["blocks.0.self_attn.norm_q.weight"] == torch.bfloat16
    assert dt["video_dit"]["blocks.0.modulation"] == torch.bfloat16
    assert dt["video_dit"]["patch_embedding.weight"] == e4
    assert dt["bridge"]["audio_to_video_conditioners.0.inner.q.bias"] == e4
    assert dt["bridge"]["audio_to_video_conditioners.0.y_norm.weight"] == torch.bfloat16
    te = dt["text_encoder"]
    assert te["encoder.block.0.layer.0.layer_norm.weight"] == e4
    assert te["encoder.block.0.layer.1.layer_norm.weight"] == e4
    assert te["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] == e4
    assert te["shared.weight"] == e4
    assert te["encoder.final_layer_norm.weight"] == torch.bfloat16
    assert any(isinstance(m, tnn.Fp8Linear) for m in fp8["text_encoder"].modules())
    assert not any(type(m) is torch.nn.Linear for n in FP8_MODULES
                   for m in fp8[n].modules())


def test_from_jax_loads_fp8_leaves(trees):
    cfg, _, jparams, fp8 = trees
    fresh = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=3,
                                 with_vaes=False)
    for name in FP8_MODULES:
        tnn.cast_modules_fp8(fresh[name])
    from_jax.load(fresh, {k: jparams[k] for k in fresh}, cfg)
    for name in FP8_MODULES:
        want = fp8[name].state_dict()
        for k, v in fresh[name].state_dict().items():
            assert v.dtype == want[k].dtype, k
            assert torch.equal(v.view(torch.uint8), want[k].view(torch.uint8)), k


def test_out_of_range_saturates_in_port_and_is_nan_in_jax():
    """ROADMAP C, caveat 6."""
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor([[500.0, -500.0], [1.0, 0.5]]))
    port = tnn.cast_modules_fp8(torch.nn.Sequential(lin))[0].weight.float()
    assert port.tolist() == [[448.0, -448.0], [1.0, 0.5]]
    jax_w = jnn.cast_tree_fp8({"w": jnp.asarray([[500.0, -500.0], [1.0, 0.5]])})["w"]
    jax_w = np.asarray(jax_w.astype(jnp.float32))
    assert np.isnan(jax_w[0]).all() and jax_w[1].tolist() == [1.0, 0.5]


def test_factory_fp8_is_bf16_init_then_cast():
    cfg = tiny_test_config()
    bf16 = init_pipeline_params(cfg, device="cpu", dtype=torch.bfloat16, seed=4,
                                with_vaes=False)
    fp8 = init_pipeline_params(cfg, device="cpu", dtype=torch.float8_e4m3fn, seed=4,
                               with_vaes=False)
    for name, m in bf16.items():
        want = tnn.cast_modules_fp8(m).state_dict()
        got = fp8[name].state_dict()
        for k, v in got.items():
            assert v.dtype == want[k].dtype, k
            assert torch.equal(v.view(torch.uint8), want[k].view(torch.uint8)), k


def test_fp8_pipeline_matches_jax(trees):
    cfg, _, jparams, fp8 = trees
    jpipe = JaxPipeline(jax_tiny_config(), jparams, tokenizer=FakeTokenizer(),
                        compute_dtype=jnp.float32, attn_impl="ref")
    image = np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    jstate = jpipe.prepare_state(["a cat playing piano"], [image],
                                 negative_prompts=["blurry"], seeds=[42], **REQUEST)
    jdone = jpipe.denoise_state(jstate)
    jres = jpipe.finalize_state(jdone)[0]

    pipe = MOVAPipeline(cfg, fp8, tokenizer=FakeTokenizer(), compute_dtype=torch.float32,
                        device="cpu")
    state = pipe.prepare_state(["a cat playing piano"], [image], negative_prompts=["blurry"],
                               seeds=[42], **REQUEST)
    for key in ("ctx_pos", "ctx_neg"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    done = pipe.denoise_state(_numpy_state(jstate))
    for key in ("latents", "audio_latents"):
        np.testing.assert_allclose(done[key].numpy(), np.asarray(jdone[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    res = pipe.finalize_state(_numpy_state(jdone))[0]
    diff = np.abs(res.video.astype(np.int16) - jres.video.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.01
    np.testing.assert_allclose(res.audio, jres.audio, rtol=1e-4, atol=1e-4)


def test_fp8_towers_quantize_and_trainer_refuses_them(trees, tmp_path):
    """fp8 towers quantize to int8 from their fp8 weights (as the JAX
    package's do) and serve; the LoRA trainer, which refused fp8-stored
    weights before LoRA training on them was ported, now takes them: its
    factors are fp32, one pair per fp8-stored target (the training itself
    is held in `tests/test_torch_train_offload.py`)."""
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

    cfg, _, _, fp8 = trees
    pipe = MOVAPipeline(cfg, fp8, tokenizer=FakeTokenizer(), compute_dtype=torch.float32,
                        device="cpu", quantize="int8")
    assert any(isinstance(m, tnn.Int8Linear) for m in pipe.modules["video_dit"].modules())
    image = np.random.default_rng(1).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    res = pipe("a cat", image, seed=2, **dict(REQUEST, num_inference_steps=2))
    assert res.video.shape == (5, 32, 32, 3) and np.isfinite(res.audio).all()
    trainer = LoRATrainer(cfg, fp8, TrainerConfig(logger="none", save_dir=str(tmp_path)),
                          device="cpu")
    for name, tree in trainer.lora.items():
        assert tree and all(fp8[name].get_parameter(w).dtype == torch.float8_e4m3fn
                            and ab["a"].dtype == ab["b"].dtype == torch.float32
                            for w, ab in tree.items())
