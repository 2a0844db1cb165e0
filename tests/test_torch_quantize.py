"""The port's int8 and int4 linears and tower quantization against the JAX
package, on the CPU.

Inputs and weights come from numpy seeds. `Int8Linear` must hold the very
int8 weights and scales of `quantize_linear_int8` (transposed to [out, in])
and compute `_linear_int8`'s output to 1e-5 relative (fp32: the int32
products are exact, the dequantisation repeats JAX's order), its activation
quantization (`nn.quantize_activations`) bit-equal to JAX's; `Int4Linear`'s
dequantised weight must equal `dequantize_int4` exactly in fp32 and bf16, and
its output `_linear_int4`'s to 1e-5. `quantize_modules` must replace exactly
the linears `quantize_tree_int8` quantizes, and a JAX tree quantized by
`quantize_tree_int8/int4` must load strictly into the port's quantized
modules and equal the port's own quantization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import nn as jnn
from dualforce_tpu.convert import torch_import

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _linear(seed, din, dout, bias=True):
    torch.manual_seed(seed)
    return torch.nn.Linear(din, dout, bias=bias).requires_grad_(False)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(lin):
    p = {"kernel": lin.weight.detach().numpy().T.copy()}
    if lin.bias is not None:
        p["bias"] = lin.bias.detach().numpy().copy()
    return p


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def test_scopes_and_group_match_jax():
    assert tnn.QUANT_SCOPES == jnn.QUANT_INT8_SCOPES
    assert tnn.INT4_GROUP == jnn.INT4_GROUP


@pytest.mark.parametrize("din,dout,rows,bias", [(96, 40, 2 * 9, True), (256, 24, 5, False)])
def test_int8_linear_matches_jax(din, dout, rows, bias):
    """Weights and scales exactly; the activations' int8 values and scales
    exactly; the output on the same fp32 input (5 rows go through the
    zero-row padding the int8 product needs)."""
    lin = _linear(0, din, dout, bias)
    jp = jnn.quantize_linear_int8(_params(lin))
    q = tnn.Int8Linear.from_linear(lin)
    np.testing.assert_array_equal(q.weight_q.numpy(), np.asarray(jp["kernel_q"]).T)
    np.testing.assert_array_equal(q.weight_scale.numpy(), np.asarray(jp["kernel_scale"])[0])
    assert q.weight_q.dtype == torch.int8 and (q.bias is lin.bias)
    x = _x(1, 1, rows, din)
    # `_linear_int8`'s activation quantization, op by op as JAX runs it there
    a32 = jnp.asarray(x)
    a_scale = jnp.maximum(jnp.max(jnp.abs(a32), axis=-1, keepdims=True) / 127.0, 1e-12)
    ai, scale = tnn.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(a_scale))
    np.testing.assert_array_equal(ai.numpy(), np.asarray(jnp.round(a32 / a_scale).astype(jnp.int8)))
    got = q(torch.from_numpy(x))
    want = np.asarray(jax.jit(jnn.linear)(jp, x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("din,dout,bias", [(256, 24, True), (96, 40, False)],
                         ids=["group128", "whole_in_dim"])
def test_int4_linear_matches_jax(din, dout, bias):
    """The packed values, the dequantised weight (exactly, fp32 and bf16)
    and the output; an in-dim that 128 does not divide takes one group."""
    lin = _linear(2, din, dout, bias)
    jp = jnn.quantize_linear_int4(_params(lin))
    q = tnn.Int4Linear.from_linear(lin)
    np.testing.assert_array_equal(q.weight_q4.numpy(), np.asarray(jp["kernel_q4"]).T)
    np.testing.assert_array_equal(q.weight_scale4.numpy(), np.asarray(jp["kernel_scale4"]).T)
    assert q.weight_scale4.shape == (dout, max(1, din // 128) if din % 128 == 0 else 1)
    for tdt, jdt in ((torch.float32, jax.numpy.float32), (torch.bfloat16, jax.numpy.bfloat16)):
        got = tnn.dequantize_int4(q.weight_q4, q.weight_scale4, tdt)
        want = jax.jit(jnn.dequantize_int4, static_argnums=2)(
            jp["kernel_q4"], jp["kernel_scale4"], jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jax.numpy.float32)).T)
    x = _x(3, 2, 7, din)
    want = np.asarray(jax.jit(jnn.linear)(jp, x))
    assert _rel(q(torch.from_numpy(x)).numpy(), want) <= REL


def test_int4_odd_in_dim_is_refused():
    lin = _linear(4, 7, 8)
    with pytest.raises(ValueError):
        tnn.Int4Linear.from_linear(lin)
    with pytest.raises(ValueError):
        jnn.quantize_linear_int4(_params(lin))


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def towers():
    cfg = tiny_test_config()
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=3,
                                with_vaes=False, with_text=False, two_video_towers=False)
    from test_torch_models import _jax_config

    jcfg = _jax_config(cfg)
    jparams = {
        "video_dit": torch_import.convert_video_dit(_sd(mods["video_dit"]), jcfg.video_dit),
        "audio_dit": torch_import.convert_audio_dit(_sd(mods["audio_dit"]), jcfg.audio_dit),
        "bridge": torch_import.convert_bridge(_sd(mods["bridge"]), jcfg.bridge),
    }
    return cfg, mods, jparams


@pytest.fixture(scope="module")
def jax_quantized(towers):
    """{mode: {tower: the JAX tree quantized by `quantize_tree_int8/int4`}},
    op by op (a jit would let XLA turn the division by 127 into a product),
    once for this file."""
    _, _, jparams = towers
    return {mode: {n: qfn(p) for n, p in jparams.items()}
            for mode, qfn in (("int8", jnn.quantize_tree_int8), ("int4", jnn.quantize_tree_int4))}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_modules_matches_quantize_tree(towers, jax_quantized, mode):
    """The linears replaced in each tower are the leaves JAX quantizes (under
    `from_jax`'s name map); the quantized JAX tree loads strictly into the
    port's quantized towers and equals the port's own quantization; the
    source modules are unchanged and share every other parameter."""
    cfg, mods, jparams = towers
    cls = tnn.Int8Linear if mode == "int8" else tnn.Int4Linear
    suffix = ".weight_q" if mode == "int8" else ".weight_q4"
    jq = jax.tree.map(np.asarray, jax_quantized[mode])
    jsds = from_jax.state_dicts(jq, cfg)
    before = {name: _sd(m) for name, m in mods.items()}
    for name, module in mods.items():
        qmod = tnn.quantize_modules(module, mode)
        replaced = {n for n, m in qmod.named_modules() if isinstance(m, cls)}
        jax_quantized = {k[:-len(suffix)] for k in jsds[name] if k.endswith(suffix)}
        assert replaced and replaced == jax_quantized, name
        assert not any(isinstance(m, cls) for m in module.modules())
        for k, v in _sd(module).items():
            np.testing.assert_array_equal(v, before[name][k])
        kept = {n: p for n, p in module.named_parameters()}
        for n, p in qmod.named_parameters():
            assert p is kept[n], n
        # the JAX tree, quantized by JAX, into a second quantized copy
        loaded = tnn.quantize_modules(module, mode)
        for t in loaded.buffers():
            t.zero_()
        from_jax.load({name: loaded}, {name: jq[name]}, cfg)
        own = qmod.state_dict()
        for k, v in loaded.state_dict().items():
            assert v.dtype == own[k].dtype, k
            np.testing.assert_array_equal(v.numpy(), own[k].numpy(), err_msg=k)


# --- the pipeline in the precision modes ------------------------------------

def _state(cfg, seed):
    """A denoise state from numpy: 32x32, 5 frames (2 latent frames), 25
    audio latent steps, a 16-token text context, 2 steps, no CFG (the CFG
    pass is held in `test_torch_pipeline.py`)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    text = cfg.video_dit.text_dim
    return {"step": 0,
            "settings": dict(num_frames=5, video_fps=24.0, num_inference_steps=2,
                             sigma_shift=5.0, visual_shift=None, audio_shift=None,
                             cfg_scale=1.0, cfg_batch=False, cfg_cache_interval=1,
                             cfg_scale_bridge=0.0),
            "latents": r(1, 16, 2, 4, 4), "condition": r(1, 20, 2, 4, 4),
            "audio_latents": r(1, cfg.audio_dit.in_dim, 25),
            "ctx_pos": r(1, 16, text), "ctx_neg": None,
            "ctx_len_pos": None, "ctx_len_neg": None}


# fp32 through 2 steps: int4 (weights only) at fp32 round-off;
# int8 also rounds every activation to int8, and a rounding tie that fp32
# round-off flips moves an output by one activation level
PIPE_TOL = {"int4": 1e-4, "int8": 1e-3}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_pipeline_quantized_denoise_matches_jax(towers, jax_quantized, monkeypatch, mode):
    """`MOVAPipeline(quantize=mode)`'s `denoise_state` against the JAX
    pipeline's on the same state and tower weights (relative L2 per
    output); the caller's modules stay unquantized. The JAX pipeline's
    quantizer hands back this file's trees for the towers it quantizes."""
    from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline

    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from test_torch_models import _jax_config

    cfg, mods, jparams = towers
    state = _state(cfg, 5)
    done = {id(jparams[n]): t for n, t in jax_quantized[mode].items()}
    monkeypatch.setattr(jnn, f"quantize_tree_{mode}", lambda tree: done[id(tree)])
    jpipe = JaxPipeline(_jax_config(cfg), dict(jparams), compute_dtype=jax.numpy.float32,
                        attn_impl="auto", quantize=mode)
    want = jpipe.denoise_state(state)
    pipe = MOVAPipeline(cfg, dict(mods), compute_dtype=torch.float32, device="cpu",
                        quantize=mode)
    cls = tnn.Int8Linear if mode == "int8" else tnn.Int4Linear
    for name in ("video_dit", "audio_dit", "bridge"):
        assert any(isinstance(m, cls) for m in pipe.modules[name].modules())
        assert not any(isinstance(m, cls) for m in mods[name].modules())
    got = pipe.denoise_state(state)
    for key in ("latents", "audio_latents"):
        assert _rel(got[key].numpy(), np.asarray(want[key])) <= PIPE_TOL[mode], key


def test_pipeline_refuses_unknown_modes(towers):
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline

    cfg, mods, _ = towers
    for kw in (dict(quantize="fp8"), dict(attn_impl="flash3")):
        with pytest.raises(ValueError):
            MOVAPipeline(cfg, dict(mods), device="cpu", **kw)
    with pytest.raises(ValueError):
        MOVAPipeline(cfg, dict(mods), device="cpu", offload="layerwise")
    assert MOVAPipeline(cfg, dict(mods), device="cpu", offload="group").offload == "group"
    pipe = MOVAPipeline(cfg, dict(mods), device="cpu", attn_impl="sage", quantize="int8")
    assert (pipe.attn_impl, pipe.quantize) == ("sage", "int8")
