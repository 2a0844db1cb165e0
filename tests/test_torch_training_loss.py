"""The port's training loss and LoRA gradients against the JAX package's
`jax.value_and_grad(training_loss)`, on the CPU in fp32.

Both sides get the same weights (the port's random towers read into JAX
trees by the JAX package's converters), the same LoRA (the JAX tree carried
over by `convert.from_jax.lora`), the same encoded batch (random latents
from numpy), the timestep id JAX draws, and numpy noise. Tolerances: 1e-4
relative on losses, 1e-3 relative (atol 1e-6) on LoRA gradients, fp32
round-off through a few layers and their backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import config as jc
from dualforce_tpu.diffusion import training as jtr
from dualforce_tpu.diffusion.flow_match import FlowMatchPairScheduler as JaxScheduler
from test_torch_training import (CFG_KW, _jax_lora, _jax_params, _noise, _np, _t,
                                 _tables)

from dualforce_tpu_torch.config import (AudioDiTConfig, BridgeConfig, MOVAConfig,
                                        VideoDiTConfig, tiny_test_config)
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion import training as ttr
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _jax_config(cfg):
    """The JAX package's MOVAConfig with the same field values."""
    return jc.MOVAConfig(**{
        f.name: (getattr(jc, type(v).__name__)(**dataclasses.asdict(v))
                 if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]})


def _encoded(cfg, grid, audio_t, ctx_len, seed):
    """A random encoded batch: latents for `grid` (latent frames, height,
    width), audio latents of `audio_t` steps, a text context."""
    rng = np.random.default_rng(seed)
    f, h, w = grid
    vdim = cfg.video_dit.out_dim
    return {"video_latents": rng.standard_normal((1, vdim, f, h, w)).astype(np.float32),
            "condition": rng.standard_normal((1, cfg.video_dit.in_dim - vdim, f, h, w)
                                             ).astype(np.float32),
            "audio_latents": rng.standard_normal((1, cfg.audio_dit.in_dim, audio_t)
                                                 ).astype(np.float32),
            "context": rng.standard_normal((1, ctx_len, cfg.video_dit.text_dim)
                                           ).astype(np.float32)}


def _jax_loss_and_grads(jlora_tree, jparams, jcfg, enc, expert, noise, **kw):
    """(timestep id, loss, metrics, grads) of the JAX `training_loss`, jitted."""
    jtables = _tables(jcfg, JaxScheduler)
    rng = jax.random.PRNGKey(11 + expert)
    tid = int(jtr.sample_timestep_id(jax.random.split(rng, 3)[0], jtables, expert))
    fn = jax.jit(lambda lora, params, e, key, nz: jax.value_and_grad(
        jtr.training_loss, has_aux=True)(lora, params, jcfg, jtables, e, key, expert,
                                         compute_dtype=jnp.float32, noise_override=nz, **kw))
    (loss, metrics), grads = fn(jlora_tree, jparams, enc, rng, noise)
    return tid, float(loss), _np(metrics), _np(grads)


def _grads_by_name(lora, grads):
    names = [(m, n, p) for m in sorted(lora) for n in sorted(lora[m]) for p in ("a", "b")]
    return dict(zip(names, grads))


def _check_grads(port_lora, grads, jgrads, cfg):
    want = from_jax.lora(jgrads, cfg)
    got = _grads_by_name(port_lora, grads)
    assert {(m, n) for m, n, _ in got} == {(m, n) for m in want for n in want[m]}
    for (m, n, p), g in got.items():
        np.testing.assert_allclose(g.numpy(), want[m][n][p].detach().numpy(),
                                   err_msg=f"{m} {n} {p}", **GRAD_TOL)


@pytest.fixture(scope="module")
def towers():
    cfg = tiny_test_config(**CFG_KW)
    jcfg = _jax_config(cfg)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                with_vaes=False, with_text=False)
    return cfg, jcfg, mods, _jax_params(mods, jcfg)


@pytest.mark.parametrize("expert", [0, 1])
def test_training_loss_and_lora_grads_match_jax(towers, expert):
    """Loss, its parts and every LoRA gradient; the inactive expert's
    gradients are exactly 0; remat changes nothing."""
    cfg, jcfg, mods, jparams = towers
    enc = _encoded(cfg, (2, 8, 8), 21, 24, 5 + expert)
    jl = _jax_lora(jparams)
    noise = _noise(enc, 7 + expert)
    tid, jloss, jmetrics, jgrads = _jax_loss_and_grads(jl, jparams, jcfg, enc, expert,
                                                       noise, remat=True, attn_impl="ref")
    port_lora = from_jax.lora(_np(jl), cfg)
    tables = _tables(cfg, FlowMatchPairScheduler)
    runs = {remat: ttr.lora_grads(port_lora, mods, cfg, tables, _t(enc), None, expert,
                                  compute_dtype=torch.float32, remat=remat,
                                  noise_override=noise, timestep_id=tid, device="cpu")
            for remat in (True, False)}
    grads, metrics = runs[True]
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-4)
    for key in ("video_loss", "audio_loss", "timestep"):
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key], rtol=1e-4)
    inactive = "video_dit_2" if expert == 0 else "video_dit"
    for (m, _, _), g in _grads_by_name(port_lora, grads).items():
        assert (torch.count_nonzero(g) == 0) == (m == inactive), m
    _check_grads(port_lora, grads, jgrads, cfg)
    for a, b in zip(grads, runs[False][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def test_flagship_mini_grads_through_flash_match_jax(monkeypatch):
    """At the `__graft_entry__._flagship_mini()` geometry (head_dim 128
    everywhere, "full" bridge, 4 video / 2 audio layers: 2 shared layers and
    a 2-layer tail) and 288 video tokens, the port's three video-side
    attentions per shared layer and two per tail layer take flash attention
    and its backward (10 backward calls); the JAX side runs its reference
    attention. Loss and LoRA gradients agree."""
    cfg = MOVAConfig(
        video_dit=VideoDiTConfig(dim=512, in_dim=36, ffn_dim=1536, out_dim=16,
                                 text_dim=256, freq_dim=64, num_heads=4,
                                 num_layers=4, rope_max_len=64),
        audio_dit=AudioDiTConfig(dim=256, in_dim=32, ffn_dim=768, out_dim=32,
                                 text_dim=256, freq_dim=64, num_heads=2,
                                 num_layers=2, rope_max_len=256),
        bridge=BridgeConfig(visual_layers=4, audio_layers=2, visual_hidden_dim=512,
                            audio_hidden_dim=256, head_dim=128,
                            interaction_strategy="full", apply_cross_rope=True,
                            audio_fps=50.0))
    jcfg = _jax_config(cfg)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=2,
                                with_vaes=False, with_text=False, two_video_towers=False)
    jparams = _jax_params(mods, jcfg)
    enc = _encoded(cfg, (2, 24, 24), 50, 16, 9)
    jl = _jax_lora(jparams)
    noise = _noise(enc, 10)
    tid, jloss, _, jgrads = _jax_loss_and_grads(jl, jparams, jcfg, enc, 0, noise,
                                                remat=True, attn_impl="ref")
    calls = []
    plain_bwd = fa.flash_attention_bwd_plain
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a: calls.append(1) or plain_bwd(*a))
    port_lora = from_jax.lora(_np(jl), cfg)
    tables = _tables(cfg, FlowMatchPairScheduler)
    grads, metrics = ttr.lora_grads(port_lora, mods, cfg, tables, _t(enc), None, 0,
                                    compute_dtype=torch.float32, remat=True,
                                    noise_override=noise, timestep_id=tid, device="cpu")
    assert len(calls) == 10
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-4)
    _check_grads(port_lora, grads, jgrads, cfg)
