"""The port's primitives, RoPE, DiT block, bridge layer and dual-tower step
held against the JAX package on the CPU, in fp32.

Inputs come from numpy seeds. Weights are the port's random modules, read
into JAX trees by the JAX package's own checkpoint converters
(`convert/torch_import.py`), which also checks that the port's parameter
names are the MOVA state-dict names. Tolerances are fp32 round-off over a
few layers: 2e-5 for single ops, 1e-4 for a block or a whole step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import nn as jnn
from dualforce_tpu.convert import torch_import
from dualforce_tpu.diffusion.step import dual_tower_step as jax_dual_tower_step
from dualforce_tpu.models import bridge as jax_bridge
from dualforce_tpu.models import video_dit as jax_video_dit
from dualforce_tpu.ops import rope as jax_rope

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.config import (AudioDiTConfig, BridgeConfig, MOVAConfig,
                                        VideoDiTConfig, tiny_test_config)
from dualforce_tpu_torch.diffusion.step import dual_tower_step, make_rope_pack
from dualforce_tpu_torch.models.bridge import DualTowerBridge
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.models.video_dit import DiTBlock
from dualforce_tpu_torch.ops import rope as trope

TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off: the same
    math, compiled in about two thirds of the time at these sizes. The
    setting is restored for the test files that follow."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _flagship_mini():
    """The `__graft_entry__._flagship_mini()` geometry: head_dim 128 on every
    tower and the bridge, "full" strategy (4 video / 2 audio layers)."""
    return MOVAConfig(
        video_dit=VideoDiTConfig(dim=512, in_dim=36, ffn_dim=1536, out_dim=16,
                                 text_dim=256, freq_dim=64, num_heads=4,
                                 num_layers=4, rope_max_len=64),
        audio_dit=AudioDiTConfig(dim=256, in_dim=32, ffn_dim=768, out_dim=32,
                                 text_dim=256, freq_dim=64, num_heads=2,
                                 num_layers=2, rope_max_len=256),
        bridge=BridgeConfig(visual_layers=4, audio_layers=2, visual_hidden_dim=512,
                            audio_hidden_dim=256, head_dim=128,
                            interaction_strategy="full", apply_cross_rope=True,
                            audio_fps=50.0),
    )


def _jax_config(cfg):
    """The JAX package's MOVAConfig with the same field values."""
    import dataclasses

    from dualforce_tpu import config as jc

    def conv(obj, cls):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})

    return jc.MOVAConfig(
        video_dit=conv(cfg.video_dit, jc.VideoDiTConfig),
        audio_dit=conv(cfg.audio_dit, jc.AudioDiTConfig),
        bridge=conv(cfg.bridge, jc.BridgeConfig),
        video_vae=conv(cfg.video_vae, jc.WanVAEConfig),
        audio_vae=conv(cfg.audio_vae, jc.DACVAEConfig),
        text_encoder=conv(cfg.text_encoder, jc.UMT5Config),
        scheduler=conv(cfg.scheduler, jc.SchedulerConfig),
        boundary_ratio=cfg.boundary_ratio, audio_vae_type=cfg.audio_vae_type,
        two_video_towers=cfg.two_video_towers)


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _towers(cfg):
    """The port's random DiT/bridge modules and the JAX params the JAX
    package's converters read from their state dicts."""
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=1,
                                with_vaes=False, with_text=False,
                                two_video_towers=False)
    jcfg = _jax_config(cfg)
    jparams = {
        "video_dit": torch_import.convert_video_dit(_sd(mods["video_dit"]), jcfg.video_dit),
        "audio_dit": torch_import.convert_audio_dit(_sd(mods["audio_dit"]), jcfg.audio_dit),
        "bridge": torch_import.convert_bridge(_sd(mods["bridge"]), jcfg.bridge),
    }
    return jparams, mods


def test_nn_primitives():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    w, b = rng.standard_normal(48).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        tnn.layer_norm(_t(x), 1e-6, _t(w), _t(b)).numpy(),
        np.asarray(jnn.layer_norm(x, 1e-6, {"scale": w, "bias": b})), **OP_TOL)
    np.testing.assert_allclose(tnn.layer_norm(_t(x)).numpy(),
                               np.asarray(jnn.layer_norm(x)), **OP_TOL)
    np.testing.assert_allclose(tnn.rms_norm(_t(x), _t(w)).numpy(),
                               np.asarray(jnn.rms_norm(x, {"scale": w})), **OP_TOL)
    np.testing.assert_allclose(tnn.gelu_tanh(_t(x)).numpy(),
                               np.asarray(jnn.gelu_tanh(x)), **OP_TOL)
    np.testing.assert_allclose(torch.nn.functional.silu(_t(x)).numpy(),
                               np.asarray(jnn.silu(x)), **OP_TOL)
    kern = rng.standard_normal((48, 16)).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.linear(_t(x), _t(kern.T), _t(b[:16])).numpy(),
        np.asarray(jnn.linear({"kernel": kern, "bias": b[:16]}, x)), **OP_TOL)
    pos = np.array([0.0, 3.0, 999.0], np.float32)
    np.testing.assert_allclose(tnn.sinusoidal_embedding_1d(32, _t(pos)).numpy(),
                               np.asarray(jnn.sinusoidal_embedding_1d(32, pos)),
                               rtol=1e-5, atol=1e-4)

    # patchify / unpatchify in the same token order, from the conv-layout weight
    v = rng.standard_normal((2, 4, 3, 6, 8)).astype(np.float32)
    k3 = rng.standard_normal((4 * 1 * 2 * 2, 10)).astype(np.float32)
    w3 = k3.reshape(4, 1, 2, 2, 10).transpose(4, 0, 1, 2, 3)
    got, grid = tnn.patch_embed_3d(_t(v), _t(w3), _t(b[:10]), (1, 2, 2))
    want, jgrid = jnn.patch_embed_3d({"kernel": k3, "bias": b[:10]}, v, (1, 2, 2))
    assert grid == jgrid
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    toks = rng.standard_normal((2, 3 * 3 * 4, 1 * 2 * 2 * 5)).astype(np.float32)
    np.testing.assert_array_equal(tnn.unpatchify_3d(_t(toks), (3, 3, 4), (1, 2, 2), 5).numpy(),
                                  np.asarray(jnn.unpatchify_3d(toks, (3, 3, 4), (1, 2, 2), 5)))
    a = rng.standard_normal((2, 4, 12)).astype(np.float32)
    k1 = rng.standard_normal((4 * 2, 6)).astype(np.float32)
    got, f = tnn.patch_embed_1d(_t(a), _t(k1.reshape(4, 2, 6).transpose(2, 0, 1)),
                                _t(b[:6]), 2)
    want, jf = jnn.patch_embed_1d({"kernel": k1, "bias": b[:6]}, a, 2)
    assert f == jf
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    toks = rng.standard_normal((2, 6, 2 * 3)).astype(np.float32)
    np.testing.assert_array_equal(tnn.unpatchify_1d(_t(toks), 2, 3).numpy(),
                                  np.asarray(jnn.unpatchify_1d(toks, 2, 3)))


def test_rope_tables_and_appliers():
    tables = trope.precompute_freqs_3d(48, end=16)
    for got, want in zip(tables, jax_rope.precompute_freqs_3d(48, end=16)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for variant in ("dac", "oobleck"):
        for got, want in zip(trope.precompute_freqs_1d(32, 40, variant=variant),
                             jax_rope.precompute_freqs_1d(32, 40, variant=variant)):
            np.testing.assert_array_equal(got, want)
    cos, sin = trope.build_video_freqs(tables, (2, 3, 4))
    jcos, jsin = jax_rope.build_video_freqs(tables, (2, 3, 4))
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    kw = dict(video_fps=24.0, grid=(3, 2, 2), audio_steps=9, audio_fps=50.0, head_dim=16)
    for ffb in (False, True):
        got = trope.build_aligned_cross_rope(first_frame_bias=ffb, **kw)
        want = jax_rope.build_aligned_cross_rope(first_frame_bias=ffb, **kw)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 3, 48)).astype(np.float32)
    np.testing.assert_allclose(
        trope.apply_rope_interleaved(_t(x), _t(cos), _t(sin)).numpy(),
        np.asarray(jax_rope.apply_rope_interleaved(x, jcos, jsin)), **OP_TOL)
    (cv, sv), _ = want
    xh = rng.standard_normal((1, 12, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(trope.apply_rope_half(_t(xh), _t(cv), _t(sv)).numpy(),
                               np.asarray(jax_rope.apply_rope_half(xh, cv, sv)), **OP_TOL)


@pytest.mark.parametrize("cfg_fn,tokens", [(tiny_test_config, (2, 4, 6)),
                                           (_flagship_mini, (2, 12, 12))],
                         ids=["tiny", "flagship_mini"])
def test_video_block(cfg_fn, tokens):
    """One DiT block (6-way AdaLN, self-attention with RoPE, text cross-
    attention, FFN); at flagship_mini the 288 tokens take the flash path."""
    cfg = cfg_fn().video_dit
    torch.manual_seed(5)
    block = DiTBlock(cfg.dim, cfg.ffn_dim, cfg.num_heads, cfg.eps)
    with torch.no_grad():
        block.modulation.normal_(std=0.1)
    jp = torch_import._dit_block({f"b.{k}": v for k, v in _sd(block).items()}, "b")
    rng = np.random.default_rng(2)
    s = int(np.prod(tokens))
    x = rng.standard_normal((2, s, cfg.dim)).astype(np.float32)
    ctx = rng.standard_normal((2, 11, cfg.dim)).astype(np.float32)
    t_mod = rng.standard_normal((2, 6, cfg.dim)).astype(np.float32) * 0.1
    cos, sin = jax_rope.build_video_freqs(jax_rope.precompute_freqs_3d(cfg.head_dim, 64),
                                          tokens)
    want = jax.jit(lambda *a: jax_video_dit.dit_block_apply(
        *a, num_heads=cfg.num_heads, eps=cfg.eps, attn_impl="auto"))(
        jp, x, ctx, t_mod, (cos, sin))
    with torch.no_grad():
        got = block(_t(x), _t(ctx), _t(t_mod), (_t(cos), _t(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cfg_fn,grid,audio_t", [(tiny_test_config, (2, 4, 4), 25),
                                                  (_flagship_mini, (2, 12, 12), 25)],
                         ids=["tiny", "flagship_mini"])
def test_bridge_layer(cfg_fn, grid, audio_t):
    """One bridge interaction (a2v then v2a, cross RoPE, condition scales) at
    shared layer 1; at flagship_mini the 288 video queries take the flash
    path and the 25 audio queries the reference path."""
    cfg = cfg_fn()
    jparams, mods = _towers(cfg)
    jb = jparams["bridge"]
    rng = np.random.default_rng(3)
    vx = rng.standard_normal((1, int(np.prod(grid)), cfg.bridge.visual_hidden_dim)
                             ).astype(np.float32)
    ax = rng.standard_normal((1, audio_t, cfg.bridge.audio_hidden_dim)).astype(np.float32)
    (cv, sv), (ca, sa) = jax_rope.build_aligned_cross_rope(
        video_fps=24.0, grid=grid, audio_steps=audio_t, audio_fps=50.0,
        head_dim=cfg.bridge.head_dim)
    want_v, want_a = jax.jit(lambda *a: jax_bridge.layer_apply(
        *a, _jax_config(cfg).bridge, 0.7, 1.3))(
        jax.tree.map(lambda a: a[1], jb["a2v"]), jax.tree.map(lambda a: a[1], jb["v2a"]),
        vx, ax, (cv, sv), (ca, sa))
    bridge: DualTowerBridge = mods["bridge"]
    with torch.no_grad():
        got_v, got_a = bridge.layer_apply(1, _t(vx), _t(ax), (_t(cv), _t(sv)),
                                          (_t(ca), _t(sa)), torch.tensor(0.7),
                                          torch.tensor(1.3))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


@pytest.mark.parametrize("cfg_fn,grid,audio_t", [
    (tiny_test_config, (3, 8, 8), 25),
    (lambda: tiny_test_config(visual_layers=4, audio_layers=3,
                              interaction_strategy="distributed"), (3, 8, 8), 25),
    (_flagship_mini, (2, 24, 24), 50),
], ids=["tiny_full", "tiny_sparse", "flagship_mini"])
def test_dual_tower_step(cfg_fn, grid, audio_t):
    """A whole step: time/text embeds, patchify, the interleaved towers with
    the bridge (full and sparse strategies) and the video-only tail, heads."""
    cfg = cfg_fn()
    jparams, mods = _towers(cfg)
    rng = np.random.default_rng(4)
    f, h, w = grid
    visual = rng.standard_normal((1, cfg.video_dit.in_dim, f, h, w)).astype(np.float32)
    audio = rng.standard_normal((1, cfg.audio_dit.in_dim, audio_t)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, cfg.video_dit.text_dim)).astype(np.float32)
    t, at = np.array([750.0], np.float32), np.array([620.0], np.float32)
    jcfg = _jax_config(cfg)
    want_v, want_a = jax.jit(lambda vp, ap, bp, *x: jax_dual_tower_step(
        vp, ap, bp, jcfg.video_dit, jcfg.audio_dit, jcfg.bridge, *x, video_fps=24.0,
        compute_dtype=jnp.float32, attn_impl="auto"))(
        jparams["video_dit"], jparams["audio_dit"], jparams["bridge"], visual, audio,
        ctx, t, at)
    with torch.no_grad():
        got_v, got_a = dual_tower_step(
            mods["video_dit"], mods["audio_dit"], mods["bridge"], _t(visual), _t(audio),
            _t(ctx), _t(t), _t(at), video_fps=24.0, compute_dtype=torch.float32)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_make_rope_pack_matches():
    from dualforce_tpu.diffusion.step import make_rope_pack as jax_pack

    cfg = tiny_test_config()
    jcfg = _jax_config(cfg)
    got = make_rope_pack(cfg.video_dit, cfg.audio_dit, cfg.bridge, (3, 4, 4), 25,
                         device="cpu")
    want = jax_pack(jcfg.video_dit, jcfg.audio_dit, jcfg.bridge, (3, 4, 4), 25)
    assert set(got) == set(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
