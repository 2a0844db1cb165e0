"""Pooled AdaLN on the bridge's v2a blocks (`models/bridge.py`) on the CPU in
fp32, against the JAX package on the same weights (the port's modules read
by JAX's own converter): the per-frame pooling, the time interpolation
(growing and shrinking), the AdaLN, the whole condition and the v2a block
within 1e-5; one tiny dual-tower step with a pooled bridge within 1e-4; the
checkpoint names JAX's converter and exporter use; `from_jax`; the fp8 set
of `cast_tree_fp8`; and the init-time check that MOVA-360p's widths fail
(5120 % 12 != 0), with JAX's error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import nn as jnn
from dualforce_tpu.config import mova_360p as jax_mova_360p
from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.convert import torch_export, torch_import
from dualforce_tpu.diffusion.step import dual_tower_step as jax_step
from dualforce_tpu.models import bridge as jbridge

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.config import mova_360p, tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.diffusion.step import dual_tower_step
from dualforce_tpu_torch.models import bridge as tbridge
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_streamed import one_torch_thread  # noqa: F401 (autouse)

GRID = (3, 2, 4)   # latent frames, height, width of the video tokens


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """XLA's optimisation passes off for the JAX reference (the same math,
    compiled faster at these sizes); restored afterwards."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _pooled(cfg):
    return dataclasses.replace(cfg, bridge=dataclasses.replace(cfg.bridge, pooled_adaln=True))


@pytest.fixture(scope="module")
def setup():
    """A pooled tiny config (audio width 96: 2 query heads on the v2a side),
    the port's fp32 modules and JAX's trees of them."""
    cfg = _pooled(tiny_test_config(audio_dim=96))
    jcfg = _pooled(jax_tiny_config(audio_dim=96))
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                with_vaes=False, with_text=False, two_video_towers=False)
    sd = {n: {k: v.numpy() for k, v in m.state_dict().items()} for n, m in mods.items()}
    jparams = {"video_dit": torch_import.convert_video_dit(sd["video_dit"], jcfg.video_dit),
               "audio_dit": torch_import.convert_audio_dit(sd["audio_dit"], jcfg.audio_dit),
               "bridge": torch_import.convert_bridge(sd["bridge"], jcfg.bridge)}
    return cfg, jcfg, mods, jparams


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_pooled_functions_match_jax(setup):
    cfg, jcfg, mods, jparams = setup
    block = mods["bridge"].video_to_audio_conditioners["0"]
    jp = jax.tree.map(lambda x: x[0], jparams["bridge"]["v2a"])
    heads = block.num_heads
    assert heads == 2
    g = np.random.default_rng(0)
    y = g.standard_normal((2, int(np.prod(GRID)), 96)).astype(np.float32)
    x = g.standard_normal((2, 25, 96)).astype(np.float32)
    ty, tx = torch.from_numpy(y), torch.from_numpy(x)
    pooled = tbridge.per_frame_attention_pooling(block.per_frame_pooling, ty, GRID, heads)
    jpooled = jbridge.per_frame_attention_pooling(jp["pool"], y, GRID, heads, cfg.bridge.eps)
    _close(pooled, jpooled, 1e-5)
    for n in (1, 2, 3, 7, 25, 40):     # shrinking (antialiased in JAX), equal, growing
        _close(tbridge.interp_linear_time(pooled, n),
               jbridge._interp_linear_time(jnp.asarray(pooled.numpy()), n), 1e-5)
    _close(tbridge.adaln_from_pooled(block.adaln, tx, pooled),
           jbridge._adaln_from_pooled(jp, x, jnp.asarray(pooled.numpy())), 1e-5)
    _close(block.pooled_condition(tx, ty, GRID),
           jbridge.pooled_adaln_condition(jp, x, y, GRID, heads, cfg.bridge.eps), 1e-5)
    _close(block(tx, ty, None, None, "ref", video_grid=GRID),
           jbridge.cond_block_apply(jp, x, y, None, None, num_heads=heads,
                                    eps=cfg.bridge.eps, attn_impl="ref", video_grid=GRID),
           1e-5)
    with pytest.raises(ValueError, match="video_grid"):
        block(tx, ty, None, None, "ref")


def test_pooled_step_matches_jax(setup):
    """One dual-tower step on a 3 x 4 x 8 latent grid (video tokens 3 x 2 x 4)."""
    cfg, jcfg, mods, jparams = setup
    g = np.random.default_rng(1)
    lat = g.standard_normal((1, 36, 3, 4, 8)).astype(np.float32)
    alat = g.standard_normal((1, 8, 25)).astype(np.float32)
    ctx = g.standard_normal((1, 16, 32)).astype(np.float32)
    t = np.array([700.0], np.float32)
    v, a = dual_tower_step(mods["video_dit"], mods["audio_dit"], mods["bridge"],
                           torch.from_numpy(lat), torch.from_numpy(alat),
                           torch.from_numpy(ctx), torch.from_numpy(t),
                           compute_dtype=torch.float32, attn_impl="ref")
    jv, ja = jax.jit(jax_step, static_argnums=(3, 4, 5),
                     static_argnames=("compute_dtype", "attn_impl"))(
        jparams["video_dit"], jparams["audio_dit"], jparams["bridge"], jcfg.video_dit,
        jcfg.audio_dit, jcfg.bridge, lat, alat, ctx, t, compute_dtype=jnp.float32,
        attn_impl="ref")
    _close(v, jv, 1e-4)
    _close(a, ja, 1e-4)


def test_checkpoint_names_and_from_jax(setup, tmp_path):
    """The port's bridge names are those JAX's exporter writes and its
    converter reads; `from_jax` carries the JAX tree back exactly; the
    port's checkpoint writer and loader round-trip the pooled bridge."""
    cfg, jcfg, mods, jparams = setup
    exported = torch_export.export_bridge(jax.tree.map(np.asarray, jparams["bridge"]),
                                          jcfg.bridge)
    sd = mods["bridge"].state_dict()
    assert set(exported) == set(sd)
    assert any(".per_frame_pooling.attention.in_proj_weight" in k for k in sd)
    assert not any(k.startswith("audio_to_video") and "pool" in k for k in sd)
    fresh = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=5,
                                 with_vaes=False, with_text=False, two_video_towers=False)
    from_jax.load({"bridge": fresh["bridge"]},
                  {"bridge": jax.tree.map(np.asarray, jparams["bridge"])}, cfg)
    for k, v in sd.items():
        torch.testing.assert_close(fresh["bridge"].state_dict()[k], v, rtol=0, atol=0)
        np.testing.assert_array_equal(exported[k], v.numpy())
    lc.save_pipeline_params({"bridge": mods["bridge"]}, cfg, str(tmp_path), index=False)
    loaded = lc.load_module(str(tmp_path), "bridge", cfg, torch.float32, "cpu")
    for k, v in sd.items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


def test_fp8_set_matches_cast_tree_fp8(setup):
    cfg, _, mods, jparams = setup
    jtree = jax.tree.map(np.asarray, jnn.cast_tree_fp8(jparams["bridge"], jnp.float8_e4m3fn))
    jax_sd = {k: from_jax._tensor(v) for k, v in
              from_jax.state_dicts({"bridge": jtree}, cfg)["bridge"].items()}
    fp8 = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                               with_vaes=False, with_text=False,
                               two_video_towers=False)["bridge"]
    tnn.cast_modules_fp8(fp8)
    port_sd = fp8.state_dict()
    port_fp8 = {k for k, v in port_sd.items() if v.dtype == torch.float8_e4m3fn}
    assert port_fp8 == {k for k, v in jax_sd.items() if v.dtype == torch.float8_e4m3fn}
    assert {k for k in port_fp8 if "per_frame_pooling" in k or "adaln" in k}
    for k in port_fp8:
        assert torch.equal(port_sd[k].view(torch.uint8), jax_sd[k].view(torch.uint8)), k


def test_mova_360p_widths_raise_as_jax():
    """v2a pools the 5120-wide video over the audio side's 12 heads."""
    bcfg = dataclasses.replace(mova_360p().bridge, pooled_adaln=True)
    jbcfg = dataclasses.replace(jax_mova_360p().bridge, pooled_adaln=True)
    with pytest.raises(ValueError) as want:
        jbridge.cond_block_init(jax.random.PRNGKey(0), jbcfg.audio_hidden_dim,
                                jbcfg.visual_hidden_dim, pooled_adaln=True,
                                num_heads=jbcfg.audio_hidden_dim // jbcfg.head_dim)
    with torch.device("meta"), pytest.raises(ValueError) as got:
        tbridge.DualTowerBridge(bcfg)
    assert str(got.value) == str(want.value)
