"""The port's LoRA training slice against the JAX package, on the CPU in fp32.

Weights are the port's random modules, read into JAX trees by the JAX
package's own checkpoint converters; the JAX LoRA tree is carried into the
port by `convert.from_jax.lora`. The timestep id is pinned to the one JAX
draws and the noise comes from numpy (`noise_override`), since `jax.random`
is not reproduced. Tolerances: 1e-4 relative on encodes and losses, 1e-3
relative (atol 1e-6) on LoRA gradients, fp32 round-off through a few layers
and their backward; 1e-6 on optimizer updates; 1e-5 on schedules (optax
evaluates them in fp32, the port in float64).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.convert import torch_import
from dualforce_tpu.convert.load_checkpoint import _convert_wan_vae
from dualforce_tpu.diffusion import training as jtr
from dualforce_tpu.diffusion.flow_match import FlowMatchPairScheduler as JaxScheduler
from dualforce_tpu.engine import lora as jlora
from dualforce_tpu.engine import optim as joptim
from dualforce_tpu.models import dac_vae as jax_dac
from dualforce_tpu.models.umt5 import convert_umt5

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion import training as ttr
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.engine import lora as tlora
from dualforce_tpu_torch.engine import optim as toptim
from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
from dualforce_tpu_torch.models import dac_vae
from dualforce_tpu_torch.models.factory import init_pipeline_params

CFG_KW = dict(visual_layers=3, audio_layers=2)   # the video-only tail runs too
ENC_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _jax_params(modules, jcfg):
    sd = {name: _sd(m) for name, m in modules.items()}
    out = {"video_dit": torch_import.convert_video_dit(sd["video_dit"], jcfg.video_dit),
           "audio_dit": torch_import.convert_audio_dit(sd["audio_dit"], jcfg.audio_dit),
           "bridge": torch_import.convert_bridge(sd["bridge"], jcfg.bridge)}
    if "video_dit_2" in sd:
        out["video_dit_2"] = torch_import.convert_video_dit(sd["video_dit_2"], jcfg.video_dit)
    if "text_encoder" in sd:
        out["text_encoder"] = convert_umt5(sd["text_encoder"], jcfg.text_encoder)
        out["video_vae"] = _convert_wan_vae(sd["video_vae"], jcfg.video_vae)
        out["audio_vae"] = torch_import.convert_dac(sd["audio_vae"], jcfg.audio_vae)
    return out


def _batch(b=1, T=5, H=32, W=32, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 64), np.int64)
    mask[:, 40:] = 0
    return {"video": rng.uniform(-1, 1, (b, T, H, W, 3)).astype(np.float32),
            "audio": rng.uniform(-0.3, 0.3, (b, 1, int(48000 * T / 24))).astype(np.float32),
            "text_ids": rng.integers(2, 500, (b, 64)), "text_mask": mask}


def _tables(cfg, sched_cls):
    sched = sched_cls(cfg.scheduler)
    sched.set_timesteps(1000, training=True)
    build = ttr.build_train_tables if sched_cls is FlowMatchPairScheduler \
        else jtr.build_train_tables
    return build(sched, cfg.boundary_ratio)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _jax_lora(jparams, rank=4):
    """A JAX LoRA tree with nonzero b, so both factors get gradients."""
    lora = jlora.init_pipeline_lora(jax.random.PRNGKey(1), jparams, rank=rank)
    return jax.tree.map(lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
                        lora)


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = tiny_test_config(**CFG_KW), jax_tiny_config(**CFG_KW)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    jparams = _jax_params(mods, jcfg)
    batch = _batch()
    encode = jax.jit(lambda p, b: jtr.encode_batch(p, jcfg, b, compute_dtype=jnp.float32))
    jenc = _np(encode(jparams, jax.tree.map(jnp.asarray, batch)))
    return dict(cfg=cfg, jcfg=jcfg, mods=mods, jparams=jparams, batch=batch, jenc=jenc,
                tables=_tables(cfg, FlowMatchPairScheduler),
                jtables=_tables(jcfg, JaxScheduler))


def test_encode_batch_matches_jax(tiny):
    """UMT5 (masked), the streaming Wan-VAE encodes of the clip and of its
    first frame with the training mask, and the DAC encode."""
    got = ttr.encode_batch(tiny["mods"], tiny["cfg"], tiny["batch"],
                           compute_dtype=torch.float32, device="cpu")
    assert set(got) == set(tiny["jenc"])
    for key, want in tiny["jenc"].items():
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key].numpy(), want, err_msg=key, **ENC_TOL)


def test_dac_encode_mode_matches_jax(tiny):
    """`encode_mode` on audio whose length is not a multiple of the hop."""
    audio = np.random.default_rng(5).uniform(-0.5, 0.5, (2, 1, 3001)).astype(np.float32)
    acfg = tiny["cfg"].audio_vae
    want = np.asarray(jax_dac.encode_mode(tiny["jparams"]["audio_vae"],
                                          tiny["jcfg"].audio_vae, audio))
    got = dac_vae.encode_mode(tiny["mods"]["audio_vae"], torch.from_numpy(audio))
    assert got.shape == (2, acfg.latent_dim, -(-3001 // acfg.hop_length))
    np.testing.assert_allclose(got.numpy(), want, **ENC_TOL)


def test_train_tables_match_jax(tiny):
    got, want = tiny["tables"], tiny["jtables"]
    assert got.boundary_id == want.boundary_id
    for f in ("timesteps_visual", "timesteps_audio", "sigmas_visual", "sigmas_audio"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("scheme", ["uniform", "logit_normal"])
@pytest.mark.parametrize("expert", [0, 1])
def test_sample_timestep_id_statistics(tiny, scheme, expert):
    """Each expert's ids stay in its range, and their distribution follows
    the scheme's CDF, as the JAX package's draws do (statistics, not values:
    the two generators differ)."""
    tables = tiny["tables"]
    n, boundary = len(tables.timesteps_visual), tables.boundary_id
    lo, hi = (0, boundary) if expert == 0 else (boundary, n)
    tc = ttr.TimestepConfig(weighting_scheme=scheme)
    g = torch.Generator().manual_seed(expert)
    ours = np.array([ttr.sample_timestep_id(g, tables, expert, tc) for _ in range(3000)])
    jtc = jtr.TimestepConfig(weighting_scheme=scheme)
    theirs = np.asarray(jax.vmap(lambda k: jtr.sample_timestep_id(
        k, tiny["jtables"], expert, jtc))(jax.random.split(jax.random.PRNGKey(0), 3000)))
    for ids in (ours, theirs):
        assert ids.min() >= lo and ids.max() < hi
    eps = 1e-7

    def logit(p):
        p = np.clip(p, eps, 1 - eps)
        return np.log(p / (1 - p))

    from scipy.stats import norm

    for t in np.linspace(lo + 0.1 * (hi - lo), lo + 0.9 * (hi - lo), 5):
        if scheme == "uniform":
            cdf = (t - lo) / (hi - lo)
        else:
            ca, cb = norm.cdf(logit(lo / n)), norm.cdf(logit(hi / n))
            cdf = (norm.cdf(logit(t / n)) - ca) / (cb - ca)
        for ids in (ours, theirs):
            assert abs(float((ids < t).mean()) - cdf) < 0.03, (t, cdf)


def test_mode_scheme_refuses_expert_ranges(tiny):
    tc = ttr.TimestepConfig(weighting_scheme="mode")
    with pytest.raises(ValueError):
        ttr.sample_timestep_id(torch.Generator(), tiny["tables"], 0, tc)
    with pytest.raises(ValueError):
        jtr.sample_timestep_id(jax.random.PRNGKey(0), tiny["jtables"], 0,
                               jtr.TimestepConfig(weighting_scheme="mode"))


def _noise(enc, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(enc["video_latents"].shape).astype(np.float32),
            rng.standard_normal(enc["audio_latents"].shape).astype(np.float32))


def test_schedules_match_optax():
    for kind in ("cosine", "linear", "constant"):
        for warmup, total in ((3, 10), (0, 5), (100, 2000)):
            got = toptim.warmup_schedule(1e-4, warmup, total, kind, min_lr_ratio=0.1)
            want = joptim.warmup_schedule(1e-4, warmup, total, kind, min_lr_ratio=0.1)
            for n in (0, 1, 2, 3, 4, 7, 99, 100, 101, 1500, 2500):
                np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-5, atol=1e-12,
                                           err_msg=f"{kind} {warmup} {total} {n}")


def test_adamw_clip_schedule_match_optax():
    """Five steps of the port's AdamW against the JAX package's `adamw` on
    the same gradients: one step clipped, one parameter whose gradient is 0
    throughout (its weight decay and moments still move, as in optax)."""
    rng = np.random.default_rng(3)
    shapes = [(6, 4), (4,), (3, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (0.1 if i != 2 else 5.0)
              for s in shapes] for i in range(5)]
    for step in grads:
        step[1][:] = 0.0
    schedule = joptim.warmup_schedule(1e-2, 2, 6, "cosine")
    tx = joptim.adamw(lr=1e-2, weight_decay=0.1, max_grad_norm=1.0, schedule=schedule)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = toptim.AdamW(tp, lr=1e-2, weight_decay=0.1, max_grad_norm=1.0,
                       schedule=toptim.warmup_schedule(1e-2, 2, 6, "cosine"))
    for step in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step], state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([torch.from_numpy(g) for g in step])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(step)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert not np.array_equal(tp[1].numpy(), params[1])     # decayed with zero grads


def test_grad_accumulation_equivalence(tiny):
    """Two micro-batches of one, accumulated, equal one batch of two (mean
    loss, same timestep id, per-item noise pinned)."""
    cfg = tiny["cfg"]
    big = ttr.encode_batch(tiny["mods"], cfg, _batch(b=2, seed=4), compute_dtype=torch.float32,
                           device="cpu")
    lora = from_jax.lora(_np(_jax_lora(tiny["jparams"])), cfg)
    nv, na = _noise({k: v.numpy() for k, v in big.items()}, 12)
    kw = dict(compute_dtype=torch.float32, remat=False, timestep_id=123, device="cpu")
    g_big, _ = ttr.lora_grads(lora, tiny["mods"], cfg, tiny["tables"], big, None, 0,
                              noise_override=(nv, na), **kw)
    acc = None
    for i in range(2):
        micro = {k: v[i:i + 1] for k, v in big.items()}
        g, _ = ttr.lora_grads(lora, tiny["mods"], cfg, tiny["tables"], micro, None, 0,
                              noise_override=(nv[i:i + 1], na[i:i + 1]), **kw)
        acc = ttr.accumulate(acc, g, 2)
    for a, b in zip(acc, g_big):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6)


def _trainer(tiny, save_dir, **kw):
    tcfg = TrainerConfig(**{**dict(max_steps=4, warmup_steps=1, save_interval=2,
                                   log_interval=1, save_dir=str(save_dir), logger="jsonl",
                                   lora_rank=2, compute_dtype=torch.float32,
                                   attn_impl="ref", remat=False, lr=1e-3), **kw})
    return LoRATrainer(tiny["cfg"], tiny["mods"], tcfg, device="cpu")


def test_trainer_loop_save_and_resume(tiny, tmp_path):
    """Expert alternation per step, logging, `step-N` saves, the saved LoRA
    (the JAX package's npz) read back by both packages, and a run resumed
    from `step-2` ending where an uninterrupted run ends."""
    batches = [tiny["batch"]] * 10
    full = _trainer(tiny, tmp_path / "full")
    records = []
    assert full.train(iter(batches), on_micro_step=records.append) == 4
    assert [r["expert"] for r in records] == [0, 1, 0, 1]
    assert all(r["flash_fwd"] == r["flash_bwd"] == r["flash_bwd_split"] == 0
               for r in records)   # attn_impl="ref"
    assert all(r["encode_s"] > 0 and r["loss_backward_s"] > 0 and r["optimizer_s"] > 0
               and np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    lines = (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(json.loads(x)["loss"]) for x in lines)
    for step in (2, 4):
        assert (tmp_path / "full" / f"step-{step}" / "lora_weights.npz").is_file()

    npz = str(tmp_path / "full" / "step-4" / "lora_weights.npz")
    back, meta = tlora.load_lora(npz, tiny["cfg"].bridge.interaction_layers())
    assert meta == {"alpha": 16.0, "rank": 2}
    for m, tree in full.lora.items():
        for n, ab in tree.items():
            for p in ("a", "b"):
                torch.testing.assert_close(back[m][n][p], ab[p].detach(), rtol=0, atol=0)
    assert all(torch.count_nonzero(ab["b"]) > 0 for tree in full.lora.values()
               for ab in tree.values())

    half = _trainer(tiny, tmp_path / "half", max_steps=2)
    assert half.train(iter(batches)) == 2
    resumed = _trainer(tiny, tmp_path / "half")
    assert resumed.global_step == 2
    assert resumed.train(iter(batches)) == 4
    for a, b in zip(tlora.lora_parameters(resumed.lora), tlora.lora_parameters(full.lora)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_trainer_records_micro_steps_under_accumulation(tiny, tmp_path):
    """With 2 micro-batches per step both experts collect grads within one
    step; only a step's last micro-batch runs the optimizer and has a norm."""
    records = []
    trainer = _trainer(tiny, tmp_path, max_steps=2, grad_accum_steps=2, logger="none")
    assert trainer.train(iter([tiny["batch"]] * 6), on_micro_step=records.append) == 2
    assert [r["expert"] for r in records] == [0, 1, 0, 1]
    assert [r["optimizer_s"] > 0 for r in records] == [False, True, False, True]
    assert ["grad_norm" in r for r in records] == [False, True, False, True]


def test_saved_lora_loads_and_merges_in_jax(tiny, tmp_path):
    """The port's targets are the JAX package's; a JAX LoRA carried over
    merges to the same weights in both packages; a port-saved npz loads
    through the JAX `load_lora` to the same tree."""
    cfg, jparams = tiny["cfg"], tiny["jparams"]
    jl = _np(_jax_lora(jparams))
    port_lora = from_jax.lora(jl, cfg)
    for m in ("video_dit", "video_dit_2", "audio_dit", "bridge"):
        assert sorted(port_lora[m]) == sorted(tlora.lora_targets(tiny["mods"][m]))
    jmerged = jlora.merge_pipeline_lora(jparams, jl, alpha=16.0)
    want = from_jax.state_dicts(_np({m: jmerged[m] for m in port_lora}), cfg)
    got = tlora.merge_pipeline_lora(tiny["mods"], port_lora, alpha=16.0)
    for m, tree in got.items():
        for name, w in tree.items():
            np.testing.assert_allclose(w.detach().numpy(), want[m][name], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{m} {name}")
    tlora.save_lora(port_lora, str(tmp_path / "lora.npz"), alpha=16.0, rank=4)
    back, meta = jlora.load_lora(str(tmp_path / "lora.npz"))
    assert meta == {"alpha": 16.0, "rank": 4}
    assert jax.tree.structure(back) == jax.tree.structure(jl)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jl)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_lora_training_learns_one_batch(tiny):
    """Twenty LoRA steps on one fixed batch (fixed timestep id and noise)
    bring the flow-match loss down."""
    cfg = tiny["cfg"]
    enc = _t(tiny["jenc"])
    lora = tlora.init_pipeline_lora(tiny["mods"], 4, torch.Generator().manual_seed(0))
    opt = toptim.AdamW(tlora.lora_parameters(lora), lr=1e-2, weight_decay=0.0)
    noise = _noise(tiny["jenc"], 13)
    losses = []
    for _ in range(20):
        m = ttr.lora_step(lora, opt, tiny["mods"], cfg, tiny["tables"], enc, None, 0,
                          compute_dtype=torch.float32, remat=False, noise_override=noise,
                          timestep_id=40, device="cpu")
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0], losses


def test_trainer_refuses_what_is_not_ported(tiny, tmp_path):
    """`mode="full"` and `remat_save_attention`, once refused, now train (one
    step each, on copies of the modules: full fine-tuning trains them in
    place); `training_loss` takes `full_finetune_params`; full fine-tuning
    under component offload stays refused, as the JAX package refuses it."""
    for kw in (dict(mode="full", trainable_modules=("audio_dit",), dir="full"),
               dict(remat_save_attention=True, remat=True, attn_impl="pallas", dir="save")):
        mods = {k: copy.deepcopy(v) for k, v in tiny["mods"].items()}
        tcfg = TrainerConfig(**{**dict(max_steps=1, save_dir=str(tmp_path / kw.popitem()[1]),
                                       logger="none", lora_rank=2, lr=1e-3,
                                       compute_dtype=torch.float32, attn_impl="ref",
                                       remat=False), **kw})
        trainer = LoRATrainer(tiny["cfg"], mods, tcfg, device="cpu")
        records = []
        assert trainer.train(iter([tiny["batch"]]), on_micro_step=records.append) == 1
        assert np.isfinite(records[0]["loss"]) and records[0]["grad_norm"] > 0
    loss, _ = ttr.training_loss(None, tiny["mods"], tiny["cfg"], tiny["tables"],
                                _t(tiny["jenc"]), None, 0, compute_dtype=torch.float32,
                                remat=False, attn_impl="ref", timestep_id=5,
                                full_finetune_params={"audio_dit": tiny["mods"]["audio_dit"]},
                                device="cpu")
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="LoRA only"):
        _trainer(tiny, tmp_path / "y", mode="full", offload="component")
