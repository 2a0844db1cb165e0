"""The port's full fine-tuning against the JAX package's, on the CPU in fp32.

Both sides start from the port's random towers (read into JAX trees by the
JAX package's converters) and take the same encoded batch (random latents
from numpy), the timestep id and noise JAX draws from its key (pinned on
the port's side), and AdamW at a constant lr. Tolerances: 1e-4 relative on
losses; 2e-5 absolute on parameters after the steps, whose updates are
~1e-3 (lr) and agree to ~1e-3 of themselves through the grads' fp32
round-off over a few layers. The expert a step does not run is held
bit-equal, its moments too.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.convert.load_checkpoint import load_pipeline_params as jax_load_pipeline
from dualforce_tpu.diffusion import training as jtr
from dualforce_tpu.diffusion.flow_match import FlowMatchPairScheduler as JaxScheduler
from dualforce_tpu.engine import optim as joptim
from test_torch_training import _batch, _jax_params, _np, _t, _tables
from test_torch_training_loss import _encoded, _jax_config

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.diffusion import training as ttr
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.engine.optim import AdamW
from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
from dualforce_tpu_torch.models.factory import init_pipeline_params

LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=0, atol=2e-5)
TOWERS = ("video_dit", "video_dit_2", "audio_dit", "bridge")
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def towers():
    cfg = tiny_test_config(visual_layers=1, audio_layers=1)
    jcfg = _jax_config(cfg)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                with_vaes=False, with_text=False)
    return cfg, jcfg, mods, _jax_params(mods, jcfg)


def _draws(jcfg, enc, key, expert):
    """The timestep id and the noise JAX's `training_loss` draws from `key`."""
    k_t, k_vn, k_an = jax.random.split(key, 3)
    tid = int(jtr.sample_timestep_id(k_t, _tables(jcfg, JaxScheduler), expert))
    noise = tuple(np.asarray(jax.random.normal(k, enc[name].shape, jnp.float32))
                  for k, name in ((k_vn, "video_latents"), (k_an, "audio_latents")))
    return tid, noise


def _jax_sd(tree, cfg):
    """JAX module trees as the port's state dicts ({module: {name: numpy}})."""
    return from_jax.state_dicts(_np(tree), cfg)


def _sd(modules):
    return {m: {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
            for m, module in modules.items()}


def _assert_close(got, want, tol, what):
    assert {m: sorted(x) for m, x in got.items()} == {m: sorted(x) for m, x in want.items()}
    for m in want:
        for k, w in want[m].items():
            np.testing.assert_allclose(got[m][k], w, err_msg=f"{what} {m}.{k}", **tol)


def test_full_ft_steps_match_make_full_ft_step(towers):
    """Two steps with both experts trainable (expert 0, then 1) against
    `make_full_ft_step`: the losses, every parameter after each step, and
    the expert each step does not run bit-equal across that step in both
    packages, its AdamW moments too."""
    cfg, jcfg, mods, jparams = towers
    trainable = {m: copy.deepcopy(mods[m]).requires_grad_(True)
                 for m in ("video_dit", "video_dit_2")}
    frozen = {m: mods[m] for m in ("audio_dit", "bridge")}
    opt = AdamW(ttr.trainable_parameters(trainable), lr=LR, weight_decay=0.1,
                max_grad_norm=1.0)
    tx = joptim.adamw(lr=LR, weight_decay=0.1, max_grad_norm=1.0)
    jtrain = {m: jparams[m] for m in trainable}
    jfrozen = {m: jparams[m] for m in frozen}
    opt_state = tx.init(jtrain)
    jstep = jtr.make_full_ft_step(jcfg, _tables(jcfg, JaxScheduler), tx,
                                  compute_dtype=jnp.float32, remat=False, attn_impl="ref")
    tables = _tables(cfg, FlowMatchPairScheduler)
    for step, expert in enumerate((0, 1)):
        enc = _encoded(cfg, (2, 8, 8), 21, 24, 30 + step)
        key = jax.random.PRNGKey(40 + step)
        held = "video_dit_2" if expert == 0 else "video_dit"
        jheld = _jax_sd({held: jtrain[held]}, cfg)
        before = {k: v.clone() for k, v in trainable[held].state_dict().items()}
        moments = [{k: v.clone() for k, v in opt.opt.state[p].items()}
                   for p in trainable[held].parameters()] if step else None
        jtrain, opt_state, jm = jstep(jtrain, opt_state, jfrozen, enc, key, expert)
        tid, noise = _draws(jcfg, enc, key, expert)
        m = ttr.full_ft_step(trainable, opt, frozen, cfg, tables, _t(enc), None, expert,
                             compute_dtype=torch.float32, remat=False, attn_impl="ref",
                             noise_override=noise, timestep_id=tid, device="cpu")
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        _assert_close(_sd(trainable), _jax_sd(jtrain, cfg), PARAM_TOL, f"step {step + 1}")
        for k, v in trainable[held].state_dict().items():
            assert torch.equal(v, before[k]), f"{held}.{k} moved in step {step + 1}"
        _assert_close(_jax_sd({held: jtrain[held]}, cfg), jheld, dict(rtol=0, atol=0),
                      "JAX held")
        if moments:
            for p, st in zip(trainable[held].parameters(), moments):
                assert torch.equal(opt.opt.state[p]["exp_avg"], st["exp_avg"])
                assert torch.equal(opt.opt.state[p]["exp_avg_sq"], st["exp_avg_sq"])
        assert all(float(opt.opt.state[p]["step"]) == step + 1
                   for m_ in trainable.values() for p in m_.parameters())
    assert opt.count == 2


def test_full_ft_accumulation_trains_both_experts(towers):
    """Two micro-batches (experts 0 and 1) accumulated into one step, as
    `make_full_ft_accum_fns` runs them: both experts move, nothing is held,
    and the parameters match JAX's."""
    cfg, jcfg, mods, jparams = towers
    trainable = {m: copy.deepcopy(mods[m]).requires_grad_(True)
                 for m in ("video_dit", "video_dit_2")}
    frozen = {m: mods[m] for m in ("audio_dit", "bridge")}
    opt = AdamW(ttr.trainable_parameters(trainable), lr=LR, weight_decay=0.1)
    tx = joptim.adamw(lr=LR, weight_decay=0.1)
    jtrain = {m: jparams[m] for m in trainable}
    jfrozen = {m: jparams[m] for m in frozen}
    opt_state = tx.init(jtrain)
    grad_fn, accum_fn, apply_fn = jtr.make_full_ft_accum_fns(
        jcfg, _tables(jcfg, JaxScheduler), tx, 2, compute_dtype=jnp.float32, remat=False,
        attn_impl="ref")
    tables = _tables(cfg, FlowMatchPairScheduler)
    before = _sd(trainable)
    acc = jacc = None
    for expert in (0, 1):
        enc = _encoded(cfg, (2, 8, 8), 21, 24, 50 + expert)
        key = jax.random.PRNGKey(60 + expert)
        jgrads, _ = grad_fn(jtrain, jfrozen, enc, key, expert)
        jacc = accum_fn(jax.tree.map(np.zeros_like, jgrads) if jacc is None else jacc, jgrads)
        tid, noise = _draws(jcfg, enc, key, expert)
        grads, _ = ttr.full_ft_grads(trainable, frozen, cfg, tables, _t(enc), None, expert,
                                     compute_dtype=torch.float32, remat=False,
                                     attn_impl="ref", noise_override=noise, timestep_id=tid,
                                     device="cpu")
        acc = ttr.accumulate(acc, grads, 2)
    jtrain, opt_state, jnorm = apply_fn(jtrain, opt_state, jacc)
    norm = opt.step(acc)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-3)
    after = _sd(trainable)
    _assert_close(after, _jax_sd(jtrain, cfg), PARAM_TOL, "accumulated step")
    for m in ("video_dit", "video_dit_2"):
        assert max(np.abs(after[m][k] - before[m][k]).max() for k in before[m]) > 0, m


def _trainer(modules, cfg, save_dir, **kw):
    tcfg = TrainerConfig(**{**dict(mode="full", trainable_modules=("audio_dit", "bridge"),
                                   max_steps=2, warmup_steps=1, save_interval=100,
                                   log_interval=1, save_dir=str(save_dir), logger="none",
                                   compute_dtype=torch.float32, attn_impl="ref",
                                   remat=False, lr=1e-2), **kw})
    return LoRATrainer(cfg, modules, tcfg, device="cpu")


@pytest.fixture(scope="module")
def pipeline():
    cfg = tiny_test_config()
    return cfg, init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)


def test_trainer_full_ft_saves_resumes_and_exports(pipeline, tmp_path):
    """`mode="full"` on audio_dit and the bridge: the two train, the rest
    stay as they were; `step-2/` holds their HF-layout export; a trainer on
    fresh copies resumes to the same weights, optimizer state and
    generator; the export, laid over a checkpoint of the base, loads through
    the JAX package's `load_pipeline_params` and the port's to the trained
    values."""
    cfg, base = pipeline
    mods = {k: copy.deepcopy(v) for k, v in base.items()}
    trainer = _trainer(mods, cfg, tmp_path / "ft")
    assert trainer.train(iter([_batch()] * 3)) == 2
    step_dir = tmp_path / "ft" / "step-2"
    assert sorted(os.listdir(step_dir)) == ["audio_dit", "dual_tower_bridge", "meta.json",
                                            "state.pt"]
    for name in ("audio_dit", "bridge"):
        assert any(not torch.equal(p, q) for p, q in zip(mods[name].parameters(),
                                                           base[name].parameters())), name
    for name in ("video_dit", "video_dit_2", "text_encoder", "video_vae", "audio_vae"):
        assert all(torch.equal(p, q) for p, q in zip(mods[name].parameters(),
                                                      base[name].parameters())), name
        assert not any(p.requires_grad for p in mods[name].parameters()), name

    fresh = {k: copy.deepcopy(v) for k, v in base.items()}
    resumed = _trainer(fresh, cfg, tmp_path / "ft")
    assert resumed.global_step == 2 and resumed.optimizer.count == 2
    for name in ("audio_dit", "bridge"):
        for p, q in zip(fresh[name].parameters(), mods[name].parameters()):
            assert torch.equal(p, q)
    for p, q in zip(ttr.trainable_parameters(resumed.trainable),
                    ttr.trainable_parameters(trainer.trainable)):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed.optimizer.opt.state[p][key],
                               trainer.optimizer.opt.state[q][key])
    assert torch.equal(resumed.generator.get_state(), trainer.generator.get_state())

    ckpt = tmp_path / "ckpt"
    lc.save_pipeline_params(base, cfg, str(ckpt))
    for sub in ("audio_dit", "dual_tower_bridge"):
        shutil.rmtree(ckpt / sub)
        shutil.copytree(step_dir / sub, ckpt / sub)
    port = lc.load_pipeline_params(str(ckpt), cfg, dtype=torch.float32, device="cpu")
    jax_loaded = jax_load_pipeline(str(ckpt), _jax_config(cfg), dtype=jnp.float32,
                                   to_device=False)
    for name in TOWERS:
        for (k, p), q in zip(port[name].named_parameters(), mods[name].parameters()):
            assert torch.equal(p, q), f"{name}.{k}"
    _assert_close(_jax_sd({m: jax_loaded[m] for m in TOWERS}, cfg),
                  _sd({m: mods[m] for m in TOWERS}), dict(rtol=0, atol=0), "JAX load")


def test_full_ft_refusals(pipeline, tmp_path):
    """Full fine-tuning under component offload is refused, as JAX refuses
    it; so are modules outside the towers and the bridge."""
    cfg, base = pipeline
    with pytest.raises(ValueError, match="trains LoRA only"):
        _trainer(base, cfg, tmp_path / "a", offload="component")
    with pytest.raises(ValueError, match="text_encoder"):
        _trainer(base, cfg, tmp_path / "b", trainable_modules=("text_encoder",))
    with pytest.raises(ValueError, match="not both"):
        ttr.training_loss({"video_dit": {}}, base, cfg, None, {}, None, 0,
                          full_finetune_params={"audio_dit": base["audio_dit"]},
                          device="cpu")
