"""The low-resource training regime on the CPU: the trainer's component
offload (`LoRATrainer(offload="component")`), its expert schedule against
the JAX package's, and LoRA training over fp8-stored weights against JAX.

Weights are the port's random modules, read into JAX trees by the JAX
package's converters (`test_torch_training._jax_params`); fp8 storage is
`nn.cast_modules_fp8` on the port's side and `cast_tree_fp8` on JAX's (the
two give the same bytes, `tests/test_torch_fp8.py`). Tolerances: the
component trainer bit-equal to the resident one (staging copies the
weights exactly); LoRA gradients 1e-3 relative (atol 1e-6) against JAX in
fp32, as `tests/test_torch_training_loss.py` holds them.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import nn as jnn
from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion import training as jtr
from dualforce_tpu.diffusion.flow_match import FlowMatchPairScheduler as JaxScheduler
from dualforce_tpu.engine.trainer import LoRATrainer as JaxTrainer
from dualforce_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from test_torch_training import (CFG_KW, GRAD_TOL, _batch, _jax_lora, _jax_params, _noise,
                                 _np, _t, _tables)
from test_torch_training_loss import _encoded, _grads_by_name

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch import offload
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion import training as ttr
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.engine import lora as tlora
from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

TOWERS = ("video_dit", "video_dit_2", "audio_dit", "bridge")
FP8_MODULES = TOWERS + ("text_encoder",)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config(**CFG_KW)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    fp8 = {n: (tnn.cast_modules_fp8(copy.deepcopy(m)) if n in FP8_MODULES else m)
           for n, m in mods.items()}
    return dict(cfg=cfg, jcfg=jax_tiny_config(**CFG_KW), mods=mods, fp8=fp8,
                jparams=_jax_params(mods, jax_tiny_config(**CFG_KW)))


def _tcfg(save_dir, **kw):
    return TrainerConfig(**{**dict(max_steps=3, warmup_steps=1, save_interval=100,
                                   log_interval=1, save_dir=str(save_dir), logger="none",
                                   lora_rank=2, compute_dtype=torch.float32,
                                   attn_impl="ref", remat=False, lr=1e-3,
                                   optimizer="AdamW8bit"), **kw})


def _host(modules):
    return {n: offload.to_host(copy.deepcopy(m), "cpu") for n, m in modules.items()}


@pytest.mark.parametrize("storage", ["fp32", "fp8"])
def test_component_trainer_bit_equal_to_resident(tiny, tmp_path, storage):
    """Three AdamW8bit steps (experts 0, 1, 0 in both regimes) from host
    copies staged per phase give the resident trainer's LoRA and moments bit
    for bit; the records carry the staging seconds."""
    mods = tiny["mods"] if storage == "fp32" else tiny["fp8"]
    runs = {}
    for mode, modules in (("none", mods), ("component", _host(mods))):
        trainer = LoRATrainer(tiny["cfg"], modules, _tcfg(tmp_path / mode, offload=mode),
                              device="cpu")
        records = []
        assert trainer.train(iter([_batch()] * 3), on_micro_step=records.append) == 3
        assert not trainer._staged          # every staged copy freed at the end
        runs[mode] = (trainer, records)
    (res, res_rec), (off, off_rec) = runs["none"], runs["component"]
    assert [r["expert"] for r in res_rec] == [r["expert"] for r in off_rec] == [0, 1, 0]
    assert all(r["stage_s"] == 0.0 for r in res_rec)
    assert all(r["stage_s"] > 0.0 for r in off_rec)
    for a, b in zip(tlora.lora_parameters(res.lora), tlora.lora_parameters(off.lora)):
        assert torch.equal(a, b)
    for (qa, sa), (qb, sb) in zip(res.optimizer.mu + res.optimizer.nu,
                                  off.optimizer.mu + off.optimizer.nu):
        assert torch.equal(qa, qb) and torch.equal(sa, sb)
    assert all(ab["b"].any() for m in TOWERS for ab in off.lora[m].values())


def test_component_trainer_refuses_resident_modules(tiny, tmp_path):
    with pytest.raises(ValueError, match="offload 'component' wants it on cpu"):
        LoRATrainer(tiny["cfg"], {"video_dit": torch.nn.Linear(2, 2, device="meta")},
                    _tcfg(tmp_path, offload="component"), device="cpu")


def _staging_spy(monkeypatch, names):
    """Record the order in which `offload.staged` puts modules on the
    device and frees them: [(kind, name)]."""
    real, events = offload.staged, []

    @contextlib.contextmanager
    def spy(module, device):
        with real(module, device) as c:
            events.append(("in", names[id(module)]))
            try:
                yield c
            finally:
                events.append(("out", names[id(module)]))

    monkeypatch.setattr(offload, "staged", spy)
    return events


def test_expert_schedule_matches_jax(tiny, tmp_path, monkeypatch):
    """expert_switch_interval=2 with grad_accum_steps=2: the experts staged
    for each micro-step (a `_stage` spy, as the JAX package's own test
    reads it) equal JAX's; the two experts are never on the device together,
    each is staged once per switch, the encoders once per encode. JAX's
    trainer runs its own loop and staging; its encode, gradient and update
    programs are stubbed out, since only the schedule is compared."""
    kw = dict(max_steps=3, save_interval=100, warmup_steps=1, logger="none", lora_rank=2,
              remat=False, offload="component", expert_switch_interval=2,
              grad_accum_steps=2)
    jtrainer = JaxTrainer(tiny["jcfg"], tiny["jparams"],
                          JaxTrainerConfig(save_dir=str(tmp_path / "jax"),
                                           compute_dtype=jnp.float32, **kw))
    enc = _encoded(tiny["cfg"], (2, 4, 4), 13, 24, 0)
    jtrainer._encode = lambda batch: enc
    jtrainer._grad_fn = lambda lora, *a: (lora, {})
    jtrainer._accum_fn = lambda acc, grads: acc
    jtrainer._apply_fn = lambda lora, opt_state, grads: (lora, opt_state, 0.0)
    jtrainer.save = lambda: None
    trainer = LoRATrainer(tiny["cfg"], _host(tiny["mods"]),
                          TrainerConfig(save_dir=str(tmp_path / "port"),
                                        compute_dtype=torch.float32, attn_impl="ref", **kw),
                          device="cpu")
    seen = {"jax": [], "port": []}
    for side, t in (("jax", jtrainer), ("port", trainer)):
        orig = t._stage

        def spy(*names, _orig=orig, _seen=seen[side]):
            if "video_dit" in names or "video_dit_2" in names:
                _seen.append([n for n in names if n.startswith("video")][0])
            return _orig(*names)

        t._stage = spy
    batches = [_batch()] * 6
    jtrainer.train(iter(batches))
    events = _staging_spy(monkeypatch, {id(m): n for n, m in trainer.modules.items()})
    records = []
    trainer.train(iter(batches), on_micro_step=records.append)
    want = ["video_dit"] * 4 + ["video_dit_2"] * 2
    assert seen["jax"] == seen["port"] == want
    assert [r["expert"] for r in records] == [0, 0, 0, 0, 1, 1]
    live = set()
    for kind, name in events:
        (live.add if kind == "in" else live.discard)(name)
        assert not {"video_dit", "video_dit_2"} <= live
    staged = [n for kind, n in events if kind == "in"]
    assert staged.count("video_dit") == staged.count("video_dit_2") == 1
    assert staged.count("audio_dit") == staged.count("bridge") == 1
    assert staged.count("text_encoder") == staged.count("video_vae") == 6
    assert not live                         # everything freed when training ends


def _jax_grads(jl, params, jcfg, enc, expert, noise, compute_dtype):
    jtables = _tables(jcfg, JaxScheduler)
    rng = jax.random.PRNGKey(11 + expert)
    tid = int(jtr.sample_timestep_id(jax.random.split(rng, 3)[0], jtables, expert))
    fn = jax.jit(lambda lora, p, e, key, nz: jax.value_and_grad(
        jtr.training_loss, has_aux=True)(lora, p, jcfg, jtables, e, key, expert,
                                         compute_dtype=compute_dtype, noise_override=nz,
                                         remat=False, attn_impl="ref"))
    (loss, _), grads = fn(jl, params, enc, rng, noise)
    return tid, float(loss), _np(grads)


def _fp8_tree(jparams, upcast=None):
    """`cast_tree_fp8` of the towers, as the JAX loader stores them; with
    `upcast`, every leaf then cast to that dtype (the tree upcast first)."""
    out = {}
    for name, tree in jparams.items():
        if name in TOWERS:
            tree = jnn.cast_tree_fp8(tree, jnp.float8_e4m3fn)
            if upcast is not None:
                tree = jax.tree.map(lambda x: x.astype(upcast), tree)
        out[name] = tree
    return out


@pytest.mark.parametrize("expert", [0, 1])
def test_fp8_lora_grads_match_jax_on_the_upcast_tree(tiny, expert):
    """LoRA gradients over fp8-stored towers (merged into fp32, the compute
    dtype) against JAX's `training_loss` on the same fp8 tree upcast to
    fp32 first."""
    cfg, jcfg = tiny["cfg"], tiny["jcfg"]
    enc = _encoded(cfg, (2, 4, 4), 13, 24, 3 + expert)
    jl = _jax_lora(tiny["jparams"])
    noise = _noise(enc, 5 + expert)
    tid, jloss, jgrads = _jax_grads(jl, _fp8_tree(tiny["jparams"], jnp.float32), jcfg, enc,
                                    expert, noise, jnp.float32)
    port_lora = from_jax.lora(_np(jl), cfg)
    tables = _tables(cfg, FlowMatchPairScheduler)
    grads, metrics = ttr.lora_grads(port_lora, tiny["fp8"], cfg, tables,
                                    _t(enc), None, expert, compute_dtype=torch.float32,
                                    remat=True, attn_impl="ref", noise_override=noise,
                                    timestep_id=tid, device="cpu")
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-4)
    want = from_jax.lora(jgrads, cfg)
    for (m, n, p), g in _grads_by_name(port_lora, grads).items():
        np.testing.assert_allclose(g.numpy(), want[m][n][p].detach().numpy(),
                                   err_msg=f"{m} {n} {p}", **GRAD_TOL)


def test_caveat_9_fp8_recast_drops_b_gradients(tiny):
    """ROADMAP C, caveat 9. In bf16 compute, JAX's merge over the fp8 tree
    casts W + delta back to fp8, so the cotangent of the merged kernel is
    fp8 too: fewer b-gradient entries are nonzero than on the same tree
    upcast to bf16 first. The port merges into the compute dtype: its count
    is the upcast tree's."""
    cfg, jcfg = tiny["cfg"], tiny["jcfg"]
    enc = _encoded(cfg, (2, 4, 4), 13, 24, 21)
    jl = _jax_lora(tiny["jparams"])
    noise = _noise(enc, 22)

    def nonzero_b(grads):
        return sum(int(np.count_nonzero(ab["b"])) for tree in grads.values()
                   for ab in tree.values())

    counts = {}
    for key, params in (("fp8", _fp8_tree(tiny["jparams"])),
                        ("upcast", _fp8_tree(tiny["jparams"], jnp.bfloat16))):
        tid, _, grads = _jax_grads(jl, params, jcfg, enc, 0, noise, jnp.bfloat16)
        counts[key] = nonzero_b({m: grads[m] for m in ("video_dit", "audio_dit", "bridge")})
    port_lora = from_jax.lora(_np(jl), cfg)
    tables = _tables(cfg, FlowMatchPairScheduler)
    grads, _ = ttr.lora_grads(port_lora, tiny["fp8"], cfg, tables,
                              _t(enc), None, 0, compute_dtype=torch.bfloat16, remat=False,
                              attn_impl="ref", noise_override=noise, timestep_id=tid,
                              device="cpu")
    by_name = _grads_by_name(port_lora, grads)
    counts["port"] = sum(int(torch.count_nonzero(g)) for (m, _, p), g in by_name.items()
                         if p == "b" and m != "video_dit_2")
    print(f"nonzero LoRA b-gradient entries: {counts}")      # shown with pytest -s
    assert counts["fp8"] < counts["upcast"], counts
    assert counts["port"] == counts["upcast"], counts


@pytest.mark.parametrize("remat", [True, False])
def test_lora_targets_merge_where_their_layer_reads_them(tiny, monkeypatch, remat):
    """`training_loss` hands the towers `MergedWeights`: each target is
    merged when its layer reads it (once per forward, again in the remat
    recompute), never all at once before the forward."""
    reads = []

    class Spy(tlora.MergedWeights):
        def __getitem__(self, name):
            reads.append((id(self.module), name))
            return super().__getitem__(name)

    monkeypatch.setattr(tlora, "MergedWeights", Spy)
    cfg = tiny["cfg"]
    enc = _encoded(cfg, (2, 4, 4), 13, 24, 31)
    lora = tlora.init_pipeline_lora(tiny["mods"], 2, torch.Generator().manual_seed(0))
    ttr.lora_grads(lora, tiny["mods"], cfg, _tables(cfg, FlowMatchPairScheduler), _t(enc),
                   None, 0, compute_dtype=torch.float32, remat=remat, attn_impl="ref",
                   noise_override=_noise(enc, 32), timestep_id=10, device="cpu")
    video = id(tiny["mods"]["video_dit"])
    targets = {(id(tiny["mods"][m]), n) for m in ("video_dit", "audio_dit", "bridge")
               for n in lora[m]}
    assert set(reads) == targets
    assert all(reads.count(t) == (2 if remat else 1) for t in targets)
    # the first layer's targets are read before the last layer's
    assert reads.index((video, "blocks.0.self_attn.q.weight")) < reads.index(
        (video, f"blocks.{cfg.video_dit.num_layers - 1}.self_attn.q.weight"))


def test_component_trainer_on_cuda_needs_a_card(tiny, tmp_path):
    """The trainer's default device is the card; without one it raises
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LoRATrainer(tiny["cfg"], _host(tiny["mods"]), _tcfg(tmp_path, offload="component"))
