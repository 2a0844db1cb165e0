"""Training under a mesh in one gloo world of two CPU processes (fp32):
the gradients of every attention collective against `jax.grad` through the
JAX package's versions under `shard_map` (5e-5, as
tests/test_ring_attention.py), the block stack's gradients at cp 2 against
JAX's single-device `jax.grad` of `forward_dual_tower` (2e-4, as
tests/test_sp_equivalence.py), two `LoRATrainer` steps at cp 2 against the
port's one process and against JAX's `LoRATrainer(mesh=create_mesh(1, 1,
2))` (2e-5 / 2e-6, as tests/test_multiprocess.py), and two steps at data 2
(a batch of two) against one process. Every case runs in one world
(`test_torch_sp_mesh.run_world`); the draws are pinned (JAX's, where the
JAX trainer runs beside)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion import training as jtr
from dualforce_tpu.diffusion.flow_match import FlowMatchPairScheduler as JaxScheduler
from dualforce_tpu.engine.trainer import LoRATrainer as JaxTrainer
from dualforce_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from dualforce_tpu.models.dual_tower import forward_dual_tower as jax_forward_dual_tower
from dualforce_tpu.parallel import ring_attention as jra
from dualforce_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dualforce_tpu.parallel.sharding import replicated, shard_params

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.engine import lora as tlora
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_sp_mesh import block_grad_names, jax_blocks_setup, run_world, train_steps
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from test_torch_training import _batch, _jax_params, _tables

CP = 2
ATTN_TOL = dict(rtol=5e-5, atol=5e-5)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
# 16 tokens in chunks of 8: valid 6 leaves rank 1's chunk all padding
VALID = [("whole", None), ("padded", 13), ("rank1_padding", 6)]
ATTN = ([(fn, inner) for fn in ("ring", "lse") for inner in ("ref", "pallas")]
        + [("gather", "ref"), ("gather", "pallas"), ("ulysses", "ref"), ("ulysses", "pallas")])
# (name, setup, remat) of the block-stack cases: grid (3, 2, 2) and 7 audio
# tokens, so the audio is padded at cp 2
BLOCKS = [("cross", dict(cross=True), False), ("cross_remat", dict(cross=True), True),
          ("pooled_adaln_remat", dict(cross=True, pooled=True), True)]
TRAIN_CFG = dict(visual_layers=1, audio_layers=1)
TRAIN_KW = dict(lora_rank=2, lr=1e-3, warmup_steps=1, remat=True, attn_impl="ref",
                compute_dtype=torch.float32, logger="none", max_grad_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _qkvw(seed, s=16, n=4, d=16, sq=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, sq if (sq and i in (0, 3)) else s, n, d)).astype(np.float32)
            for i in range(4)]


def _jax_attn_grads(fn, inner, valid, q, k, v, w):
    """jax.grad of sum(f(q, k, v) * w) through JAX's shard_map version."""
    mesh = jax_create_mesh(1, 1, CP)
    seq = P(None, "cp")
    if fn == "ring":
        f = functools.partial(jra.ring_attention, axis_name="cp", inner=jra._inner_with_lse,
                              global_valid_len=valid)
        specs, out = (seq, seq, seq), seq
    elif fn == "lse":
        f = functools.partial(jra.lse_combine_cross_attention, axis_name="cp",
                              inner=jra._inner_with_lse, global_valid_len=valid)
        specs, out = (P(), seq, seq), P()
    elif fn == "gather":
        f = functools.partial(jra.gather_kv_attention, axis_name="cp", global_valid_len=valid,
                              impl="ref")
        specs, out = (seq, seq, seq), seq
    else:
        # JAX's all_to_all has no transpose for a device-varying cotangent
        # here: Ulysses is exact attention, whose single-device grads stand in
        return [np.asarray(g) for g in jax.grad(
            lambda a, b, c: jnp.sum(jra._inner_with_lse(a, b, c)[0] * w), argnums=(0, 1, 2))(
                q, k, v)]
    sm = jax.shard_map(f, mesh=mesh, in_specs=specs, out_specs=out)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(sm(a, b, c) * w), argnums=(0, 1, 2)))(
        q, k, v)
    return [np.asarray(g) for g in grads]


def _jax_block_grads(st):
    """JAX's single-device jax.grad of sum(ov^2) + sum(oa^2) through
    `forward_dual_tower`, as the port's {module.name: grad} (and vx, ax)."""
    p, c = st["jparams"], st["jcfg"]

    def loss(bp, vb, ab, vx, ax):
        ov, oa = jax_forward_dual_tower(vb, ab, bp, c.video_dit, c.audio_dit, c.bridge, vx, ax,
                                        *st["jargs"][2:], **st["jkw"])
        return jnp.sum(ov ** 2) + jnp.sum(oa ** 2)

    gb, gv, ga, gvx, gax = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        p["bridge"], p["video_dit"]["blocks"], p["audio_dit"]["blocks"], *st["jargs"][:2])
    tree = {"bridge": gb, "video_dit": dict(p["video_dit"], blocks=gv),
            "audio_dit": dict(p["audio_dit"], blocks=ga)}
    sds = from_jax.state_dicts(jax.tree.map(np.asarray, tree), st["cfg"])
    out = {f"{m}.{n}": sds[m][n if m == "bridge" else f"blocks.{n}"]
           for m, n in block_grad_names(st["modules"])}
    out["vx"], out["ax"] = np.asarray(gvx), np.asarray(gax)
    return out


def _one_process_steps(c):
    """The port's one-process trainer on a case's modules, LoRA and draws."""
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

    trainer = LoRATrainer(c["cfg"], copy.deepcopy(c["modules"]), TrainerConfig(**c["tcfg"]),
                          device="cpu")
    with torch.no_grad():
        for m, tree in trainer.lora.items():
            for n, ab in tree.items():
                for part, t in ab.items():
                    t.copy_(c["lora"][m][n][part])
    return train_steps(trainer, c["steps"], c.get("encoded"), c.get("batches"))


def _jax_trainer_steps(jcfg, jparams, lora, encoded, keys, tmp):
    """JAX's `LoRATrainer(mesh=create_mesh(1, 1, 2))` from the port's LoRA,
    its step function on `encoded` with each key (expert 0)."""
    tcfg = JaxTrainerConfig(save_dir=str(tmp), lora_rank=2, lr=1e-3, warmup_steps=1,
                            remat=True, attn_impl="ref", compute_dtype=jnp.float32,
                            logger="none", max_grad_norm=1.0)
    mesh = jax_create_mesh(1, 1, CP)
    # every input on the mesh, as `scripts/train.py` places them: the step
    # then compiles once
    trainer = JaxTrainer(jcfg, shard_params(jparams, mesh), tcfg, mesh=mesh)
    trainer.lora = shard_params(tlora.to_stacked(lora), mesh)
    trainer.opt_state = jax.device_put(trainer.optimizer.init(trainer.lora), replicated(mesh))
    enc = {k: jax.device_put(v.numpy(), replicated(mesh)) for k, v in encoded.items()}
    out = []
    for key in keys:
        trainer.lora, trainer.opt_state, m = trainer._step_fn(
            trainer.lora, trainer.opt_state, trainer.params, enc, key, 0,
            trainer._rope_pack(enc))
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "lora": tlora.from_stacked(jax.tree.map(np.asarray, trainer.lora),
                                               jcfg.bridge.interaction_layers())})
    return out


def _draws(jcfg, enc, key, expert=0):
    """The timestep id and the noise JAX's `training_loss` draws from `key`."""
    k_t, k_vn, k_an = jax.random.split(key, 3)
    tid = int(jtr.sample_timestep_id(k_t, _tables(jcfg, JaxScheduler), expert))
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, enc[name].shape,
                                                              jnp.float32)))
                  for k, name in ((k_vn, "video_latents"), (k_an, "audio_latents")))
    return expert, tid, noise


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train2")
    cases, want = [], {}
    for fn, inner in ATTN:
        for name, valid in VALID if fn != "ulysses" else VALID[:1]:
            q, k, v, w = _qkvw(0, sq=5 if fn == "lse" else None)
            key = f"{fn}_{inner}_{name}"
            cases.append(dict(name=key, kind="attn_grads", mesh=(1, 1, CP), fn=fn, inner=inner,
                              valid=valid, **{n: torch.from_numpy(x) for n, x in
                                              zip("qkvw", (q, k, v, w))}))
            if inner == "ref":
                want[key] = _jax_attn_grads(fn, inner, valid, q, k, v, w)
    for name, setup, remat in BLOCKS:
        st = jax_blocks_setup(grid=(3, 2, 2), la=7, **setup)
        cases.append(dict(name=f"blocks_{name}", kind="block_grads", mesh=(1, 1, CP),
                          modules=st["modules"], inputs=st["targs"],
                          kwargs=dict(st["tkw"], remat=remat)))
        if not remat or name != "cross_remat":       # remat changes no JAX number
            want[f"blocks_{name}"] = _jax_block_grads(st)
    want["blocks_cross_remat"] = want["blocks_cross"]

    # the trainer: one video tower (expert 0), fp32, pinned draws
    cfg, jcfg = tiny_test_config(**TRAIN_CFG), jax_tiny_config(**TRAIN_CFG)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                two_video_towers=False)
    from dualforce_tpu_torch.diffusion.training import encode_batch

    encoded = encode_batch(mods, cfg, _batch(), compute_dtype=torch.float32, device="cpu")
    towers = {m: mods[m] for m in ("video_dit", "audio_dit", "bridge")}
    lora = tlora.init_pipeline_lora(towers, 2, torch.Generator().manual_seed(3))
    with torch.no_grad():              # nonzero b, so both factors move
        for tree in lora.values():
            for ab in tree.values():
                ab["b"].normal_(0.0, 0.01, generator=torch.Generator().manual_seed(4))
    keys = [jax.random.PRNGKey(40 + i) for i in range(2)]
    enc_np = {k: v.numpy() for k, v in encoded.items()}
    steps = [_draws(jcfg, enc_np, key) for key in keys]
    cp_case = dict(name="trainer_cp2", kind="trainer", mesh=(1, 1, CP), cfg=cfg,
                   modules=towers, lora=lora, encoded=encoded, steps=steps,
                   tcfg=dict(TRAIN_KW, save_dir=str(tmp / "unused")))
    cases.append(cp_case)
    want["trainer_cp2"] = _one_process_steps(cp_case)
    jparams = _jax_params(towers, jcfg)
    want["trainer_cp2_jax"] = _jax_trainer_steps(jcfg, jparams, lora, encoded, keys,
                                                 tmp / "jax")

    # data 2: a batch of two, encoded by the trainer (each rank its item)
    batches = [_batch(b=2, seed=10 + i) for i in range(2)]
    rng = np.random.default_rng(5)
    enc2 = encode_batch(mods, cfg, batches[0], compute_dtype=torch.float32, device="cpu")
    dsteps = [(0, int(tid), tuple(torch.from_numpy(rng.standard_normal(enc2[n].shape)
                                                   .astype(np.float32))
                                  for n in ("video_latents", "audio_latents")))
              for tid in (100, 700)]
    data_case = dict(name="trainer_data2", kind="trainer", mesh=(2, 1, 1), cfg=cfg,
                     modules=mods, lora=lora, batches=batches, steps=dsteps,
                     tcfg=dict(TRAIN_KW, save_dir=str(tmp / "unused")))
    cases.append(data_case)
    want["trainer_data2"] = _one_process_steps(data_case)
    cases.append(dict(name="transports", kind="transports", mesh=(1, 1, CP),
                      x=torch.from_numpy(np.random.default_rng(8).standard_normal(
                          (2, 8, 6)).astype(np.float32))))
    ranks = run_world(2, cases, tmp)
    return dict(ranks=ranks, want=want)


def _whole(world, key, part):
    return torch.cat([world["ranks"][r][key][part] for r in range(CP)], dim=1).numpy()


@pytest.mark.parametrize("valid", [v[0] for v in VALID])
@pytest.mark.parametrize("fn,inner", [a for a in ATTN if a[0] != "ulysses"])
def test_attention_grads_match_jax(world, fn, inner, valid):
    """The gradients of q, k and v: the port's plain inner and B1's plain
    version against JAX's plain inner; rank1_padding runs the backward to
    its end on both ranks (no hang: the world returned)."""
    want = world["want"][f"{fn}_ref_{valid}"]
    key = f"{fn}_{inner}_{valid}"
    for i, part in enumerate("qkv"):
        if fn == "lse" and part == "q":
            for r in range(CP):
                np.testing.assert_allclose(world["ranks"][r][key]["q"].numpy(), want[0],
                                           err_msg=f"{key} dq rank {r}", **ATTN_TOL)
        else:
            np.testing.assert_allclose(_whole(world, key, part), want[i],
                                       err_msg=f"{key} d{part}", **ATTN_TOL)


@pytest.mark.parametrize("inner", ["ref", "pallas"])
def test_ulysses_grads_match_jax(world, inner):
    want = world["want"]["ulysses_ref_whole"]
    for i, part in enumerate("qkv"):
        np.testing.assert_allclose(_whole(world, f"ulysses_{inner}_whole", part), want[i],
                                   err_msg=f"d{part}", **ATTN_TOL)


@pytest.mark.parametrize("name", [b[0] for b in BLOCKS])
def test_block_stack_grads_match_jax(world, name):
    """Every block and bridge parameter's gradient and both inputs', summed
    over the ranks, on every rank, against JAX's single device."""
    want = world["want"][f"blocks_{name}"]
    for r in range(CP):
        got = world["ranks"][r][f"blocks_{name}"]
        assert set(got) - {"_dims"} == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=f"{k} rank {r}", **BLOCK_TOL)


def _assert_steps(got, want, tol, lora_key="params"):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], err_msg=f"step {i + 1} loss", **tol)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   err_msg=f"step {i + 1} grad norm", **tol)
        wl = w[lora_key]
        if lora_key == "lora":
            wl = {f"{m}.{n}.{p}": t for m in wl for n in wl[m] for p, t in wl[m][n].items()}
        assert set(g["params"]) == set(wl)
        for k, t in wl.items():
            np.testing.assert_allclose(g["params"][k].numpy(), t.detach().numpy(),
                                       err_msg=f"step {i + 1} {k}", **tol)


def test_trainer_cp2_matches_one_process_and_jax_mesh_trainer(world):
    """Two steps (lr 0, then 1e-3): losses, global grad norms and every LoRA
    factor after each step, on both ranks, against the port's one process
    and JAX's trainer on a cp 2 mesh."""
    for r in range(CP):
        got = world["ranks"][r]["trainer_cp2"]["steps"]
        _assert_steps(got, world["want"]["trainer_cp2"], STEP_TOL)
        _assert_steps(got, world["want"]["trainer_cp2_jax"], STEP_TOL, lora_key="lora")
    moved = world["ranks"][0]["trainer_cp2"]["steps"][1]["params"]
    first = world["ranks"][0]["trainer_cp2"]["steps"][0]["params"]
    assert all(not torch.equal(moved[k], first[k]) for k in moved)


def test_trainer_data2_matches_one_process(world):
    """A batch of two split over data 2 (each rank encodes its item, the
    encodes gathered back): two steps against one process."""
    for r in range(2):
        _assert_steps(world["ranks"][r]["trainer_data2"]["steps"],
                      world["want"]["trainer_data2"], STEP_TOL)


def test_shared_memory_transport_matches_gloo(world):
    """A one-host world moves the helpers' bytes through shared memory; a
    world across hosts through gloo's collectives: the same results (the
    sums, taken in rank order in both, bit for bit at two ranks)."""
    for r in range(CP):
        got = world["ranks"][r]["transports"]
        for name, shared in got["shared"].items():
            gloo = got["gloo"][name]
            for a, b in zip(shared if isinstance(shared, list) else [shared],
                            gloo if isinstance(gloo, list) else [gloo]):
                assert a.dtype == b.dtype and torch.equal(a, b), (name, r)
