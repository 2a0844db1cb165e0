"""Training under an fsdp 2 x cp 2 mesh in one gloo world of four CPU
processes (fp32): the block stack's gradients with fsdp-sharded blocks
against JAX's single-device `jax.grad` (2e-4, as
tests/test_sp_equivalence.py), two full fine-tuning steps of
`LoRATrainer(mesh=...)` against one process (1e-5) with AdamW and LAMB (its
update reads norms over the whole tensor) at fsdp 2 x cp 2 and with
AdamW8bit at fsdp 4, and the gathered `step-N/` export that
rank 0 writes. AdamW8bit's int8 codes and block scales are bit-equal to the
one process's: over fsdp alone the gradients are the one process's bit for
bit (a cp sum adds its parts in another order, and a code on a rounding
edge may flip), and its case runs unclipped, so that no norm summed over
the shards in another order scales them. Every case runs in one world
(`test_torch_sp_mesh.run_world`)."""

import copy

import numpy as np
import pytest
import torch

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.diffusion.training import encode_batch
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_sp_mesh import jax_blocks_setup, run_world, train_steps
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from test_torch_train_world2 import (BLOCK_TOL, _jax_block_grads,  # noqa: F401
                                     _jax_reference_unoptimised)
from test_torch_training import _batch

MESH = (1, 2, 2)
WORLD = 4
# optimizer: (mesh, the world ranks of one fsdp group, trainer settings)
FT_CASES = {"AdamW": ((1, 2, 2), [0, 2], {}),
            "AdamW8bit": ((1, 4, 1), [0, 1, 2, 3], {"max_grad_norm": 0.0}),
            # a family whose update reads the whole tensor (its trust ratio's norms)
            "LAMB": ((1, 2, 2), [0, 2], {"lr": 1e-2})}
FT_TOL = dict(rtol=1e-5, atol=1e-6)
FT_KW = dict(mode="full", lr=1e-3, warmup_steps=1, remat=True, attn_impl="ref",
             compute_dtype=torch.float32, logger="none", max_grad_norm=1.0,
             weight_decay=0.1)
OPTIMIZERS = tuple(FT_CASES)


def _fsdp_ranks(cp_index: int):
    """The world ranks of one fsdp group of MESH (rank = 2 f + c)."""
    return [2 * f + cp_index for f in range(2)]


def _gathered(ranks, dims, get, group):
    """{name: the whole tensor} from the fsdp shards of the ranks `group`."""
    out = {}
    for name, d in dims.items():
        parts = [get(ranks[r], name) for r in group]
        out[name] = parts[0] if d is None else torch.cat(parts, dim=d)
    return out


def _one_process(c):
    from dualforce_tpu_torch.engine.optim import AdamW8bit
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

    trainer = LoRATrainer(c["cfg"], copy.deepcopy(c["modules"]), TrainerConfig(**c["tcfg"]),
                          device="cpu")
    out = {"steps": train_steps(trainer, c["steps"], c["encoded"])}
    if isinstance(trainer.optimizer, AdamW8bit):
        out["codes"] = {name: {k: (q.reshape(-1)[:p.numel()].view(p.shape),
                                   s.expand(-1, 256).reshape(-1)[:p.numel()].view(p.shape))
                               for k, (q, s) in (("mu", trainer.optimizer.mu[i]),
                                                 ("nu", trainer.optimizer.nu[i]))}
                        for i, (name, p) in enumerate(out["steps"][-1]["params"].items())}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train4")
    st = jax_blocks_setup(grid=(3, 2, 2), la=7)
    cases = [dict(name="blocks", kind="block_grads", mesh=MESH, modules=st["modules"],
                  inputs=st["targs"], kwargs=dict(st["tkw"], remat=True))]
    want = {"blocks": _jax_block_grads(st)}
    cfg = tiny_test_config(visual_layers=2, audio_layers=1)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                two_video_towers=False)
    encoded = encode_batch(mods, cfg, _batch(), compute_dtype=torch.float32, device="cpu")
    towers = {m: mods[m] for m in ("video_dit", "audio_dit", "bridge")}
    rng = np.random.default_rng(11)
    steps = [(0, tid, tuple(torch.from_numpy(rng.standard_normal(encoded[n].shape)
                                             .astype(np.float32))
                            for n in ("video_latents", "audio_latents")))
             for tid in (300, 800)]
    for opt, (mesh, _, extra) in FT_CASES.items():
        c = dict(name=f"full_{opt}", kind="trainer", mesh=mesh, cfg=cfg, modules=towers,
                 encoded=encoded, steps=steps, save=opt == "AdamW",
                 tcfg=dict(FT_KW, optimizer=opt, save_dir=str(tmp / f"ft_{opt}"), **extra))
        cases.append(c)
        want[f"full_{opt}"] = _one_process(dict(c, tcfg=dict(c["tcfg"],
                                                               save_dir=str(tmp / "one"))))
    ranks = run_world(WORLD, cases, tmp)
    return dict(ranks=ranks, want=want, cfg=cfg, tmp=tmp)


def test_block_stack_grads_with_fsdp_shards_match_jax(world):
    """fsdp 2 x cp 2: each shard's gradient (gathered over fsdp) and the
    inputs', on every rank, against JAX's single-device gradients."""
    ranks, want = world["ranks"], world["want"]["blocks"]
    dims = ranks[0]["blocks"]["_dims"]
    assert sum(d is not None for d in dims.values()) > 50
    for c in range(2):
        for name, d in dims.items():
            parts = [ranks[r]["blocks"][name] for r in _fsdp_ranks(c)]
            got = parts[0] if d is None else torch.cat(parts, dim=d)
            np.testing.assert_allclose(got.numpy(), want[name], err_msg=name, **BLOCK_TOL)
    for r in range(WORLD):
        for k in ("vx", "ax"):
            np.testing.assert_allclose(ranks[r]["blocks"][k].numpy(), want[k], **BLOCK_TOL)


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_full_ft_under_fsdp_matches_one_process(world, opt):
    """Two steps: losses, global grad norms and every trained tensor after
    each step (the fsdp shards gathered) against one process; each rank
    holds its 1 / fsdp of each sharded block weight."""
    ranks, want = world["ranks"], world["want"][f"full_{opt}"]["steps"]
    dims = ranks[0][f"full_{opt}"]["dims"]
    group = FT_CASES[opt][1]
    assert sum(d is not None for d in dims.values()) > 20
    for i, w in enumerate(want):
        for r in range(WORLD):
            got = ranks[r][f"full_{opt}"]["steps"][i]
            np.testing.assert_allclose(got["loss"], w["loss"], err_msg=f"step {i + 1}",
                                       **FT_TOL)
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                       err_msg=f"step {i + 1}", **FT_TOL)
            for name, d in dims.items():
                if d is not None:
                    assert (got["params"][name].shape[d] * len(group)
                            == w["params"][name].shape[d])
        whole = _gathered(ranks, dims, lambda x, n: x[f"full_{opt}"]["steps"][i]["params"][n],
                          group)
        assert set(whole) == set(w["params"])
        for name, t in w["params"].items():
            np.testing.assert_allclose(whole[name].numpy(), t.numpy(),
                                       err_msg=f"step {i + 1} {name}", **FT_TOL)


def test_adamw8bit_codes_bit_equal_to_one_process(world):
    """AdamW8bit's moments over the fsdp shards: per element, the int8 code
    and the block scale the one process holds for the whole tensor."""
    ranks, want = world["ranks"], world["want"]["full_AdamW8bit"]["codes"]
    got = ranks[0]["full_AdamW8bit"]["codes"]
    dims = ranks[0]["full_AdamW8bit"]["dims"]
    gathered = [n for n in dims if dims[n] is not None and got[n]["whole"]]
    assert gathered and len(gathered) < sum(d is not None for d in dims.values())
    for name, d in dims.items():
        for k in ("mu", "nu"):
            for j in range(2):
                if d is None or got[name]["whole"]:
                    x = got[name][k][j]
                else:
                    x = torch.cat([ranks[r]["full_AdamW8bit"]["codes"][name][k][j]
                                   for r in FT_CASES["AdamW8bit"][1]], dim=d)
                assert torch.equal(x, want[name][k][j]), f"{name} {k} {'qs'[j]}"


def test_rank0_writes_the_gathered_export(world):
    """`step-2/` (rank 0's): each trained module loads back through
    `load_module` bit-equal to the gathered weights; every other rank's
    optimizer state beside it, and no second export."""
    ranks = world["ranks"]
    step = world["tmp"] / "ft_AdamW" / "step-2"
    dims = ranks[0]["full_AdamW"]["dims"]
    whole = _gathered(ranks, dims, lambda x, n: x["full_AdamW"]["steps"][-1]["params"][n],
                      FT_CASES["AdamW"][1])
    for name in ("video_dit", "audio_dit", "bridge"):
        module = lc.load_module(str(step), name, world["cfg"], dtype=torch.float32,
                                device="cpu")
        for k, p in module.named_parameters():
            assert torch.equal(p, whole[f"{name}.{k}"]), f"{name}.{k}"
    assert sorted(x.name for x in step.glob("state*.pt")) == [
        "state.pt", "state.rank1.pt", "state.rank2.pt", "state.rank3.pt"]
    assert (step / "meta.json").is_file()
