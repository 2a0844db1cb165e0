"""The port's fsdp sharding and ring attention in a gloo world of three CPU
processes: each rank's shard of every tiny tower block and bridge
conditioner parameter is the slice JAX's `param_pspecs` gives it at fsdp 3,
the block stack over the shards equals the whole one bit for bit, and the
ring at cp 3 matches JAX's under `shard_map` within 2e-5
(tests/test_ring_attention.py's tolerance). This world joins through the
JAX package's environment (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID), the others through torchrun's."""

import functools

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dualforce_tpu.parallel import ring_attention as jra

from test_torch_sp_mesh import (blocks_case, jax_blocks_setup, jax_shard_map, port_blocks,
                                run_world)
from test_torch_sp_world2 import _qkv, _shards_of
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CP = 3
# 18 tokens in chunks of 6: valid 11 pads rank 1's chunk partly and leaves rank 2's all padding
VALID = [("whole", None), ("rank2_padding", 11)]



@pytest.fixture(scope="module")
def world(tmp_path_factory):
    st = jax_blocks_setup(cross=True)
    cases = [dict(name="shard", kind="shard", mesh=(1, 3, 1), modules=st["modules"]),
             blocks_case("blocks_fsdp3", (1, 3, 1), st)]
    jax_want = {}
    for name, valid in VALID:
        q, k, v = _qkv(4, s=18)
        cases.append(dict(name=f"ring_{name}", kind="ring", mesh=(1, 1, CP), valid=valid,
                          **{n: torch.from_numpy(x) for n, x in zip("qkv", (q, k, v))}))
        jax_want[f"ring_{name}"] = jax_shard_map(
            functools.partial(jra.ring_attention, axis_name="cp", inner=jra._inner_with_lse,
                              global_valid_len=valid),
            CP, (P(None, "cp"),) * 3, P(None, "cp"), q, k, v)
    ranks = run_world(3, cases, tmp_path_factory.mktemp("sp3"), jax_env=True)
    return dict(ranks=ranks, setup=st, jax=jax_want, port=port_blocks(st))


def test_world_joined_through_jax_environment(world):
    """Each process read PROCESS_ID as its rank (its results are filed
    under it) and NUM_PROCESSES as the world, on gloo (the CPU)."""
    assert [(r["_world"], r["_backend"]) for r in world["ranks"]] == [(3, "gloo")] * 3


@pytest.mark.parametrize("rank", range(3))
def test_fsdp3_shards_are_jax_pspecs_slices(world, rank):
    st = world["setup"]
    got = world["ranks"][rank]["shard"]
    split = 0
    for name, sd in _shards_of(st["jparams"], st["cfg"], 3, rank).items():
        for k, want in sd.items():
            np.testing.assert_array_equal(got[name][k].numpy(), want, err_msg=f"{name}.{k}")
            split += int(got[name][k].numel() < st["modules"][name].get_parameter(k).numel())
    assert split > 50


def test_fsdp3_blocks_equal_the_whole_stack(world):
    for r in range(3):
        for got, want in zip(world["ranks"][r]["blocks_fsdp3"], world["port"]):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("valid", [v[0] for v in VALID])
def test_ring_cp3_matches_jax(world, valid):
    got = torch.cat([world["ranks"][r][f"ring_{valid}"] for r in range(CP)], dim=1).numpy()
    np.testing.assert_allclose(got, world["jax"][f"ring_{valid}"], rtol=2e-5, atol=2e-5)
