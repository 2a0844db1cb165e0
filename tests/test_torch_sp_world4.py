"""The port's sequence parallelism in a gloo world of four CPU processes
against the JAX package's functions under `shard_map` on the conftest's
virtual devices and against the port's own cp = 1 block stack (fp32; 2e-5
for the attention collectives, 3e-5 for the block stack: JAX's own
tolerances). Covers ranks whose chunk is all padding, pooled AdaLN with
frames straddling the shards, fsdp 2 x cp 2 and data 2 x cp 2."""

import functools

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dualforce_tpu.parallel import ring_attention as jra

from test_torch_sp_mesh import (blocks_case, jax_blocks_setup, jax_shard_map, jax_sp_blocks,
                                port_blocks, run_world)
from test_torch_sp_world2 import _qkv
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CP = 4
ATOL = RTOL = 2e-5
BLOCK_TOL = 3e-5
# 16 tokens in chunks of 4: valid 10 leaves rank 3's chunk all padding, valid 4 ranks 1-3's
VALID = [("whole", None), ("rank3_padding", 10), ("ranks123_padding", 4)]
# (name, mesh, setup): the block stack's cases
BLOCKS = [
    ("cp4", (1, 1, 4), dict(grid=(3, 2, 2), la=7)),                 # audio pad 1
    ("cp4_padded_rank", (1, 1, 4), dict(grid=(1, 3, 3), la=7)),     # rank 3's video all padding
    ("cp4_pooled_adaln", (1, 1, 4), dict(grid=(3, 2, 2), la=7, pooled=True)),
    ("fsdp2_cp2", (1, 2, 2), dict()),
    ("data2_cp2", (2, 1, 2), dict(batch=2)),
]



@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, jax_want, port_want = [], {}, {}
    for name, valid in VALID:
        for kind, fn, specs, sq in (
                ("ring", jra.ring_attention, ((P(None, "cp"),) * 3, P(None, "cp")), None),
                ("lse", jra.lse_combine_cross_attention,
                 ((P(), P(None, "cp"), P(None, "cp")), P()), 5)):
            q, k, v = _qkv(6, sq=sq)
            cases.append(dict(name=f"{kind}_{name}", kind=kind, mesh=(1, 1, CP), valid=valid,
                              **{n: torch.from_numpy(x) for n, x in zip("qkv", (q, k, v))}))
            jax_want[f"{kind}_{name}"] = jax_shard_map(
                functools.partial(fn, axis_name="cp", inner=jra._inner_with_lse,
                                  global_valid_len=valid), CP, *specs, q, k, v)
        q, k, v = _qkv(7)
        cases.append(dict(name=f"gather_{name}", kind="gather", mesh=(1, 1, CP), valid=valid,
                          impl="ref", **{n: torch.from_numpy(x) for n, x in
                                         zip("qkv", (q, k, v))}))
        jax_want[f"gather_{name}"] = jax_shard_map(
            functools.partial(jra.gather_kv_attention, axis_name="cp",
                              global_valid_len=valid, impl="ref"),
            CP, (P(None, "cp"),) * 3, P(None, "cp"), q, k, v)
    for heads in (8, 6):
        q, k, v = _qkv(8, n=heads)
        cases.append(dict(name=f"ulysses_{heads}", kind="ulysses", mesh=(1, 1, CP),
                          **{n: torch.from_numpy(x) for n, x in zip("qkv", (q, k, v))}))
    q, k, v = _qkv(8, n=8)
    jax_want["ulysses_8"] = jax_shard_map(
        functools.partial(jra.ulysses_attention, axis_name="cp", inner=jra._inner_with_lse),
        CP, (P(None, "cp"),) * 3, P(None, "cp"), q, k, v)
    for name, mesh, kw in BLOCKS:
        st = jax_blocks_setup(**kw)
        cases.append(blocks_case(name, mesh, st))
        jax_want[name] = jax_sp_blocks(st, mesh)
        port_want[name] = port_blocks(st)
    ranks = run_world(4, cases, tmp_path_factory.mktemp("sp4"))
    return dict(ranks=ranks, jax=jax_want, port=port_want)


def _whole(world, name):
    return torch.cat([world["ranks"][r][name] for r in range(CP)], dim=1).numpy()


@pytest.mark.parametrize("valid", [v[0] for v in VALID])
def test_attention_collectives_match_jax(world, valid):
    np.testing.assert_allclose(_whole(world, f"ring_{valid}"), world["jax"][f"ring_{valid}"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_whole(world, f"gather_{valid}"),
                               world["jax"][f"gather_{valid}"], rtol=RTOL, atol=ATOL)
    for r in range(CP):
        np.testing.assert_allclose(world["ranks"][r][f"lse_{valid}"].numpy(),
                                   world["jax"][f"lse_{valid}"], rtol=RTOL, atol=ATOL)


def test_ulysses_cp4(world):
    np.testing.assert_allclose(_whole(world, "ulysses_8"), world["jax"]["ulysses_8"],
                               rtol=RTOL, atol=ATOL)
    for r in range(CP):
        assert world["ranks"][r]["ulysses_6"].startswith("ValueError: Ulysses attention")


@pytest.mark.parametrize("name", [b[0] for b in BLOCKS])
def test_sp_blocks_match_jax_and_cp1(world, name):
    for r in range(CP):
        for got, jwant, pwant in zip(world["ranks"][r][name], world["jax"][name],
                                     world["port"][name]):
            np.testing.assert_allclose(got.numpy(), jwant, rtol=BLOCK_TOL, atol=BLOCK_TOL)
            np.testing.assert_allclose(got.numpy(), pwant, rtol=BLOCK_TOL, atol=BLOCK_TOL)
