"""The port's sequence parallelism in a gloo world of four CPU processes
against the JAX package's functions under `shard_map` on the conftest's
virtual devices and against the port's own cp = 1 block stack (fp32; 2e-5
for the attention collectives, 3e-5 for the block stack: JAX's own
tolerances). Covers ranks whose chunk is all padding, pooled AdaLN with
frames straddling the shards, fsdp 2 x cp 2 and data 2 x cp 2, and an
int8-quantized request at fsdp 2 x cp 2 (fp32, attn_impl "ref") against
the same request in one process at tests/test_quantize.py's tolerances
for JAX's mesh against its single device (video within one uint8 step,
audio within 1e-4), and against JAX's single-device
`MOVAPipeline(quantize="int8")`: video within one uint8 step as there,
audio within 1e-4 relative and absolute (the port's audio tolerance
against JAX's requests, tests/test_torch_cli.py). The int8 activations are
rounded to whole codes, so an fp32 difference of one ulp can move a code
on a rounding edge: JAX's and the port's one-process requests are 5.2e-3
apart in their latents (6e-7 without int8), 18 % of the video's values
one step apart, and one audio sample of 10,000 1.07e-4 apart (of 0.82)."""

import functools

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion.pipeline import MOVAPipeline as JaxPipeline
from dualforce_tpu.parallel import ring_attention as jra

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_pipeline import _jax_params
from test_torch_sp_mesh import (ByteTokenizer, blocks_case, generate, jax_blocks_setup,
                                jax_shard_map, jax_sp_blocks, port_blocks, run_world)
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
# the quantized request (tests/test_quantize.py:125-129's geometry and guidance)
Q_REQUEST = dict(height=32, width=32, num_frames=5, num_inference_steps=2, cfg_scale=3.0)
Q_PROMPT, Q_SEED = "a bird", 5


def _jax_int8_request(image):
    """JAX's single-device int8 pipeline on the weights of the port's seed-0
    modules, from the port's initial noise (the two draw different noise),
    compiled with XLA's optimisation passes off, as the port's other
    pipeline tests compile it: the same math, without XLA's rewrite of the
    activations' division by their scale into a product, which moves int8
    codes on rounding edges."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return _jax_int8_run(image)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)


def _jax_int8_run(image):
    cfg = tiny_test_config()
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(), compute_dtype=torch.float32,
                        device="cpu")
    kw = dict(negative_prompts=["blurry"], seeds=[Q_SEED], **Q_REQUEST)
    state = pipe.prepare_state([Q_PROMPT], [image], **kw)
    jpipe = JaxPipeline(jax_tiny_config(), _jax_params(modules, jax_tiny_config()),
                        tokenizer=ByteTokenizer(), compute_dtype=jnp.float32, attn_impl="ref",
                        quantize="int8")
    jstate = jpipe.prepare_state([Q_PROMPT], [image], **kw)
    jstate = dict(jstate, latents=state["latents"].numpy(),
                  audio_latents=state["audio_latents"].numpy())
    res = jpipe.finalize_state(jpipe.denoise_state(jstate))[0]
    return {"video": res.video, "audio": res.audio}



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
    image = np.random.default_rng(3).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    cases.append(dict(name="int8_fsdp2_cp2", kind="pipeline", mesh=(1, 2, 2),
                      cfg=tiny_test_config(), prompt=Q_PROMPT, image=image, seed=Q_SEED,
                      request=Q_REQUEST, quantize="int8", attn_impl="ref"))
    jax_want["int8_fsdp2_cp2"] = _jax_int8_request(image)
    cfg = tiny_test_config()
    pipe = MOVAPipeline(cfg, init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                  seed=0),
                        tokenizer=ByteTokenizer(), compute_dtype=torch.float32, device="cpu",
                        quantize="int8", attn_impl="ref")
    port_want["int8_fsdp2_cp2"] = generate(pipe, Q_PROMPT, image, Q_REQUEST, Q_SEED)
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


@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_int8_fsdp2_cp2_request_matches_jax(world, against):
    """The int8 request at fsdp 2 x cp 2 against the same request in one
    process (JAX's mesh-against-one-device tolerances) and against JAX's
    (the port's request-against-JAX tolerances; see the module's note)."""
    want = (world["port"] if against == "one_process" else world["jax"])["int8_fsdp2_cp2"]
    for r in range(CP):
        got = world["ranks"][r]["int8_fsdp2_cp2"]
        assert got["video"].shape == want["video"].shape == (5, 32, 32, 3)
        diff = np.abs(got["video"].astype(np.int16) - want["video"].astype(np.int16))
        assert diff.max() <= 1
        np.testing.assert_allclose(got["audio"], want["audio"], atol=1e-4,
                                   rtol=0 if against == "one_process" else 1e-4)
