"""The port's sequence- and weight-parallel serving in a gloo world of two
CPU processes, against the JAX package's functions under `shard_map` on
the conftest's virtual devices (fp32, JAX's tolerances: 2e-5 for the
attention collectives, tests/test_ring_attention.py; 3e-5 for the block
stack, tests/test_sp_equivalence.py) and against the port's own cp = 1
paths: fsdp over int8 and int4 towers (the shards JAX's `param_pspecs` of
the quantized tree names; a quantized request bit-equal to one process),
and the `/v1/videos` server under the mesh, rank 0 serving while rank 1
follows. One world runs every case (`test_torch_sp_mesh.run_world`).
"""

import functools
import io

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dualforce_tpu import nn as jnn
from dualforce_tpu.ops.attention import attention_ref as jax_attention_ref
from dualforce_tpu.parallel import ring_attention as jra
from dualforce_tpu.parallel.sharding import param_pspecs

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.cli import serve as serve_cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.data.transforms import crop_and_resize, image_to_tensor
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.utils.av_io import save_video_with_audio
from test_torch_sp_mesh import (SERVE_REQUEST, ByteTokenizer, blocks_case, generate,
                                jax_blocks_setup, jax_shard_map, jax_sp_blocks, port_blocks,
                                run_world)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CP = 2
ATOL = RTOL = 2e-5
BLOCK_TOL = 3e-5
# (name, global valid length or None) of the attention cases; 16 tokens in chunks of 8:
# valid 6 leaves rank 1's chunk all padding
VALID = [("whole", None), ("padded", 13), ("rank1_padding", 6)]
REQUEST = dict(height=32, width=32, num_frames=5, num_inference_steps=2, sigma_shift=5.0,
               cfg_scale=5.0)
QUANTIZE = ("int8", "int4")
QUANTIZED_LEAVES = {"int8": ("weight_q", "weight_scale"), "int4": ("weight_q4", "weight_scale4")}
# the served pair: (prompt, seed), and each reference's PNG (height, width, seed)
SERVE_PAIR = [("a cat playing piano", 11), ("a dog on a skateboard", 12)]
SERVE_PNGS = [(40, 48, 4), (36, 30, 5)]
SERVE_FLAGS = {"fsdp2": ["--fsdp_size", "2"], "cp2": ["--cp_size", "2"]}


def _png(h, w, seed) -> bytes:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _one_process_pair(ckpt, root):
    """The served pair as one process runs the same group: the clips'
    generate results and the bytes `save_video_with_audio` writes for them."""
    from PIL import Image

    pipe = serve_cli.build_server(serve_cli.parse_args(
        ["--ckpt_path", ckpt, "--device", "cpu", "--out_dir", str(root / "one")]),
        tokenizer=ByteTokenizer(), dtype=torch.float32).pipe
    frames = [image_to_tensor(crop_and_resize(
        Image.open(io.BytesIO(_png(*png))).convert("RGB"), 32, 32)) for png in SERVE_PNGS]
    with torch.no_grad():
        results = pipe.generate(
            prompts=[p for p, _ in SERVE_PAIR], images=frames,
            negative_prompts=[SERVE_REQUEST["negative_prompt"]] * 2,
            seeds=[s for _, s in SERVE_PAIR], height=32, width=32,
            num_frames=SERVE_REQUEST["num_frames"], video_fps=SERVE_REQUEST["fps"],
            num_inference_steps=SERVE_REQUEST["num_inference_steps"], cfg_scale=5.0,
            cfg_scale_bridge=0.0)
    clips = []
    for i, r in enumerate(results):
        path = save_video_with_audio(str(root / "one" / f"{i}.mp4"), r.video, r.audio,
                                     fps=r.fps, sample_rate=r.sample_rate)
        with open(path, "rb") as f:
            clips.append(f.read())
    return {"results": [(r.video, r.audio) for r in results], "clips": clips}



def _qkv(seed, s=16, n=4, d=16, sq=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, sq if (sq and i == 0) else s, n, d)).astype(np.float32)
            for i in range(3)]


def _shards_of(jparams, cfg, fsdp: int, rank: int):
    """The port-named shards JAX's `param_pspecs` gives fsdp rank `rank` of
    the towers' blocks and the bridge's conditioners."""
    def take(x, spec):
        x = np.asarray(x)
        for d, name in enumerate(tuple(spec)):
            if name == "fsdp" and d > 0:       # the layer dim: replicated (_no_layer_shard)
                n = x.shape[d] // fsdp
                x = np.take(x, np.arange(rank * n, (rank + 1) * n), axis=d)
        return x

    import jax

    tree = {}
    for name, p in jparams.items():
        stacks = ("blocks",) if name != "bridge" else ("a2v", "v2a")
        tree[name] = dict(p)
        for key in stacks:
            tree[name][key] = jax.tree.map(take, p[key], param_pspecs(p[key], fsdp))
    sds = from_jax.state_dicts(tree, cfg)
    keep = {"bridge": ("audio_to_video", "video_to_audio")}
    return {name: {k: v for k, v in sd.items()
                   if k.startswith(keep.get(name, ("blocks.",)))} for name, sd in sds.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, jax_want, port_want = [], {}, {}
    cross = {True: jax_blocks_setup(cross=True), False: jax_blocks_setup(cross=False)}
    for inner in ("ref", "pallas"):
        for name, valid in VALID:
            q, k, v = _qkv(0)
            key = f"ring_{inner}_{name}"
            cases.append(dict(name=key, kind="ring", mesh=(1, 1, CP), inner=inner,
                              valid=valid, **{n: torch.from_numpy(x) for n, x in
                                              zip("qkv", (q, k, v))}))
            jax_want[key] = jax_shard_map(
                functools.partial(jra.ring_attention, axis_name="cp",
                                  inner=jra._inner_with_lse, global_valid_len=valid),
                CP, (P(None, "cp"),) * 3, P(None, "cp"), q, k, v)
    for name, valid in VALID:
        q, k, v = _qkv(1, sq=5)
        cases.append(dict(name=f"lse_{name}", kind="lse", mesh=(1, 1, CP), valid=valid,
                          **{n: torch.from_numpy(x) for n, x in zip("qkv", (q, k, v))}))
        jax_want[f"lse_{name}"] = jax_shard_map(
            functools.partial(jra.lse_combine_cross_attention, axis_name="cp",
                              inner=jra._inner_with_lse, global_valid_len=valid),
            CP, (P(), P(None, "cp"), P(None, "cp")), P(), q, k, v)
        q, k, v = _qkv(2)
        cases.append(dict(name=f"gather_{name}", kind="gather", mesh=(1, 1, CP), valid=valid,
                          impl="ref", **{n: torch.from_numpy(x) for n, x in
                                         zip("qkv", (q, k, v))}))
        jax_want[f"gather_{name}"] = jax_shard_map(
            functools.partial(jra.gather_kv_attention, axis_name="cp",
                              global_valid_len=valid, impl="ref"),
            CP, (P(None, "cp"),) * 3, P(None, "cp"), q, k, v)
    for heads in (4, 3):
        q, k, v = _qkv(3, n=heads)
        cases.append(dict(name=f"ulysses_{heads}", kind="ulysses", mesh=(1, 1, CP),
                          **{n: torch.from_numpy(x) for n, x in zip("qkv", (q, k, v))}))
    q, k, v = _qkv(3, n=4)
    jax_want["ulysses_4"] = jax_shard_map(
        functools.partial(jra.ulysses_attention, axis_name="cp",
                          inner=jra._inner_with_lse),
        CP, (P(None, "cp"),) * 3, P(None, "cp"), q, k, v)
    for c in (True, False):
        st = cross[c]
        cases.append(blocks_case(f"blocks_cross_{c}", (1, 1, CP), st))
        jax_want[f"blocks_cross_{c}"] = jax_sp_blocks(st, (1, 1, CP))
        port_want[f"blocks_cross_{c}"] = port_blocks(st)
    st = cross[True]
    cases.append(dict(name="shard", kind="shard", mesh=(1, 2, 1), modules=st["modules"]))
    cases.append(blocks_case("blocks_fsdp2", (1, 2, 1), st))
    cfg = tiny_test_config()
    image = np.random.default_rng(5).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    cases.append(dict(name="pipeline", kind="pipeline", mesh=(1, 1, CP), cfg=cfg,
                      prompt="a cat playing piano", image=image, request=REQUEST))
    cases.append(dict(name="refusals", kind="refusals", mesh=(1, 1, CP), cfg=cfg))
    for mode in QUANTIZE:
        cases.append(dict(name=f"shard_{mode}", kind="shard", mesh=(1, 2, 1),
                          modules=st["modules"], quantize=mode))
        cases.append(dict(name=f"pipeline_fsdp2_{mode}", kind="pipeline", mesh=(1, 2, 1),
                          cfg=cfg, prompt="a cat playing piano", image=image,
                          request=REQUEST, quantize=mode))
    root = tmp_path_factory.mktemp("sp2")
    ckpt = str(root / "ckpt")
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, ckpt)
    for name, flags in SERVE_FLAGS.items():
        cases.append(dict(name=f"serve_{name}", kind="serve", mesh=(1, 1, CP), ckpt=ckpt,
                          out=str(root / name), flags=flags, prompts=SERVE_PAIR,
                          images=[_png(*png) for png in SERVE_PNGS]))
    ranks = run_world(2, cases, root)
    source = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    pipe = MOVAPipeline(cfg, source, tokenizer=ByteTokenizer(), compute_dtype=torch.float32,
                        device="cpu")
    port_want["pipeline"] = generate(pipe, "a cat playing piano", image, REQUEST)
    for mode in QUANTIZE:
        pipe = MOVAPipeline(cfg, source, tokenizer=ByteTokenizer(),
                            compute_dtype=torch.float32, device="cpu", quantize=mode)
        port_want[f"pipeline_{mode}"] = generate(pipe, "a cat playing piano", image, REQUEST)
        quantize_tree = jnn.quantize_tree_int8 if mode == "int8" else jnn.quantize_tree_int4
        port_want[f"whole_{mode}"] = {
            name: {k: tuple(t.shape) for k, t in tnn.quantize_modules(m, mode).state_dict().items()}
            for name, m in st["modules"].items()}
        jax_want[f"shard_{mode}"] = [
            _shards_of({n: quantize_tree(p) for n, p in st["jparams"].items()}, st["cfg"], 2, r)
            for r in range(2)]
    port_want["serve"] = _one_process_pair(ckpt, root)
    return dict(ranks=ranks, jax=jax_want, port=port_want, setup=st)


def _whole(world, name):
    return torch.cat([world["ranks"][r][name] for r in range(CP)], dim=1).numpy()


def test_backend_is_gloo(world):
    assert all(r["_backend"] == "gloo" for r in world["ranks"])


@pytest.mark.parametrize("inner", ["ref", "pallas"])
@pytest.mark.parametrize("valid", [v[0] for v in VALID])
def test_ring_attention_matches_jax(world, inner, valid):
    """The port's ring (plain inner, and B1's plain version: no keyless
    chunk reaches it) against JAX's ring with its plain inner."""
    key = f"ring_{inner}_{valid}"
    np.testing.assert_allclose(_whole(world, key), world["jax"][key], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("valid", [v[0] for v in VALID])
def test_lse_combine_and_gather_kv_match_jax(world, valid):
    for r in range(CP):
        np.testing.assert_allclose(world["ranks"][r][f"lse_{valid}"].numpy(),
                                   world["jax"][f"lse_{valid}"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_whole(world, f"gather_{valid}"), world["jax"][f"gather_{valid}"],
                               rtol=RTOL, atol=ATOL)


def test_ulysses_matches_jax_and_refuses_odd_heads(world):
    np.testing.assert_allclose(_whole(world, "ulysses_4"), world["jax"]["ulysses_4"],
                               rtol=RTOL, atol=ATOL)
    q, k, v = _qkv(3, n=4)
    np.testing.assert_allclose(_whole(world, "ulysses_4"),
                               np.asarray(jax_attention_ref(q, k, v)), rtol=RTOL, atol=ATOL)
    for r in range(CP):
        assert world["ranks"][r]["ulysses_3"].startswith("ValueError: Ulysses attention "
                                                         "needs heads % axis size == 0")


@pytest.mark.parametrize("cross", [True, False], ids=["cross_rope", "no_cross_rope"])
def test_sp_blocks_match_jax_and_cp1(world, cross):
    key = f"blocks_cross_{cross}"
    for r in range(CP):
        for got, jwant, pwant in zip(world["ranks"][r][key], world["jax"][key],
                                     world["port"][key]):
            np.testing.assert_allclose(got.numpy(), jwant, rtol=BLOCK_TOL, atol=BLOCK_TOL)
            np.testing.assert_allclose(got.numpy(), pwant, rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_fsdp2_shards_are_jax_pspecs_slices(world):
    st = world["setup"]
    for r in range(2):
        want = _shards_of(st["jparams"], st["cfg"], 2, r)
        got = world["ranks"][r]["shard"]
        n_split = 0
        for name, sd in want.items():
            for k, w in sd.items():
                g = got[name][k]
                assert tuple(g.shape) == w.shape, (name, k)
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name}.{k}")
                n_split += int(g.numel() < st["modules"][name].get_parameter(k).numel())
        assert n_split > 100


def test_fsdp2_blocks_equal_cp1(world):
    for r in range(2):
        for got, want in zip(world["ranks"][r]["blocks_fsdp2"], world["port"]["blocks_cross_True"]):
            np.testing.assert_array_equal(got.numpy(), want)


def test_pipeline_cp2_matches_cp1(world):
    """The denoised latents within 1e-4 of the cp = 1 request's, and the
    decoded clip (a uint8 level at most where a value sits on a rounding
    edge)."""
    want = world["port"]["pipeline"]
    for r in range(CP):
        got = world["ranks"][r]["pipeline"]
        for key in ("latents", "audio_latents", "audio"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
        assert got["video"].shape == want["video"].shape == (5, 32, 32, 3)
        diff = np.abs(got["video"].astype(np.int16) - want["video"].astype(np.int16))
        assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3


def test_refusals(world):
    for r in range(CP):
        got = world["ranks"][r]["refusals"]
        assert "single-chip escape hatch" in got["group_offload"]
        assert "needs a world of 4 processes, this one has 2" in got["world_mismatch"]


@pytest.mark.parametrize("mode", QUANTIZE)
def test_fsdp2_quantized_shards_are_jax_pspecs_slices(world, mode):
    """Each rank's int8 (weights and per-output-channel scales) or int4
    (packed nibbles and group scales) shards are the slices JAX's
    `param_pspecs` of the quantized tree names, whether the towers were
    sharded before they were quantized (the pipeline's way) or after."""
    for r in range(2):
        want = world["jax"][f"shard_{mode}"][r]
        got = world["ranks"][r][f"shard_{mode}"]
        assert set(got) == {"sharded_first", "quantized_first"}
        whole = world["port"][f"whole_{mode}"]
        for way, mods in got.items():
            n_split = 0
            for name, sd in want.items():
                assert set(mods[name]) >= set(sd)
                for k, w in sd.items():
                    g = mods[name][k]
                    assert tuple(g.shape) == w.shape, (way, name, k)
                    np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{way} {name}.{k}")
                    n_split += int(k.rpartition(".")[2] in QUANTIZED_LEAVES[mode]
                                   and tuple(g.shape) != whole[name][k])
            assert n_split > 20, (way, n_split)


@pytest.mark.parametrize("mode", QUANTIZE)
def test_fsdp2_quantized_request_equals_one_process(world, mode):
    want = world["port"][f"pipeline_{mode}"]
    for r in range(2):
        got = world["ranks"][r][f"pipeline_fsdp2_{mode}"]
        for key in ("latents", "audio_latents", "video", "audio"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", list(SERVE_FLAGS))
def test_server_under_the_mesh(world, name):
    """Rank 0 served the pair as one group on both ranks; the cancelled task
    never reached a backend and the bad image failed on rank 0 alone (rank
    1 never heard of it); both ranks ended at the stop. The downloads are
    the clips of the pair's results, which are bit-equal to one process's
    at fsdp 2 and within `test_pipeline_cp2_matches_cp1`'s tolerance at cp 2."""
    lead = world["ranks"][0][f"serve_{name}"]
    ids = lead["ids"]
    assert lead["groups"][:2] == [ids["pair"], [ids["bad"]]]
    assert lead["cancel_status"] == "cancelled"
    for tid in ids["pair"]:
        assert lead["status"][tid] == ("completed", None)
    assert lead["status"][ids["queued"]][0] == "cancelled"
    status, error = lead["status"][ids["bad"]]
    assert status == "failed" and "cannot identify image file" in error
    want = world["port"]["serve"]
    got = lead["results"][0]
    assert lead["downloads"][:2] == lead["saved"][0]
    for i, ((video, audio), (wvideo, waudio)) in enumerate(zip(got, want["results"])):
        assert video.shape == wvideo.shape == (5, 32, 32, 3)
        if name == "fsdp2":
            np.testing.assert_array_equal(video, wvideo)
            np.testing.assert_array_equal(audio, waudio)
            assert lead["downloads"][i] == want["clips"][i]
        else:
            np.testing.assert_allclose(audio, waudio, rtol=1e-4, atol=1e-4)
            diff = np.abs(video.astype(np.int16) - wvideo.astype(np.int16))
            assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3


@pytest.mark.parametrize("name", list(SERVE_FLAGS))
def test_server_survives_a_rank_failing_alone(world, name):
    """A group whose `prepare_state` failed on rank 1 alone (before any data
    collective) failed on rank 0 with rank 1's error, and both ranks served
    the next group: rank 1 followed the pair, the failed group and the next
    one, and the next one's download is the clip of its result."""
    lead, follower = world["ranks"][0][f"serve_{name}"], world["ranks"][1][f"serve_{name}"]
    ids = lead["ids"]
    assert follower == {"followed": 3, "rank": 1}
    assert lead["groups"][2:] == [[ids["lost"]], [ids["after"]]]
    status, error = lead["status"][ids["lost"]]
    assert status == "failed"
    assert error.startswith("rank 1: RuntimeError: out of memory in the encode"), error
    assert lead["status"][ids["after"]] == ("completed", None)
    assert len(lead["results"]) == 2 and len(lead["results"][1]) == 1
    assert lead["downloads"][2:] == lead["saved"][1]
