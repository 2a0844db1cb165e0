"""Layer-group streaming (`diffusion/streamed.py`, `MOVAPipeline(offload=
"group")`) on the CPU at the tiny config in fp32.

`plan_groups` must equal the JAX package's for every depth, group size and
interaction strategy. The streamed denoise must give the bits of the port's
resident `denoise_range` (held against the JAX package's `denoise_loop` by
`tests/test_torch_pipeline.py` and `test_torch_sampler_options.py`): the
layers and the step run the same code in the same order. It is not held
against JAX's `denoise_streamed` itself, which fails on every configuration
with a video-only tail or an empty bridge group (ROADMAP C, caveat 2); the
sparse configuration that fails there runs here. Partial `denoise_state`
ranges chained under `cfg_cache_interval` 2 must give the whole range's
bits, across the expert switch too.
"""

import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.diffusion.streamed import plan_groups as jax_plan_groups

from dualforce_tpu_torch import offload
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.diffusion import sampler, streamed
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
from dualforce_tpu_torch.diffusion.step import dual_tower_step, make_rope_pack
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_pipeline import FakeTokenizer

STRATEGIES = ["full", "distributed", "shallow_focus", "progressive", "custom"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: these tiny tensors gain nothing
    from more, and Tier-1 runs six worker processes on the host's cores, where
    each worker's thread pool otherwise spins against the others' (ten times
    slower here under that load). Restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plan_groups_equals_jax(strategy):
    for visual, audio in [(2, 2), (5, 3), (7, 6), (3, 5), (12, 10), (30, 30)]:
        kw = dict(visual_layers=visual, audio_layers=audio, interaction_strategy=strategy)
        for group_size in (1, 2, 3, 8, 100):
            want = jax_plan_groups(jax_tiny_config(**kw).bridge, visual, group_size)
            got = streamed.plan_groups(tiny_test_config(**kw).bridge, visual, group_size)
            assert got == want, (visual, audio, group_size)
    with pytest.raises(ValueError):
        streamed.plan_groups(tiny_test_config().bridge, 2, 0)


def _setup(visual_layers=5, audio_layers=3, strategy="full"):
    cfg = tiny_test_config(visual_layers=visual_layers, audio_layers=audio_layers,
                           interaction_strategy=strategy)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                with_vaes=False, with_text=False, two_video_towers=False)
    g = torch.Generator().manual_seed(1)
    data = (torch.randn(1, 16, 3, 8, 8, generator=g), torch.randn(1, 20, 3, 8, 8, generator=g),
            torch.randn(1, cfg.audio_dit.in_dim, 25, generator=g),
            torch.randn(1, 16, cfg.video_dit.text_dim, generator=g),
            torch.randn(1, 16, cfg.video_dit.text_dim, generator=g))
    sched = FlowMatchPairScheduler(cfg.scheduler)
    sched.set_timesteps(4, shift=5.0)
    return cfg, mods, sampler.build_plan(sched, 0.0), data


CASES = {
    "group1": dict(group_size=1), "group2": dict(group_size=2),
    "group100": dict(group_size=100),
    "cfg_batch": dict(cfg_batch=True), "cache2": dict(cfg_cache_interval=2),
    "dual_cfg": dict(cfg_scale_bridge=1.5), "no_cfg": dict(cfg_scale=1.0),
    "ctx_len": dict(ctx_len_pos=torch.tensor([5]), ctx_len_neg=torch.tensor([3])),
    "resident_small": dict(resident_small=True),
    "pinned_groups": dict(resident_video_groups=1),
    "pinned_groups_small": dict(resident_video_groups=2, resident_small=True),
    "sparse": dict(group_size=4, layers=(7, 6, "distributed")),
    "sparse_small": dict(group_size=4, resident_small=True, layers=(7, 6, "distributed")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_bit_equal_to_resident(case):
    kw = dict(CASES[case])
    cfg, mods, plan, data = _setup(*kw.pop("layers", (5, 3, "full")))
    kw.setdefault("cfg_scale", 4.0)
    latents, condition, audio, ctx_pos, ctx_neg = data
    resident_kw = {k: v for k, v in kw.items()
                   if k not in ("group_size", "resident_small", "resident_video_groups")}
    want = sampler.denoise_range(mods["video_dit"], mods["audio_dit"], mods["bridge"],
                                 latents, condition, audio, ctx_pos, ctx_neg, plan, 0,
                                 plan.num_steps, compute_dtype=torch.float32,
                                 attn_impl="ref", **resident_kw)
    stats = streamed.StreamStats()
    kw.setdefault("group_size", 2)
    got = streamed.denoise_streamed(mods["video_dit"], mods["audio_dit"], mods["bridge"],
                                    latents, condition, audio, ctx_pos, ctx_neg, plan, 0,
                                    plan.num_steps, compute_dtype=torch.float32,
                                    attn_impl="ref", stats=stats, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # bytes: one sweep a step, each streamed block once per sweep; pinned groups
    # and resident audio and bridge blocks stay on the device
    groups = streamed.plan_groups(cfg.bridge, cfg.video_dit.num_layers, kw["group_size"])
    pinned = groups[:kw.get("resident_video_groups", 0)]
    video = sum(offload.nbytes(mods["video_dit"].blocks[i]) for g in groups[len(pinned):]
                for i in range(*g["v"]))
    small = sum(offload.nbytes(mods["audio_dit"].blocks[i]) for g in groups[len(pinned):]
                for i in range(g["v"][0], g["v"][0] + g["shared"])) + sum(
        offload.nbytes(getattr(mods["bridge"], c)[str(g["v"][0] + j)])
        for g in groups[len(pinned):] for j in g["interact"] for c in streamed.CONDITIONERS)
    per_sweep = video + (0 if kw.get("resident_small") else small)
    assert stats.take() == (plan.num_steps * per_sweep, 0.0)


def test_ring_holds_two_groups_and_runs_per_module():
    """A tower laid out by `offload.to_host` streams each group as one host
    run per module; the ring's two slots are sized to the largest group;
    `streamed_pass` over it gives the resident step's bits."""
    cfg, mods, plan, _ = _setup(7, 6, "distributed")
    for m in mods.values():
        offload.to_host(m, "cpu")
    specs = streamed.plan_groups(cfg.bridge, 7, 4)
    stream = streamed.LayerStream(specs, mods["video_dit"], mods["audio_dit"],
                                  mods["bridge"], torch.device("cpu"))
    # group 0: layers 0-3 with the bridge's only conditioners (layers 0 and 3,
    # a2v then v2a, side by side) -> video, audio and bridge runs; group 1:
    # shared layers 4-5, no interaction; group 2: the video tail
    assert [len(g["runs"].runs) for g in stream.groups_] == [3, 2, 1]
    assert len(stream.slots) == 2
    assert stream.slots[0].numel() == max(g["runs"].nbytes for g in stream.groups_)
    # one pass over the ring: the resident step's bits
    g = torch.Generator().manual_seed(5)
    mi, al = torch.randn(1, 36, 3, 8, 8, generator=g), torch.randn(1, 8, 25, generator=g)
    ctx, t = torch.randn(1, 16, 32, generator=g), torch.tensor([600.0])
    rope = make_rope_pack(cfg.video_dit, cfg.audio_dit, cfg.bridge, (3, 4, 4), 25,
                          device="cpu")
    want = dual_tower_step(mods["video_dit"], mods["audio_dit"], mods["bridge"], mi, al, ctx,
                           t, compute_dtype=torch.float32, attn_impl="ref", rope_pack=rope)
    got = streamed.streamed_pass(mods["video_dit"], mods["audio_dit"], stream, mi, al, ctx, t,
                                 t, rope, compute_dtype=torch.float32, attn_impl="ref")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.float(), rtol=0, atol=0)


REQUEST = dict(height=32, width=32, num_frames=5, num_inference_steps=4, cfg_scale=5.0,
               cfg_cache_interval=2)


@pytest.fixture(scope="module")
def pipeline_setup():
    cfg = tiny_test_config()
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    image = np.random.default_rng(2).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    return cfg, mods, image


def _pipe(setup, **kw):
    cfg, mods, _ = setup
    return MOVAPipeline(cfg, mods, tokenizer=FakeTokenizer(), compute_dtype=torch.float32,
                        device="cpu", **kw)


@pytest.mark.parametrize("chunks", [[1, 1, 1, 1], [2, 2], [3, 1]])
def test_partial_ranges_bit_equal_to_whole(pipeline_setup, chunks):
    """Chained ranges carry the CFG negative cache mid-phase (not across the
    expert switch, which falls at step 1 here) and give the whole range's
    bits, which are the resident pipeline's."""
    image = pipeline_setup[2]
    resident = _pipe(pipeline_setup)
    group = _pipe(pipeline_setup, offload="group", offload_group_size=1)
    state = group.prepare_state(["a cat"], [image], negative_prompts=["blurry"], seeds=[3],
                                **REQUEST)
    assert state["neg_cache_v"] is None
    whole = resident.denoise_state(state)
    plan = group._plan_for(state["settings"])
    assert 0 < plan.boundary_step < plan.num_steps - 1
    part = state
    for k in chunks:
        part = group.denoise_state(part, max_steps=k)
    assert part["step"] == whole["step"] == 4
    for key in ("latents", "audio_latents"):
        torch.testing.assert_close(part[key], whole[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="offload='group'"):
        resident.denoise_state(state, max_steps=1)
