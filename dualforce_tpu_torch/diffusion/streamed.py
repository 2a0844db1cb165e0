"""Layer-group streamed denoise: the reference's `--offload group` (counterpart
of `dualforce_tpu/diffusion/streamed.py`).

The active video expert's blocks, and unless `resident_small` the audio
tower's blocks and the bridge's conditioners, stay in host memory; each
forward pass streams them through the card `group_size` layers at a time.
What the towers hold besides their blocks (embeddings, heads) is staged once
per range. A step's passes (positive, negative, the bridge-off pass of dual
CFG) share one staging sweep.

The sweep copies group g+1 on a side CUDA stream while group g computes,
into a two-slot device ring sized to the largest group: each group's bytes
go over in one copy per contiguous host run (`offload.HostRuns`: one run
per module for masters laid out by `offload.to_host`), the compute stream
waits on the copy's event, and a slot is refilled only after an event
recorded behind the last compute that read it. So at most two groups are on
the card, as in the JAX package, whose host loop bounds its transfers in
flight to two groups. The layers run through the resident path's own code
(`diffusion/step.step_prologue`, `models/dual_tower.forward_dual_tower` over
each group's layer range, `step.step_head`) and the step through the
sampler's (`diffusion/sampler.denoise_steps`), so the streamed denoise gives
the resident one's bits.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from dualforce_tpu_torch import offload as off
from dualforce_tpu_torch.config import BridgeConfig
from dualforce_tpu_torch.diffusion.sampler import Pass, SamplePlan, denoise_steps
from dualforce_tpu_torch.diffusion.step import make_rope_pack, step_head, step_prologue
from dualforce_tpu_torch.models.dual_tower import forward_dual_tower

CONDITIONERS = ("audio_to_video_conditioners", "video_to_audio_conditioners")


def plan_groups(bcfg: BridgeConfig, num_video_layers: int,
                group_size: int) -> List[Dict[str, Any]]:
    """Split the interleaved stack into groups (the JAX package's spec, key
    for key): {"v": (s0, s1), "a": (s0, s1), "b": (b0, b1), "shared": int,
    "interact": tuple}: the video and audio layer ranges, the range of the
    group's conditioners in the order of `interaction_layers()`, the group's
    shared depth and its interacting layers, counted from s0. Shared layers
    are grouped first, then the video-only tail; no group spans both."""
    if group_size <= 0:
        raise ValueError(f"group_size must be positive, got {group_size}")
    shared = min(bcfg.min_layers, num_video_layers)
    interact = bcfg.interaction_layers()
    groups: List[Dict[str, Any]] = []
    for s0 in range(0, shared, group_size):
        s1 = min(s0 + group_size, shared)
        local = [l - s0 for l in interact if s0 <= l < s1]
        bpos = [i for i, l in enumerate(interact) if s0 <= l < s1]
        b0, b1 = (bpos[0], bpos[-1] + 1) if bpos else (0, 0)
        groups.append({"v": (s0, s1), "a": (s0, s1), "b": (b0, b1),
                       "shared": s1 - s0, "interact": tuple(local)})
    for s0 in range(shared, num_video_layers, group_size):
        s1 = min(s0 + group_size, num_video_layers)
        groups.append({"v": (s0, s1), "a": (shared, shared), "b": (0, 0),
                       "shared": 0, "interact": ()})
    return groups


class StreamStats:
    """What the sweeps moved: bytes over the link and, on a CUDA card, the
    copy stream's busy time (CUDA events around each group's copies; 0 on
    the CPU). `take()` returns (bytes, copy seconds) since the last call;
    it waits for the card."""

    def __init__(self):
        self.bytes = 0
        self._events: List[Tuple[Any, Any]] = []

    def take(self) -> Tuple[int, float]:
        if self._events:
            self._events[-1][1].synchronize()
        out = (self.bytes, sum(a.elapsed_time(b) for a, b in self._events) / 1e3)
        self.bytes, self._events = 0, []
        return out


class LayerStream:
    """The layer groups of one expert phase and the ring that stages them.

    Each group's blocks come from the host masters (streamed), or from
    `resident_audio`/`resident_bridge` (copies already on the device:
    `resident_small`), or, for the first `pinned_groups` groups, from
    device copies made once (`resident_video_groups`). `groups()` yields,
    per group, (layer range, {layer: video block}, {layer: audio block},
    the bridge holding the group's conditioners), the device copies ready
    for the compute stream."""

    def __init__(self, specs, video, audio, bridge, device: torch.device,
                 resident_audio=None, resident_bridge=None, pinned_groups: int = 0,
                 stats: Optional[StreamStats] = None):
        self.device = device
        self.stats = stats
        self.bridge = resident_bridge if resident_bridge is not None else bridge
        self.groups_: List[Dict[str, Any]] = []
        small_home = ((audio, bridge) if resident_audio is None
                      else (resident_audio, resident_bridge))
        for spec in specs:
            v0, v1 = spec["v"]
            inter = [v0 + l for l in spec["interact"]]
            keys = [("v", i, video.blocks[i]) for i in range(v0, v1)]
            small = ([("a", i, small_home[0].blocks[i])
                      for i in range(v0, v0 + spec["shared"])]
                     + [(c, i, getattr(small_home[1], c)[str(i)]) for c in CONDITIONERS
                        for i in inter])
            fixed, streamed = (small, keys) if resident_audio is not None else ([], keys + small)
            self.groups_.append({"layers": (v0, v1), "fixed": fixed,
                                 "keys": [(k, i) for k, i, _ in streamed],
                                 "runs": off.HostRuns(m for _, _, m in streamed)})
        self.pinned: List[torch.Tensor] = []
        for g in self.groups_[:pinned_groups]:
            buf = torch.empty(g["runs"].nbytes, dtype=torch.uint8, device=device)
            g["fixed"] = g["fixed"] + [(k, i, m) for (k, i), m in
                                       zip(g["keys"], g["runs"].copy_to(buf))]
            g["keys"], g["runs"] = [], None
            self.pinned.append(buf)
        size = max((g["runs"].nbytes for g in self.groups_ if g["runs"] is not None),
                   default=0)
        self.slots = [torch.empty(size, dtype=torch.uint8, device=device)
                      for _ in range(2 if size else 0)]
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        # the slots' memory may have served work still queued on the compute stream
        # (the caching allocator hands it out in that stream's order): the first copy
        # into each waits for everything queued there so far
        self.freed: List[Optional[torch.cuda.Event]] = [None, None]
        if self.cuda:
            start = torch.cuda.Event()
            start.record(torch.cuda.current_stream(device))
            self.freed = [start, start]
        self.turn = 0

    def _stage(self, g):
        """Start the copy of group g's streamed bytes into the next slot;
        (its modules, the event the compute must wait on)."""
        runs = g["runs"]
        if runs is None:
            return g["fixed"], None
        slot = self.turn % 2
        self.turn += 1
        if self.stats is not None:
            self.stats.bytes += sum(run.numel() for run, _ in runs.runs)
        if not self.cuda:
            mods = runs.copy_to(self.slots[slot])
            return g["fixed"] + [(k, i, m) for (k, i), m in zip(g["keys"], mods)], None
        with torch.cuda.stream(self.copy_stream):
            if self.freed[slot] is not None:
                self.copy_stream.wait_event(self.freed[slot])
            start = torch.cuda.Event(enable_timing=True) if self.stats is not None else None
            if start is not None:
                start.record(self.copy_stream)
            mods = runs.copy_to(self.slots[slot])
            ready = torch.cuda.Event(enable_timing=self.stats is not None)
            ready.record(self.copy_stream)
        if start is not None:
            self.stats._events.append((start, ready))
        g["slot"] = slot
        return g["fixed"] + [(k, i, m) for (k, i), m in zip(g["keys"], mods)], ready

    def groups(self):
        n = len(self.groups_)
        cur = self._stage(self.groups_[0]) if n else None
        for gi, g in enumerate(self.groups_):
            nxt = self._stage(self.groups_[gi + 1]) if gi + 1 < n else None
            mods, ready = cur
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            video = {i: m for k, i, m in mods if k == "v"}
            audio = {i: m for k, i, m in mods if k == "a"}
            conds = [{i: m for k, i, m in mods if k == c} for c in CONDITIONERS]
            yield g["layers"], video, audio, self.bridge.with_conditioners(*conds)
            if ready is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self.freed[g["slot"]] = done
            cur = nxt

    def close(self) -> None:
        """Free the ring and the pinned groups once the compute stream has
        passed every copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.copy_stream)
        for buf in self.slots + self.pinned:
            buf.untyped_storage().resize_(0)


def streamed_pass_multi(video, audio, stream: LayerStream, passes: List[Pass],
                        model_in: torch.Tensor, alat: torch.Tensor, t: torch.Tensor,
                        at: torch.Tensor, rope_pack, compute_dtype=torch.bfloat16,
                        attn_impl="auto") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Several forward passes over ONE staging sweep. `video` and `audio`:
    the towers' device copies without their blocks (or whole); each pass as
    in `sampler.resident_passes`. Returns [(v, a) fp32 per pass]."""
    pres, states = [], []
    for p in passes:
        mi, al, tt, att = ((torch.cat([model_in, model_in]), torch.cat([alat, alat]),
                            t.repeat(2), at.repeat(2)) if p.doubled
                           else (model_in, alat, t, at))
        pre = step_prologue(video, audio, mi, al, p.context, tt, att, compute_dtype)
        pres.append(pre)
        states.append([pre["visual_x"], pre["audio_x"]])
    for layers, vblocks, ablocks, bridge in stream.groups():
        for st, pre, p in zip(states, pres, passes):
            st[0], st[1] = forward_dual_tower(
                vblocks, ablocks, bridge, st[0], st[1], pre["visual_ctx"], pre["audio_ctx"],
                pre["v_t_mod"], pre["a_t_mod"], rope_pack["v"], rope_pack["a"],
                cross_rope=rope_pack.get("cross"), condition_scale=p.bridge_scale,
                attn_impl=attn_impl, ctx_valid_len=p.ctx_len, video_grid=pre["grid"],
                layers=layers)
    outs = []
    for st, pre in zip(states, pres):
        v, a = step_head(video, audio, pre, st[0], st[1])
        outs.append((v.float(), a.float()))
    return outs


def streamed_pass(video, audio, stream: LayerStream, model_in, alat, context, t, at,
                  rope_pack, compute_dtype=torch.bfloat16, attn_impl="auto",
                  condition_scale: Optional[float] = None, ctx_valid_len=None):
    """One forward pass over a staging sweep (`streamed_pass_multi`)."""
    return streamed_pass_multi(video, audio, stream,
                               [Pass(context, ctx_valid_len, condition_scale)], model_in,
                               alat, t, at, rope_pack, compute_dtype, attn_impl)[0]


def denoise_streamed(
    video, audio, bridge,                # host masters: the active expert, audio, bridge
    latents: torch.Tensor, condition: torch.Tensor, audio_latents: torch.Tensor,
    ctx_pos: torch.Tensor, ctx_neg: Optional[torch.Tensor], plan: SamplePlan,
    start: int, stop: int, *,
    group_size: int = 8, cfg_scale: float = 5.0, video_fps: float = 24.0,
    cfg_batch: bool = False, compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl="auto", rope_pack=None, cfg_cache_interval: int = 1,
    cfg_scale_bridge: float = 0.0, ctx_len_pos=None, ctx_len_neg=None, progress_fn=None,
    resident_small: bool = False, resident_video_groups: int = 0,
    neg_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_neg_cache: bool = False, stats: Optional[StreamStats] = None):
    """Steps [start, stop) on the latents' device with the active expert's
    blocks streamed from host memory in layer groups; the semantics are
    `sampler.denoise_steps`' (CFG, its negative cache, dual CFG, the Euler
    updates). `neg_cache` seeds the negative cache that an earlier range of
    the same expert returned (`return_neg_cache=True` adds it to the
    result), so a range split mid-phase gives the unsplit run's bits; a
    range starting at an expert switch passes None. `resident_small` stages
    the audio tower and the bridge whole for the range, so only the video
    groups stream; `resident_video_groups` keeps the first K groups on the
    device for the whole range. `stats`: a `StreamStats` to count into."""
    device = latents.device
    specs = plan_groups(bridge.cfg, len(video.blocks), group_size)
    if rope_pack is None:
        pt, ph, pw = video.cfg.patch_size
        grid = (latents.shape[2] // pt, latents.shape[3] // ph, latents.shape[4] // pw)
        rope_pack = make_rope_pack(video.cfg, audio.cfg, bridge.cfg, grid,
                                   audio_latents.shape[2] // audio.cfg.patch_size,
                                   video_fps, device)
    with contextlib.ExitStack() as stack:
        vper = stack.enter_context(off.staged(video, device, exclude=("blocks",)))
        if resident_small:
            aper = stack.enter_context(off.staged(audio, device))
            bper = stack.enter_context(off.staged(bridge, device))
            stream = LayerStream(specs, video, audio, bridge, device, aper, bper,
                                 resident_video_groups, stats)
        else:
            aper = stack.enter_context(off.staged(audio, device, exclude=("blocks",)))
            bper = stack.enter_context(off.staged(bridge, device, exclude=CONDITIONERS))
            stream = LayerStream(specs, video, audio, bper, device,
                                 pinned_groups=resident_video_groups, stats=stats)
        stack.callback(stream.close)

        def run(passes, model_in, alat, t, at):
            return streamed_pass_multi(vper, aper, stream, passes, model_in, alat, t, at,
                                       rope_pack, compute_dtype, attn_impl)

        lat, alat, neg = denoise_steps(
            run, latents, condition, audio_latents, ctx_pos, ctx_neg, plan, start, stop,
            cfg_scale=cfg_scale, cfg_batch=cfg_batch, cfg_cache_interval=cfg_cache_interval,
            cfg_scale_bridge=cfg_scale_bridge, progress_fn=progress_fn,
            ctx_len_pos=ctx_len_pos, ctx_len_neg=ctx_len_neg, neg_cache=neg_cache)
    return (lat, alat, neg) if return_neg_cache else (lat, alat)
