"""The `denoise` entry: the denoise steps of a text+image-to-video+audio
request, the part a clip pays 50 times.

Set-up makes the weights from the seed (`benchmark.weights`) and loads them
into the port's modules in the MOVA layout (fp8 storage through the port's
`nn.cast_modules_fp8` where the configuration stores the towers in fp8),
builds the port's plan (`diffusion.sampler.build_plan`) and RoPE tables,
makes a request's inputs from the seed (noise, condition latents with the
first-frame mask, text contexts, at the shapes `MOVAPipeline.prepare_state`
returns) and warms the shapes up with one step.

The window drives `diffusion.sampler.denoise_steps` over
`sampler.resident_passes`, the path `MOVAPipeline.denoise_state` takes for
resident modules, one step at a time along the plan from the traffic's
`start_step`, switching experts at the plan's boundary and starting the
next request from fresh seeded noise when the plan ends. With a cached CFG
negative (`cfg_cache_interval`), the window ends only after a whole cache
cycle, so the mix of one- and two-pass steps is the same whatever the
speed.

The check draws one of the window's steps from the seed (a reservoir over
the steps) and runs the plain fp32 reference (`benchmark.reference.mova`)
once the window has closed and the program's modules are freed, on the
weights drawn again from the seed and the step's input latents (the
program's state there; a cached negative is recomputed at the inputs of the
step that refreshed it). It works out, video by the worst latent frame
and audio whole, the gaps of the step's update (`video_gap`, `audio_gap`)
and of its two predictions: the negative pass's, which the step returns
(its CFG cache: `neg_*`), and the positive pass's, recovered from the
update and that negative (the update over the sigma step is v_neg + s
(v_pos - v_neg): `pos_*`), so a wrong combine or update shows in it. The
cell's file names those compared, each with its limit, beside the launch
counts against its plan. The update alone cannot tell a lower precision
from bf16's round-off: the combine 5 v_pos - 4 v_neg multiplies
round-off, which differs between the two passes, and cancels most of an
error of the weights, which the two passes share; one pass's prediction
shows each as it is.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List, Optional

import torch

from benchmark import counters, flops, weights
from benchmark.reference import layout
from benchmark.reference import mova as ref
from benchmark.reference import schedule

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def port_config(cfg: dict):
    """The port's `MOVAConfig` of a configuration file: its groups over the
    dataclasses' defaults."""
    import dataclasses

    from dualforce_tpu_torch.config import MOVAConfig

    kw = {}
    for f in dataclasses.fields(MOVAConfig):
        if f.name not in cfg:
            continue
        v = cfg[f.name]
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default):
            v = dataclasses.replace(default, **{k: tuple(x) if isinstance(x, list) else x
                                                for k, x in v.items()})
        kw[f.name] = v
    return MOVAConfig(**kw)


def port_modules(cfg: dict, tensors: Dict[str, Dict[str, torch.Tensor]], copy: bool,
                 control: Optional[str] = None) -> Dict[str, torch.nn.Module]:
    """The port's modules holding `tensors` (copies where `copy`), stored as
    the configuration says; `control`: a lower precision of the port's own,
    its fp8 weight storage ("fp8": `nn.cast_modules_fp8`, as
    `--weight_dtype fp8`) or its quantized linears ("int8", "int4":
    `nn.quantize_modules`, as `MOVAPipeline(quantize=...)`)."""
    from dualforce_tpu_torch import nn as dnn
    from dualforce_tpu_torch.models.audio_dit import AudioDiT
    from dualforce_tpu_torch.models.bridge import DualTowerBridge
    from dualforce_tpu_torch.models.video_dit import VideoDiT

    pc = port_config(cfg)
    classes = {"video_dit": (VideoDiT, pc.video_dit), "video_dit_2": (VideoDiT, pc.video_dit),
               "audio_dit": (AudioDiT, pc.audio_dit), "bridge": (DualTowerBridge, pc.bridge)}
    out = {}
    for name, sd in tensors.items():
        cls, sub = classes[name]
        with torch.device("meta"):
            module = cls(sub, dtype=torch.bfloat16)
        module.load_state_dict({k: v.clone() if copy else v for k, v in sd.items()},
                               strict=True, assign=True)
        module = module.eval().requires_grad_(False)
        if cfg["weight_dtype"] == "fp8" or control == "fp8":
            dnn.cast_modules_fp8(module)
        if control in ("int8", "int4"):
            module = dnn.quantize_modules(module, control)
        out[name] = module
    return out


class Denoise:
    """One run of a `denoise` cell: `setup`, `window`, `check`."""

    def __init__(self, cell, seed: int, device, control: Optional[str] = None):
        self.cell, self.seed, self.device, self.control = cell, int(seed), device, control
        self.cfg = dict(cell.config, video_fps=cell.traffic["video_fps"])
        self.tr = cell.traffic
        self.geo = flops.geometry(self.cfg, self.tr)
        self.rng = random.Random(self.seed)              # the window's draw
        self.host_rng = random.Random(f"inputs-{self.seed}")

    # --- set-up -----------------------------------------------------------------
    def setup(self) -> None:
        self.parts = {}
        mark = self._marker()
        from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
        from dualforce_tpu_torch.diffusion.sampler import build_plan, resident_passes
        from dualforce_tpu_torch.diffusion.step import make_rope_pack
        from dualforce_tpu_torch.models import audio_dit, bridge, video_dit  # noqa: F401

        tr, pc = self.tr, port_config(self.cfg)
        mark("port_import")
        tensors = weights.draw(layout.denoise_modules(self.cfg), self.seed, self.device)
        mark("weights")
        # fp8 storage keeps copies: the bf16 draws are freed once cast
        quantize = self.control or (tr["quantize"] if tr["quantize"] != "none" else None)
        self.modules = port_modules(self.cfg, tensors, copy=self.cfg["weight_dtype"] != "bf16"
                                    or quantize == "fp8", control=quantize)
        del tensors
        mark("modules")
        sched = FlowMatchPairScheduler(pc.scheduler)
        sched.set_timesteps(tr["num_inference_steps"], shift=tr["sigma_shift"])
        self.plan = build_plan(sched, pc.boundary_ratio)
        f, lh, lw = self.geo["latent"]
        pt, ph, pw = pc.video_dit.patch_size
        rope_pack = make_rope_pack(pc.video_dit, pc.audio_dit, pc.bridge,
                                   (f // pt, lh // ph, lw // pw), self.geo["audio"],
                                   tr["video_fps"], self.device)
        experts = ["video_dit", "video_dit_2"] if "video_dit_2" in self.modules else ["video_dit"]
        self.runs = [resident_passes(self.modules[e], self.modules["audio_dit"],
                                     self.modules["bridge"], tr["video_fps"],
                                     DTYPES[tr["compute_dtype"]], rope_pack, tr["attn_impl"])
                     for e in experts]
        self.input_gen = weights.generator(self.seed, self.device, 1)
        mark("plan")
        # warm-up: one step of its own request, at the window's first step
        self._start_request(tr["start_step"])
        self._step()
        mark("warmup")
        self._start_request(tr["start_step"])
        mark("inputs")

    def _marker(self):
        """mark(name): the seconds since the last mark (the device
        synchronised) recorded in `parts` under name."""
        last = [time.perf_counter()]

        def mark(name: str) -> None:
            self.sync()
            now = time.perf_counter()
            self.parts[name] = now - last[0]
            last[0] = now
        return mark

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _inputs(self) -> dict:
        """A request's denoise inputs, drawn on the device from the seed."""
        g, dev = self.input_gen, self.device
        f, lh, lw = self.geo["latent"]
        vc = self.cfg["video_dit"]
        cond_ch = vc["in_dim"] - 2 * vc["out_dim"]
        mask = torch.zeros((1, cond_ch, f, lh, lw), device=dev)
        mask[:, :, 0] = 1.0                  # the first frame is given
        cond = torch.randn((1, vc["out_dim"], f, lh, lw), generator=g, device=dev)
        ctx = []
        for lo, hi in (self.tr["prompt_tokens"], self.tr["negative_tokens"]):
            n = self.host_rng.randrange(lo, hi)
            c = torch.zeros((1, self.tr["text_tokens"], vc["text_dim"]), device=dev,
                            dtype=DTYPES[self.tr["compute_dtype"]])
            c[:, :n] = torch.randn((1, n, vc["text_dim"]), generator=g, device=dev).to(c.dtype)
            ctx.append(c)
        return {"lat": torch.randn((1, vc["out_dim"], f, lh, lw), generator=g, device=dev),
                "alat": torch.randn((1, self.cfg["audio_dit"]["in_dim"], self.geo["audio_t"]),
                                    generator=g, device=dev),
                "condition": torch.cat([mask, cond], dim=1), "ctx_pos": ctx[0],
                "ctx_neg": ctx[1] if self.tr["cfg_scale"] != 1.0 else None}

    def _start_request(self, step: int) -> None:
        self.req = self._inputs()
        self.lat, self.alat = self.req["lat"], self.req["alat"]
        self.i, self.neg, self.last_refresh = step, None, None

    def _refreshes(self, i: int) -> bool:
        """Whether step i runs the negative pass (the sampler's rule)."""
        if self.tr["cfg_scale"] == 1.0:
            return False
        k = self.tr["cfg_cache_interval"]
        return self.neg is None or k <= 1 or i % k == 0

    def _step(self) -> dict:
        """One step of the plan; returns what the check may need of it."""
        from dualforce_tpu_torch.diffusion import sampler

        i, plan = self.i, self.plan
        refresh = self._refreshes(i)
        before = {"step": i, "lat": self.lat, "alat": self.alat, "refresh": refresh,
                  "req": self.req}
        if refresh:
            self.last_refresh = (i, self.lat, self.alat)
        before["neg_src"] = self.last_refresh
        run = self.runs[0 if i < plan.boundary_step or len(self.runs) == 1 else 1]
        self.lat, self.alat, self.neg = sampler.denoise_steps(
            run, self.lat, self.req["condition"], self.alat, self.req["ctx_pos"],
            self.req["ctx_neg"], plan, i, i + 1, cfg_scale=self.tr["cfg_scale"],
            cfg_cache_interval=self.tr["cfg_cache_interval"], neg_cache=self.neg)
        before.update(lat_out=self.lat, alat_out=self.alat, neg_out=self.neg,
                      passes=1 + int(refresh))
        self.i = i + 1
        if self.i == plan.boundary_step:
            self.neg = None                  # each expert's phase starts its own cache
        if self.i == plan.num_steps:
            self._start_request(0)
        return before

    # --- the window ---------------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        """Steps for `seconds` (and to the end of a cache cycle); returns the
        end-to-end values and the window's counts."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        before = counters.read()
        steps = passes = 0
        self.sample = None
        t0 = time.perf_counter()
        while True:
            if tracer is not None:
                with tracer.span("benchmark.step"):
                    rec = self._step()
            else:
                rec = self._step()
            steps += 1
            passes += rec["passes"]
            if self.rng.random() * steps < 1.0:        # a uniform draw over the steps
                self.sample = rec
            if time.perf_counter() - t0 >= seconds and self._refreshes(self.i):
                break
        self.sync()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        self.launches = counters.since(before)
        self.steps, self.passes = steps, passes
        return {"denoise_step_s": wall / steps, "peak_mem_gib": peak / 2**30,
                "memory_peak_bytes": peak, "window_s": wall, "steps": steps, "passes": passes}

    def layer_records(self) -> dict:
        """What the per-layer readers take besides the trace."""
        calls = flops.kernel_calls(self.cfg, self.geo)
        bound_s = sum(flops.attention_fwd_bound(c)[0] for c in calls)
        return {"entry": "denoise", "steps": self.steps, "passes": self.passes,
                "model_flops": self.passes * flops.pass_flops(self.cfg, self.geo),
                "attn_fwd_bound_s": self.passes * bound_s,
                "peak_flops": flops.PEAK_BF16_FLOPS}

    # --- the check ------------------------------------------------------------------
    def free(self) -> None:
        """Drop the program's modules and state before the reference runs."""
        s = self.sample
        keep = {k: s[k] for k in ("step", "lat", "alat", "lat_out", "alat_out", "neg_out",
                                  "neg_src", "refresh")}
        keep["req"] = {k: v for k, v in s["req"].items()}
        self.sample = keep
        self.modules = self.runs = self.req = self.lat = self.alat = self.neg = None
        self.last_refresh = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[dict]:
        """[{name, value, limit}] of the compared numbers; the run is correct
        where every value is at most its limit."""
        limits = self.cell.spec["check"]["limits"]
        plan = self.cell.spec["launch_plan"]["per_pass"]
        launch_gap = sum(abs(self.launches.get(k, 0) - v * self.passes) for k, v in plan.items())
        gaps = self.readings = self.reference_gaps()
        return ([{"name": "launch_gap", "value": launch_gap, "limit": 0}]
                + [{"name": k, "value": gaps[k], "limit": limits[k]} for k in limits])

    @torch.no_grad()
    def reference_gaps(self) -> Dict[str, float]:
        with ref.no_tf32():
            return self._reference_gaps()

    def _reference_gaps(self) -> Dict[str, float]:
        s, tr, cfg = self.sample, self.tr, self.cfg
        tensors = weights.draw(layout.denoise_modules(cfg), self.seed, self.device)
        wf = ref.fp8_storage if cfg["weight_dtype"] == "fp8" else None
        timesteps, sigmas, boundary = schedule.plan(cfg, tr["num_inference_steps"],
                                                    tr["sigma_shift"], cfg["boundary_ratio"])
        i = s["step"]
        expert = "video_dit" if i < boundary or "video_dit_2" not in tensors else "video_dit_2"
        p = {m: ref.Params(m, tensors[m], wf) for m in tensors}
        neg_state = None
        if not s["refresh"] and tr["cfg_scale"] != 1.0:
            r, nl, na = s["neg_src"]
            neg_state = (nl[0].float(), na[0].float(), float(timesteps[r]), float(timesteps[r]))
        req = s["req"]
        ctx_neg = req["ctx_neg"][0].float() if req["ctx_neg"] is not None else None
        d_sigma = float(sigmas[i + 1] - sigmas[i])
        dv, da, neg, pos = ref.step_update(cfg, p[expert], p["audio_dit"], p["bridge"],
                                         s["lat"][0].float(), s["alat"][0].float(),
                                         req["condition"][0].float(), req["ctx_pos"][0].float(),
                                         ctx_neg, float(timesteps[i]), float(timesteps[i]),
                                         d_sigma, d_sigma, tr["cfg_scale"], neg_state)
        gaps = dict.fromkeys(("video_gap", "audio_gap", "pos_video_gap", "pos_audio_gap",
                              "neg_video_gap", "neg_audio_gap"), float("inf"))
        got_v = (s["lat_out"] - s["lat"])[0].float()
        got_a = (s["alat_out"] - s["alat"])[0].float()
        if not ref.isfinite(got_v, got_a):
            return gaps
        gaps.update(video_gap=ref.frame_gap(got_v, dv), audio_gap=ref.rel_l2(got_a, da))
        # the step's predictions from what it returned: its update over the
        # sigma step is v_neg + s (v_pos - v_neg), and v_neg its CFG cache
        got_v, got_a = got_v / d_sigma, got_a / d_sigma
        got_neg = s["neg_out"]
        if neg is None:
            gaps.update(neg_video_gap=0.0, neg_audio_gap=0.0)
        elif got_neg is None or not ref.isfinite(*got_neg):
            return gaps
        else:
            nv, na = (x[0].float() for x in got_neg)
            gaps.update(neg_video_gap=ref.frame_gap(nv, neg[0]),
                        neg_audio_gap=ref.rel_l2(na, neg[1]))
            got_v = nv + (got_v - nv) / tr["cfg_scale"]
            got_a = na + (got_a - na) / tr["cfg_scale"]
        gaps.update(pos_video_gap=ref.frame_gap(got_v, pos[0]),
                    pos_audio_gap=ref.rel_l2(got_a, pos[1]))
        return gaps



ENTRY = Denoise
