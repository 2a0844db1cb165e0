"""The `train` entry: LoRA fine-tuning steps of `LoRATrainer` on one card,
each a clip's frozen encodes (UMT5, the Wan VAE, the DAC), the LoRA-merged
loss and backward through the dual tower, and the optimizer.

Set-up makes every module's weights from the seed (`benchmark.weights`;
the towers and the bridge as in the `denoise` entry, UMT5 in bf16, the
VAEs' encoders in fp32, their decoders not built: an encode reads none of
them), builds one `LoRATrainer` with the traffic's trainer settings, puts
the benchmark's own LoRA factors from the seed into it and seeds its
generator, and drives it through its first steps with the window's own
call and feed (`LoRATrainer.train` over seeded clips, each different):
they are the warm-up, and the check's. The window hands the same trainer
the next clips until `--seconds` have passed.

The check follows those first steps with the plain fp32 reference
(`benchmark.reference.train`) once the program is freed, on the weights,
factors and clips drawn again from the seed: each step's loss, the first
step's gradients as the optimizer holds them (its first moment over
1 - beta1) and the factors' change over the steps, each by its worst leaf;
and the flash launches per step against the cell's plan.
"""

from __future__ import annotations

import gc
import math
import random
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import torch

from benchmark import counters, flops, weights
from benchmark.entries.denoise import DTYPES, port_config, port_modules
from benchmark.reference import layout
from benchmark.reference import mova as ref
from benchmark.reference import train as ref_train

ENCODERS = ("text_encoder", "video_vae", "audio_vae")
TOWERS = ("video_dit", "video_dit_2", "audio_dit", "bridge")
# the LoRA targets of MOVA's recipe: every q, k, v and o of the blocks' and
# the bridge's attentions
LORA_TARGET = re.compile(r"(self_attn|cross_attn|inner)\.(q|k|v|o)\.weight$")
# streams of `weights.generator` (0 and 1 are the weights' and the clips')
LORA_STREAM, DRAW_STREAM = 2, 3
# a leaf whose reference gradient or change is under this share of the
# median leaf's is left out of the comparison (round-off moves it)
NEGLIGIBLE = 1e-3


def port_encoders(cfg: dict, tensors: Dict[str, Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.nn.Module]:
    """The port's UMT5 (bf16) and VAEs (fp32) holding `tensors` (encoders
    only: the VAEs' decoders stay on the meta device, unread)."""
    from dualforce_tpu_torch.models.dac_vae import DACVAE
    from dualforce_tpu_torch.models.umt5 import UMT5Encoder
    from dualforce_tpu_torch.models.wan_vae import WanVAE

    pc = port_config(cfg)
    built = {"text_encoder": (UMT5Encoder, pc.text_encoder, torch.bfloat16),
             "video_vae": (WanVAE, pc.video_vae, torch.float32),
             "audio_vae": (DACVAE, pc.audio_vae, torch.float32)}
    out = {}
    for name, (cls, sub, dtype) in built.items():
        with torch.device("meta"):
            module = cls(sub, dtype=dtype)
        sd = {k: v.to(dtype) for k, v in tensors[name].items()}
        missing = module.load_state_dict(sd, strict=False, assign=True).missing_keys
        unread = [k for k in missing if not k.startswith(("decoder.", "post_quant_conv."))]
        if unread:
            raise ValueError(f"{name}: no weights drawn for {unread[:4]}")
        out[name] = module.eval().requires_grad_(False)
    return out


def lora_inputs(cfg: dict, seed: int, device, rank: int, b_scale: float
                ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """The benchmark's LoRA factors for every target of the towers and the
    bridge, fp32, drawn on the device from the seed in (module, name)
    order: a [in, r] normal / sqrt(in), b [r, out] normal * b_scale (a
    LoRA some way into its training, so every factor has a gradient)."""
    g = weights.generator(seed, device, LORA_STREAM)
    out = {}
    for module, shapes in sorted(layout.denoise_modules(cfg).items()):
        tree = {}
        for name in sorted(n for n in shapes if LORA_TARGET.search(n)):
            fan_out, fan_in = shapes[name]
            a = torch.randn((fan_in, rank), generator=g, device=device) / math.sqrt(fan_in)
            b = torch.randn((rank, fan_out), generator=g, device=device) * b_scale
            tree[name] = {"a": a, "b": b}
        out[module] = tree
    return out


def leaf_gaps(got: List[torch.Tensor], want: List[torch.Tensor]) -> torch.Tensor:
    """Each leaf's gap of norms, |‖got‖ - ‖want‖| over the larger of ‖want‖
    and the median leaf's ‖want‖; NaN for the leaves whose ‖want‖ is under
    NEGLIGIBLE of the median's, inf for all where got is not finite."""
    g = torch.stack([t.double().norm() for t in got]).cpu()
    w = torch.stack([t.double().norm() for t in want]).cpu()
    if not bool(torch.isfinite(g).all()):
        return torch.full_like(w, float("inf"))
    med = float(w.median())
    gaps = (g - w).abs() / w.clamp_min(med)
    return gaps.masked_fill(w < NEGLIGIBLE * med, float("nan"))


def worst_leaves(gaps: torch.Tensor, names: List[str], want: List[torch.Tensor],
                 count: int = 4) -> List[list]:
    """[name, gap, ‖want‖ over the median leaf's] of the `count` worst
    leaves: where a gap comes from, for the readings."""
    norms = torch.stack([t.double().norm() for t in want]).cpu()
    med = float(norms.median())
    order = torch.argsort(gaps.nan_to_num(-1.0), descending=True)[:count]
    return [[names[i], float(gaps[i]), float(norms[i]) / med] for i in order.tolist()]


class Train:
    """One run of a `train` cell: `setup`, `window`, `check`."""

    CHECKED_STEPS = 3

    def __init__(self, cell, seed: int, device, control: Optional[str] = None):
        self.cell, self.seed, self.device, self.control = cell, int(seed), device, control
        self.tr = cell.traffic
        self.cfg = dict(cell.config, video_fps=self.tr["video_fps"])
        self.geo = flops.geometry(self.cfg, self.tr)
        self.draw_seed = (self.seed * 4 + DRAW_STREAM) % (1 << 63)
        self.records: List[dict] = []

    # --- inputs -----------------------------------------------------------------
    def batch(self, k: int) -> dict:
        """Clip k of the run: video [1, T, H, W, 3] uniform in [-1, 1], 48 kHz
        audio [1, 1, S], caption ids of a seeded length, zero-padded to the
        text length, and their mask; drawn on the device, each clip its own."""
        tr, dev = self.tr, self.device
        g = torch.Generator(device=dev)
        g.manual_seed((self.seed * 1_000_003 + 7_919 * (k + 1)) % (1 << 63))
        samples = int(self.cfg["audio_vae"]["sample_rate"] * tr["num_frames"] / tr["video_fps"])
        n = random.Random(f"caption-{self.seed}-{k}").randrange(*tr["prompt_tokens"])
        ids = torch.zeros((1, tr["text_tokens"]), dtype=torch.long, device=dev)
        ids[:, :n] = torch.randint(1, self.cfg["text_encoder"]["vocab_size"], (1, n),
                                   generator=g, device=dev)
        mask = torch.zeros((1, tr["text_tokens"]), dtype=torch.long, device=dev)
        mask[:, :n] = 1
        video = torch.rand((1, tr["num_frames"], tr["height"], tr["width"], 3), generator=g,
                           device=dev).mul_(2).sub_(1)
        audio = torch.randn((1, 1, samples), generator=g, device=dev).mul_(0.1).clamp_(-1, 1)
        return {"video": video, "audio": audio, "text_ids": ids, "text_mask": mask}

    # --- set-up -----------------------------------------------------------------
    def setup(self) -> None:
        from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

        tr, cfg = self.tr, self.cfg
        tensors = weights.draw(layout.train_modules(cfg), self.seed, self.device)
        towers = {k: tensors.pop(k) for k in TOWERS if k in tensors}
        modules = port_modules(cfg, towers, copy=self.control == "fp8"
                               or cfg["weight_dtype"] != "bf16", control=self.control)
        modules.update(port_encoders(cfg, tensors))
        del tensors, towers
        self.save_dir = tempfile.mkdtemp(prefix="benchmark-train-")
        t = tr["trainer"]
        tcfg = TrainerConfig(lr=t["lr"], weight_decay=t["weight_decay"],
                             warmup_steps=t["warmup_steps"], max_steps=t["max_steps"],
                             lr_schedule=t["lr_schedule"], lora_rank=t["lora_rank"],
                             lora_alpha=t["lora_alpha"], log_interval=t["log_interval"],
                             save_interval=t["save_interval"], save_dir=self.save_dir,
                             logger="none", seed=self.draw_seed, video_fps=tr["video_fps"],
                             remat=t["remat"], compute_dtype=DTYPES[tr["compute_dtype"]],
                             attn_impl=tr["attn_impl"], optimizer=t["optimizer"])
        self.trainer = LoRATrainer(port_config(cfg), modules, tcfg, device=self.device)
        del modules
        self._put_lora()
        self.trainer.generator.manual_seed(self.draw_seed)
        self.first = {"loss": [], "exp_avg": None}
        self.trainer.train(self._feed(count=self.CHECKED_STEPS), on_micro_step=self._first)
        self.first["lora"] = [p.detach().clone() for p in self._factors()]
        self.sync()

    def _factors(self) -> List[torch.Tensor]:
        from dualforce_tpu_torch.engine.lora import lora_parameters

        return lora_parameters(self.trainer.lora)

    @torch.no_grad()
    def _put_lora(self) -> None:
        mine = lora_inputs(self.cfg, self.seed, self.device, self.tr["trainer"]["lora_rank"],
                           self.tr["lora_b_scale"])
        theirs = self.trainer.lora
        names = {m: set(t) for m, t in theirs.items() if t}
        if names != {m: set(t) for m, t in mine.items() if m in theirs}:
            raise ValueError("the trainer's LoRA targets are not MOVA's q, k, v and o")
        for m, tree in theirs.items():
            for name, ab in tree.items():
                for part in ("a", "b"):
                    ab[part].copy_(mine[m][name][part])

    def _first(self, record: dict) -> None:
        """The record of each of the first steps; after the first, the
        optimizer's first moments."""
        self.first["loss"].append(record["loss"])
        if len(self.first["loss"]) == 1:
            state = self.trainer.optimizer.opt.state
            self.first["exp_avg"] = [state[p]["exp_avg"].detach().clone() if p in state
                                     and "exp_avg" in state[p] else torch.zeros_like(p)
                                     for p in self._factors()]

    def _feed(self, count: Optional[int] = None, seconds: Optional[float] = None):
        """Clips for `count` steps, or for one step and then until `seconds`
        have passed since the feed began (checked as each step asks for its
        clip); the window's end is taken there, the device synchronised."""
        k, t0, n = getattr(self, "fed", 0), time.perf_counter(), 0
        while True:
            if count is not None and n >= count:
                break
            if seconds is not None and n and time.perf_counter() - t0 >= seconds:
                self.sync()
                self.window_end = time.perf_counter()
                self.window_peak = (torch.cuda.max_memory_allocated(self.device)
                                    if self.device.type == "cuda" else 0)
                break
            yield self.batch(k + n)
            n += 1
        self.fed = k + n

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- the window ---------------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        before, step0 = counters.read(), self.trainer.global_step
        self.window_start = time.perf_counter()
        self.trainer.train(self._feed(seconds=seconds),
                           on_micro_step=self.records.append if tracer is not None else None)
        steps = self.trainer.global_step - step0
        self.launches = counters.since(before)
        self.steps = steps
        wall = self.window_end - self.window_start
        peak = self.window_peak
        return {"train_step_s": wall / steps, "peak_mem_gib": peak / 2**30,
                "memory_peak_bytes": peak, "window_s": wall, "steps": steps}

    def layer_records(self) -> dict:
        calls = flops.kernel_calls(self.cfg, self.geo)
        rec = {"entry": "train", "steps": self.steps,
               "model_flops": self.steps * flops.train_step_flops(
                   self.cfg, self.geo, self.tr["trainer"]["lora_rank"]),
               "attn_bwd_bound_s": self.steps * sum(flops.attention_bwd_bound(c)[0]
                                                    for c in calls),
               "peak_flops": flops.PEAK_BF16_FLOPS}
        for key in ("encode_s", "loss_backward_s", "optimizer_s"):
            vals = [r[key] for r in self.records if key in r]
            if vals:
                rec[key] = sum(vals) / len(vals)
        return rec

    # --- the check ------------------------------------------------------------------
    def free(self) -> None:
        self.trainer = None
        shutil.rmtree(self.save_dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[dict]:
        limits = self.cell.spec["check"]["limits"]
        plan = self.cell.spec["launch_plan"]["per_step"]
        launch_gap = sum(abs(self.launches.get(k, 0) - v * self.steps) for k, v in plan.items())
        gaps = self.readings = self.reference_gaps()
        return ([{"name": "launch_gap", "value": launch_gap, "limit": 0}]
                + [{"name": k, "value": gaps[k], "limit": limits[k]}
                   for k in ("loss_gap", "grad_gap", "change_gap")])

    def reference_gaps(self) -> Dict[str, float]:
        with ref.no_tf32():
            return self._reference_gaps()

    def _reference_gaps(self) -> Dict[str, float]:
        cfg, t, dev = self.cfg, self.tr["trainer"], self.device
        tensors = weights.draw(layout.train_modules(cfg), self.seed, dev)
        enc_p = {m: ref.Params(m, tensors.pop(m)) for m in ENCODERS}
        # the clips' encodes first, so that the encoders' weights are let go
        # before the towers' backward
        encoded = [ref_train.encode(cfg, enc_p, self.batch(k)) for k in range(self.CHECKED_STEPS)]
        del enc_p
        lora = lora_inputs(cfg, self.seed, dev, t["lora_rank"], self.tr["lora_b_scale"])
        names = [f"{m}.{n}.{part}" for m in sorted(lora) for n in sorted(lora[m])
                 for part in ("a", "b")]
        leaves = [lora[m][n][part].requires_grad_() for m in sorted(lora)
                  for n in sorted(lora[m]) for part in ("a", "b")]
        start = [p.detach().clone() for p in leaves]
        opt = ref_train.AdamW(leaves, weight_decay=t["weight_decay"])
        gen = torch.Generator().manual_seed(self.draw_seed)
        timesteps, sigmas, boundary = ref_train.train_tables(cfg)
        losses, first = [], None
        for k, enc in enumerate(encoded):
            expert = k % 2 if "video_dit_2" in tensors else 0
            tid = ref_train.timestep_id(float(torch.rand((), generator=gen, dtype=torch.float64)),
                                        len(timesteps), boundary, expert)
            noise_v = torch.randn((1,) + tuple(enc["video"].shape), generator=gen)[0].to(dev)
            noise_a = torch.randn((1,) + tuple(enc["audio"].shape), generator=gen)[0].to(dev)
            tower = "video_dit" if expert == 0 else "video_dit_2"
            scale = t["lora_alpha"] / t["lora_rank"]
            p = {m: ref.LoraParams(m, tensors[m], lora[m], scale)
                 for m in (tower, "audio_dit", "bridge")}
            with torch.enable_grad():
                loss = ref_train.loss(cfg, p[tower], p["audio_dit"], p["bridge"], enc,
                                      float(timesteps[tid]), float(sigmas[tid]), noise_v, noise_a)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
            losses.append(float(loss.detach()))
            clipped = opt.step(grads, ref_train.lr_at(k, t["lr"], t["warmup_steps"],
                                                      t["max_steps"]))
            if k == 0:
                first = [g.detach().clone() for g in clipped]
            del loss, grads, clipped, p
        got_g = [m / (1 - opt.betas[0]) for m in self.first["exp_avg"]]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.first["loss"], losses))
        if not math.isfinite(loss_gap) or len(self.first["loss"]) != len(losses):
            loss_gap = float("inf")
        change_got = [p - s for p, s in zip(self.first["lora"], start)]
        change_want = [p.detach() - s for p, s in zip(leaves, start)]
        grad, change = leaf_gaps(got_g, first), leaf_gaps(change_got, change_want)
        return {"loss_gap": loss_gap, "grad_gap": float(grad.nanquantile(1.0)),
                "change_gap": float(change.nanquantile(1.0)),
                # not compared: the median leaf's gaps and where the worst come from
                "grad_gap_median": float(grad.nanmedian()),
                "change_gap_median": float(change.nanmedian()),
                "losses": losses, "grad_worst": worst_leaves(grad, names, first),
                "change_worst": worst_leaves(change, names, change_want)}


ENTRY = Train
