"""LoRA and full fine-tuning trainer (counterpart of
`dualforce_tpu/engine/trainer.py`).

One device, or a (data, fsdp, cp) mesh of processes (`mesh`). Loop: frozen
encodes, grads through the (rematerialised) dual tower, gradient
accumulation as a running mean, then the optimizer (any name of the
registry, `engine.optim.OPTIMIZERS`: "AdamW" by default, "AdamW8bit" with
block-wise int8 moments, or one of optax's families; one that rejects
`betas` is built again without them, as the JAX trainer does) under the
warmup schedule; log every `log_interval` steps,
save every `save_interval` and at the end, resume from the latest `step-N`
under `save_dir`. Randomness (LoRA init, timestep ids, noise) comes from one
host `torch.Generator` seeded with `seed`, saved and restored with the
checkpoint. What trains and the optimizer state live on the device.

Two modes, as in the JAX package:
- `mode="lora"`: LoRA factors over the frozen modules.
- `mode="full"`: the `trainable_modules` present (of video_dit,
  video_dit_2, audio_dit, bridge) train in place, the rest stay frozen.
  Without accumulation a step holds the video expert it does not run
  (`diffusion.training.full_ft_step`: its weights and optimizer state stay,
  the count advances); with accumulation both experts collect grads within
  a step and none is held. `step-N/` holds the per-module export
  (`convert.load_checkpoint.export_trained_modules`), from which a resume
  reads the weights back, and `state.pt` with the optimizer and the
  generator. Refused under `offload="component"`, as JAX refuses it.

Two regimes, as in the JAX package:
- `offload="none"`: the modules stay on the device; the video expert
  alternates per micro-batch (expert 0, the high-noise tower, on even
  micro-steps), so with accumulation both experts collect grads within one
  optimizer step.
- `offload="component"`, the one-card low-resource recipe
  (`configs/training/lora_low_resource.py`): the modules wait in page-locked
  host memory (`offload.to_host`, fp8-stored or not) and are staged to the
  device (`offload.staged`) for the phase that uses them: the text encoder
  and both VAEs around each encode, then the active expert, the audio tower
  and the bridge for the loss and backward, kept there across micro-steps
  until the expert changes; the other expert is evicted first, so the two
  are never on the device together. The expert follows
  `(global_step // expert_switch_interval) % 2` for whole optimizer steps.

Base weights stored in fp8 train in both regimes: the LoRA merges into the
compute dtype (ROADMAP C, caveat 9). `remat_save_attention` keeps the flash
forward's outputs across each layer's remat boundary
(`ops.flash_attention.remat_save_attention`), set around each loss and
backward.

Under a mesh (`mesh`, `parallel.mesh.create_mesh`; one process per rank
under torchrun), as the JAX trainer's: the raw batch is split over `data`,
each rank encodes its part and the encodes are gathered back, so every
rank holds the whole encoded batch and draws the same timestep and noise
from the one generator; the blocks run over the mesh
(`diffusion.training`'s `sp_mesh`: the sequence over `cp`, each layer's
weights gathered from their `fsdp` shards), and the gradients, summed over
the ranks, are the one-process ones. With fsdp > 1 the tower blocks and the
bridge conditioners are sharded (`parallel.sharding.shard_params`), and
under `mode="full"` their shards train (the optimizer updates each rank's
slice, `engine.optim`'s `shards`). LoRA factors stay whole on every rank
(JAX shards them: a difference in memory only). Rank 0 alone logs and
writes `step-N/` (sharded trained weights gathered whole for the export);
a rank whose optimizer state is its own (fsdp shards) writes
`state.rank<r>.pt` beside it, and every rank resumes. Component offload is
refused with a mesh, as the JAX trainer refuses it.

Clips of any length train; at 720p (1280x720, 193 frames, 176,400 video
tokens) the attention backwards take the split kernels, and an 80 GB card
holds the step only when PyTorch's allocator may reuse freed memory for any
size (`PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`, set before the
first CUDA allocation).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from dualforce_tpu_torch import offload as off
from dualforce_tpu_torch import resolve_device
from dualforce_tpu_torch.config import MOVAConfig
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.convert.lora_export import save_reference_lora
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.diffusion.step import make_rope_pack
from dualforce_tpu_torch.diffusion.training import (TimestepConfig, accumulate,
                                                    build_train_tables, encode_batch,
                                                    full_ft_grads, held_expert, lora_grads,
                                                    trainable_parameters)
from dualforce_tpu_torch.engine import lora as lora_mod
from dualforce_tpu_torch.engine.checkpoint import (latest_step, restore_checkpoint,
                                                   save_checkpoint)
from dualforce_tpu_torch.engine.logging import build_logger
from dualforce_tpu_torch.engine.optim import build_optimizer, warmup_schedule
from dualforce_tpu_torch.nn import FP8_DTYPES
from dualforce_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_bwd_preprocess,
                                                     remat_save_attention)
from dualforce_tpu_torch.parallel import mesh as pm
from dualforce_tpu_torch.parallel import sharding


COMPONENT_MESH_REFUSAL = ("offload='component' is the single-chip low-resource regime; use "
                          "the fsdp mesh axis to shard across chips instead")


@dataclass
class TrainerConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-2
    betas: tuple = (0.9, 0.999)
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    max_steps: int = 1000
    lr_schedule: str = "cosine"
    lora_rank: int = 16
    lora_alpha: float = 16.0
    log_interval: int = 10
    save_interval: int = 500
    save_dir: str = "./checkpoints"
    logger: str = "tensorboard"
    seed: int = 0
    video_fps: float = 24.0
    remat: bool = True
    # with remat: keep the flash forward's outputs across the remat boundary
    # instead of running the forward kernel again in the backward
    remat_save_attention: bool = False
    compute_dtype: Any = torch.bfloat16
    attn_impl: str = "auto"
    optimizer: str = "AdamW"   # a name of engine.optim.OPTIMIZERS
    # "lora" or "full" (whole modules of `trainable_modules` train)
    mode: str = "lora"
    trainable_modules: tuple = ("video_dit", "video_dit_2", "audio_dit", "bridge")
    # k micro-batches per optimizer step
    grad_accum_steps: int = 1
    # "none" or "component" (host-staged base weights, see the module docstring)
    offload: str = "none"
    # with offload: the expert changes every K optimizer steps
    expert_switch_interval: int = 1
    weighting_scheme: str = "uniform"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.0


class LoRATrainer:
    def __init__(self, cfg: MOVAConfig, modules: Dict[str, torch.nn.Module],
                 tcfg: TrainerConfig, device="cuda", mesh=None):
        """modules: the pipeline's modules (the encoders, the towers, the
        bridge), on `device` (offload "none") or in host memory (offload
        "component"; page-locked for a CUDA device); they stay frozen, but
        for the trainable ones under `mode="full"`, which train in place.
        mesh: a (data, fsdp, cp) `DeviceMesh` over this process's world (the
        module docstring); with fsdp > 1 this rank keeps its shards of the
        blocks of modules given whole (or already sharded over the mesh)."""
        if tcfg.mode not in ("lora", "full"):
            raise ValueError(f"unknown trainer mode {tcfg.mode!r}")
        if tcfg.offload not in ("none", "component"):
            raise ValueError(f"unknown trainer offload {tcfg.offload!r}")
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        if tcfg.offload == "component" and self.mesh is not None:
            raise ValueError(COMPONENT_MESH_REFUSAL)
        if tcfg.offload == "component" and tcfg.mode == "full":
            raise ValueError("offload='component' trains LoRA only (full-FT params must be "
                             "device-resident for the optimizer)")
        self.device = resolve_device(device)
        home = self.device.type if tcfg.offload == "none" else "cpu"
        for name, m in modules.items():
            p = next(m.parameters())
            if p.device.type != home:
                raise ValueError(f"{name} is on {p.device}; offload {tcfg.offload!r} wants "
                                 f"it on {home}")
        self.cfg = cfg
        self.modules = modules
        self.tcfg = tcfg
        self.is_main = pm.rank() == 0
        scheduler = FlowMatchPairScheduler(cfg.scheduler)
        scheduler.set_timesteps(cfg.scheduler.num_train_timesteps, training=True)
        self.tables = build_train_tables(scheduler, cfg.boundary_ratio)
        self.generator = torch.Generator().manual_seed(tcfg.seed)
        if tcfg.mode == "full":
            other = sorted(set(tcfg.trainable_modules) - set(lc.DIFFUSION_MODULES))
            if other:
                raise ValueError(f"full fine-tuning trains {lc.DIFFUSION_MODULES}, not {other}")
            # the LoRA mode's state stays None: full fine-tuning's is the modules
            self.lora = None
            self.trainable = {m: modules[m] for m in tcfg.trainable_modules if m in modules}
            if any(p.dtype in FP8_DTYPES for p in trainable_parameters(self.trainable)):
                raise ValueError("full fine-tuning trains the modules' own weights, which "
                                 "must not be stored in fp8")
            for module in self.trainable.values():
                module.requires_grad_(True)
        else:
            self.trainable = {}
            # drawn in the whole weights' shapes, given whole or in shards
            self.lora = lora_mod.init_pipeline_lora(modules, tcfg.lora_rank, self.generator,
                                                    tcfg.trainable_modules,
                                                    device=self.device,
                                                    shapes=sharding.whole_shapes(modules))
        if self.mesh is not None:
            sharding.shard_params(modules, self.mesh)
        if self.lora is None:
            params = trainable_parameters(self.trainable)
            self.shards = sharding.shards_of(self.trainable, params)
        else:
            params = lora_mod.lora_parameters(self.lora)
            self.shards = [None] * len(params)
        self._schedule = warmup_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.max_steps,
                                         tcfg.lr_schedule)
        opt_kwargs = dict(lr=tcfg.lr, betas=tcfg.betas, weight_decay=tcfg.weight_decay,
                          max_grad_norm=tcfg.max_grad_norm, schedule=self._schedule)
        if any(s is not None for s in self.shards):
            opt_kwargs["shards"] = self.shards
        try:
            self.optimizer = build_optimizer(tcfg.optimizer, params, **opt_kwargs)
        except TypeError:
            # SGD, RMSprop, Adagrad, Adadelta, Adafactor reject `betas`
            opt_kwargs.pop("betas")
            self.optimizer = build_optimizer(tcfg.optimizer, params, **opt_kwargs)
        self.timestep_config = TimestepConfig(tcfg.weighting_scheme, tcfg.logit_mean,
                                              tcfg.logit_std, tcfg.mode_scale)
        self.global_step = 0
        self.logger = build_logger(tcfg.logger, tcfg.save_dir, self.is_main)
        self._rope_cache: Dict[Any, Any] = {}
        # offload: {name: (the ExitStack holding its staging, the staged copy)}
        self._staged: Dict[str, Any] = {}
        self._measure = False
        self._stage_s = 0.0
        self._maybe_resume()

    # --- checkpointing ------------------------------------------------------
    def _state(self):
        state = {"optimizer": self.optimizer.state_dict(),
                 "generator": self.generator.get_state()}
        if self.lora is not None:
            state["lora"] = self.lora
        return state

    def _own_state(self) -> bool:
        """True on a rank whose optimizer state is its own: fsdp shards train."""
        return any(s is not None for s in self.shards)

    def _state_name(self) -> str:
        return f"state.rank{pm.rank()}.pt" if self._own_state() and pm.rank() else "state.pt"

    def _maybe_resume(self):
        step = latest_step(self.tcfg.save_dir)
        if step is None:
            return
        state, meta = restore_checkpoint(self.tcfg.save_dir, step, map_location=self.device,
                                         name=self._state_name())
        with torch.no_grad():
            if self.lora is None:
                step_dir = os.path.join(os.path.abspath(self.tcfg.save_dir), f"step-{step}")
                params = trainable_parameters(self.trainable)
                shards = dict(zip(map(id, params), self.shards))
                for name, module in self.trainable.items():
                    sd = lc.load_state_dict(os.path.join(step_dir, lc.MODULES[name][0]))
                    for key, p in module.named_parameters():
                        whole, shard = sd[key], shards[id(p)]
                        if shard is not None:       # this rank's slice of the export
                            n = whole.shape[shard.dim] // pm.axis_size(shard.axis)
                            whole = whole.narrow(shard.dim, pm.axis_index(shard.axis) * n, n)
                        p.copy_(whole)
            for mod, tree in (self.lora or {}).items():
                for name, ab in tree.items():
                    for part, t in ab.items():
                        t.copy_(state["lora"][mod][name][part])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())
        self.global_step = meta["global_step"]
        if self.is_main:
            print(f"[trainer] resumed from step {self.global_step}")

    def save(self):
        """`step-N/`: the LoRA in the JAX package's format (`lora_weights.npz`,
        `.json`) and in the reference trainer's (`lora_weights.pt`,
        `lora_config.pt`), or under `mode="full"` each trained module's
        HF-layout directory; then the resumable state (`state.pt`, and
        `meta.json`, written last, which marks the directory complete)."""
        t = self.tcfg
        path = os.path.join(os.path.abspath(t.save_dir), f"step-{self.global_step}")
        if self.lora is None:
            for name, module in self.trainable.items():
                with self._whole(module):
                    if self.is_main:
                        lc.export_trained_modules({name: module}, self.cfg, path)
        elif self.is_main:
            lora_mod.save_lora(self.lora, f"{path}/lora_weights.npz", alpha=t.lora_alpha,
                               rank=t.lora_rank)
            save_reference_lora(self.lora, path, alpha=t.lora_alpha, rank=t.lora_rank)
        if self._own_state() and not self.is_main:
            save_checkpoint(t.save_dir, self.global_step, self._state(), self._state_name(),
                            complete=False)
        pm.barrier()      # every rank's files are written before rank 0 completes the step
        if self.is_main:
            save_checkpoint(t.save_dir, self.global_step, self._state())
        pm.barrier()

    @contextlib.contextmanager
    def _whole(self, module: torch.nn.Module):
        """`module` with its fsdp shards gathered whole on every rank for the
        body (a collective), the shards put back after."""
        holder = getattr(module, "blocks", module)
        dims = getattr(holder, "fsdp_dims", {}) if self.mesh is not None else {}
        if not dims:
            yield
            return
        names = list(dims)
        shards = [holder.get_parameter(n).data for n in names]
        with torch.no_grad():
            whole = pm.all_gather_many(shards, [dims[n] for n in names], holder.fsdp_axis)
        try:
            for n, w in zip(names, whole):
                holder.get_parameter(n).data = w
            yield
        finally:
            for n, sh in zip(names, shards):
                holder.get_parameter(n).data = sh

    # --- component staging (offload "component") ---------------------------
    def _stage(self, *names: str) -> Dict[str, torch.nn.Module]:
        """The modules with `names` on the device: the resident modules, or
        (offload "component") staged copies, made on first use and kept
        until `_evict`."""
        if self.tcfg.offload == "none":
            return {n: self.modules[n] for n in names if n in self.modules}
        for n in names:
            if n in self.modules and n not in self._staged:
                if self._measure and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                stack = contextlib.ExitStack()
                self._staged[n] = (stack, stack.enter_context(
                    off.staged(self.modules[n], self.device)))
                if self._measure and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._stage_s += time.perf_counter() - t0
        return {n: self._staged[n][1] for n in names if n in self._staged}

    def _evict(self, *names: str) -> None:
        """Free the staged copies of `names` (all when none are named)."""
        for n in names or list(self._staged):
            entry = self._staged.pop(n, None)
            if entry is not None:
                entry[0].close()

    # --- one micro-step -----------------------------------------------------
    def _rope_pack(self, encoded):
        """RoPE tables per geometry, built once: clips share one geometry."""
        vl = encoded["video_latents"]
        pt, ph, pw = self.cfg.video_dit.patch_size
        grid = (vl.shape[2] // pt, vl.shape[3] // ph, vl.shape[4] // pw)
        f = encoded["audio_latents"].shape[2] // self.cfg.audio_dit.patch_size
        key = (grid, f)
        if key not in self._rope_cache:
            self._rope_cache[key] = make_rope_pack(
                self.cfg.video_dit, self.cfg.audio_dit, self.cfg.bridge, grid, f,
                self.tcfg.video_fps, self.device)
        return self._rope_cache[key]

    _ENCODERS = ("text_encoder", "video_vae", "audio_vae")

    def _encode(self, batch):
        """The whole batch's encodes. Under a mesh whose data axis divides
        the batch each rank encodes its part (`sharding.shard_batch`, as the
        JAX trainer shards it) and the parts are gathered back."""
        data = pm.mesh_shape(self.mesh).get("data", 1)
        split = data > 1 and len(batch["text_ids"]) % data == 0
        if split:
            batch = sharding.shard_batch(batch, self.mesh)
        try:
            encoded = encode_batch(self._stage(*self._ENCODERS), self.cfg, batch,
                                   compute_dtype=self.tcfg.compute_dtype, device=self.device)
        finally:
            self._evict(*self._ENCODERS)
        if split:
            axis = pm.MeshAxis(self.mesh, "data")
            encoded = dict(zip(encoded, pm.all_gather_many(list(encoded.values()),
                                                           [0] * len(encoded), axis)))
        return encoded

    def _grads(self, encoded, expert: int, **loss_kw):
        """One micro-batch's (grads, metrics); `loss_kw` goes to the loss
        (`timestep_id` and `noise_override` pin its draws)."""
        t = self.tcfg
        tower = "video_dit" if expert == 0 else "video_dit_2"
        if t.offload == "component":
            # the other expert leaves first: the two are never staged together
            self._evict("video_dit_2" if expert == 0 else "video_dit")
        modules = self._stage(tower, "audio_dit", "bridge")
        kwargs = dict(video_fps=t.video_fps, compute_dtype=t.compute_dtype, remat=t.remat,
                      attn_impl=t.attn_impl, rope_pack=self._rope_pack(encoded),
                      timestep_config=self.timestep_config, device=self.device,
                      sp_mesh=self.mesh, **loss_kw)
        prev = remat_save_attention(t.remat_save_attention)
        try:
            if self.lora is None:
                return full_ft_grads(self.trainable, modules, self.cfg, self.tables, encoded,
                                     self.generator, expert, **kwargs)
            return lora_grads(self.lora, modules, self.cfg, self.tables, encoded,
                              self.generator, expert, lora_alpha=t.lora_alpha, **kwargs)
        finally:
            remat_save_attention(prev)

    def _apply(self, grads, frozen=None):
        return self.optimizer.step(grads, frozen=frozen)

    def _timed(self, measure: bool, fn, *args):
        """fn(*args) and its seconds; with `measure`, the device is
        synchronised before and after, so the seconds are its work's."""
        if measure and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if measure and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - t0

    # --- training loop ------------------------------------------------------
    def train(self, data_iter: Iterable[Dict[str, Any]],
              on_micro_step: Optional[Callable[[Dict[str, float]], None]] = None) -> int:
        """Train until `max_steps`; returns the global step.

        `on_micro_step`, if given, is called after each micro-batch with a
        record of it: `expert`; `encode_s`, `loss_backward_s` and
        `optimizer_s` (0 when the micro-batch ends no optimizer step), each
        timed with the device synchronised around it, and `stage_s`, the
        seconds of that spent staging modules (offload "component"; the
        other three exclude it); `flash_fwd`, `flash_bwd`, `flash_bwd_split`
        and `flash_bwd_preprocess`, the flash kernel launches of its loss and
        backward (forward, fused backward, split backward, the backwards'
        delta preprocess); its loss metrics as floats; and `grad_norm` when
        it ends a step. Under a mesh, also the bytes this rank sent and the
        seconds it spent in collectives, in the forward
        (`collective_fwd_bytes`, `collective_fwd_s`, the encodes' gather
        apart) and in the backward with the gradients' reduction
        (`collective_bwd_bytes`, `collective_bwd_s`). The synchronisation
        makes a measured run slower: pass it only to measure.
        """
        self._measure = on_micro_step is not None
        try:
            return self._train(data_iter, on_micro_step)
        finally:
            self._evict()
            self._measure = False

    def _train(self, data_iter, on_micro_step) -> int:
        measure = self._measure
        t0 = time.time()
        accum = max(self.tcfg.grad_accum_steps, 1)
        period = max(self.tcfg.expert_switch_interval, 1)
        grad_acc, micro = None, 0
        for batch in data_iter:
            if self.global_step >= self.tcfg.max_steps:
                break
            if self.tcfg.offload == "component":
                # one expert for whole optimizer steps, so a staging serves
                # expert_switch_interval of them
                expert = (self.global_step // period) % 2
            else:
                # per micro-batch: with accumulation both experts collect
                # grads within one window
                expert = (self.global_step * accum + micro) % 2
            if "video_dit_2" not in self.modules:
                expert = 0
            self._stage_s = 0.0
            encoded, encode_s = self._timed(measure, self._encode, batch)
            encode_stage_s = self._stage_s
            fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
            split, prep = flash_attention_bwd.split_launches, flash_bwd_preprocess.launches
            b0, s0 = pm.TRANSFER["bytes"], pm.TRANSFER["seconds"]
            (grads, metrics), grads_s = self._timed(measure, self._grads, encoded, expert)
            stage_s = self._stage_s
            record = {"expert": expert, "encode_s": encode_s - encode_stage_s,
                      "loss_backward_s": grads_s - (stage_s - encode_stage_s),
                      "stage_s": stage_s, "optimizer_s": 0.0,
                      "flash_fwd": flash_attention.launches - fwd,
                      "flash_bwd": flash_attention_bwd.launches - bwd,
                      "flash_bwd_split": flash_attention_bwd.split_launches - split,
                      "flash_bwd_preprocess": flash_bwd_preprocess.launches - prep}
            if self.mesh is not None:
                record["collective_fwd_bytes"] = (pm.TRANSFER["bytes"] - b0
                                                  - float(metrics["collective_bwd_bytes"]))
                record["collective_fwd_s"] = (pm.TRANSFER["seconds"] - s0
                                              - float(metrics["collective_bwd_s"]))
            if accum > 1:
                grad_acc = accumulate(grad_acc, grads, accum)
                micro += 1
                if micro < accum:
                    if measure:
                        on_micro_step({**record, **{k: float(v) for k, v in metrics.items()}})
                    continue
                grads, grad_acc, micro = grad_acc, None, 0
                frozen = None
            else:
                # full fine-tuning holds the expert this step does not run
                frozen = held_expert(self.trainable, expert) if self.lora is None else None
            grad_norm, record["optimizer_s"] = self._timed(measure, self._apply, grads, frozen)
            metrics = {**metrics, "grad_norm": grad_norm}
            if measure:
                on_micro_step({**record, **{k: float(v) for k, v in metrics.items()}})
            self.global_step += 1

            if self.global_step % self.tcfg.log_interval == 0 and self.is_main:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = float(self._schedule(self.global_step))
                m["step_time"] = (time.time() - t0) / self.tcfg.log_interval
                t0 = time.time()
                self.logger.log_scalars(m, self.global_step)
            if self.global_step % self.tcfg.save_interval == 0:
                self.save()
        self.save()
        return self.global_step
