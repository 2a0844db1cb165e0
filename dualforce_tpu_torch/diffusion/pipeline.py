"""MOVA TI2VA inference pipeline (counterpart of `dualforce_tpu/diffusion/pipeline.py`).

Prompt clean -> UMT5 encode (padded to 512) -> video latents (streaming Wan
VAE encode of the first frame + 4-channel temporal mask) -> audio latents ->
paired flow-match denoise with the two-expert switch and text CFG -> bf16
streaming Wan VAE decode and fp32 DAC decode. Weights stay resident on the
device (offload "none"), wait in host memory and reach the card for the
phase that uses them (offload "component"), or besides stream the active
expert through the card in layer groups in every pass (offload "group",
`diffusion/streamed.py`); attention takes the route
`attn_impl` names; the DiT towers and the bridge may be quantized
(`quantize`); the tokenizer is passed in. With a (data, fsdp, cp) `mesh`
every rank runs the pipeline: the encodes and the decode whole, the blocks
of each pass over the mesh (`diffusion/sampler.resident_passes(sp_mesh=...)`).
"""

from __future__ import annotations

import contextlib
import html
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch import offload as off
from dualforce_tpu_torch import resolve_device
from dualforce_tpu_torch.config import MOVAConfig
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.diffusion.sampler import build_plan, denoise_range
from dualforce_tpu_torch.diffusion.step import make_rope_pack
from dualforce_tpu_torch.diffusion.streamed import denoise_streamed
from dualforce_tpu_torch.models import dac_vae, umt5, wan_vae
from dualforce_tpu_torch.ops.attention import ATTN_IMPLS
from dualforce_tpu_torch.parallel.mesh import mesh_shape

QUANTIZE_MODES = ("none", "int8", "int4")
QUANTIZED_TOWERS = ("video_dit", "video_dit_2", "audio_dit", "bridge")


def basic_clean(text: str) -> str:
    """`ftfy.fix_text` where ftfy is installed (optional), then HTML entities
    unescaped twice, then outer whitespace stripped."""
    try:
        import ftfy
    except ImportError:
        pass
    else:
        text = ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def prompt_clean(text: str) -> str:
    return re.sub(r"\s+", " ", basic_clean(text)).strip()


def _to_device(x, device) -> torch.Tensor:
    """A state array (numpy, possibly read-only, or a tensor) on `device`."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


@dataclass
class GenerationResult:
    video: np.ndarray   # [T, H, W, 3] uint8
    audio: np.ndarray   # [S] float32 in [-1, 1]
    sample_rate: int
    fps: float


class MOVAPipeline:
    """Holds the modules and configs; drives tokenisation, encode, denoise and
    decode. modules: video_dit, video_dit_2 (optional), audio_dit, bridge,
    video_vae, audio_vae, text_encoder, all on `device` (offload "none") or
    all in host memory (offload "component" or "group")."""

    def __init__(self, cfg: MOVAConfig, modules: Dict[str, torch.nn.Module],
                 tokenizer=None, compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda", attn_impl="auto", quantize: str = "none",
                 offload: str = "none", mask_ctx_pad: bool = False,
                 offload_group_size: int = 8, offload_resident_small: bool = False,
                 offload_resident_video_groups: int = 0, mesh=None):
        """attn_impl: "auto" | "fast" | "sage" | "pallas" | "ref" | a callable,
        the route of every attention (`ops.attention.attention`).

        quantize: "none", "int8" or "int4". "int8" serves the DiT towers'
        and the bridge's projection linears as w8a8 (`nn.Int8Linear`: int8
        weights with per-channel scales, per-token activation scales);
        "int4" as packed int4 weights dequantised at use (`nn.Int4Linear`).
        Lossy and inference only, like attn_impl "sage"; they compose. The
        VAEs, UMT5, norms, modulation, embeddings and heads stay as given.
        The modules passed in are not changed: the quantized towers are new
        modules (`nn.quantize_modules`) that share their other parameters
        with them. Towers stored in fp8 (`nn.cast_modules_fp8`) quantize from
        their fp8 weights, as the JAX package's do.

        offload: "none" (the weights stay resident on the device) or
        "component": the modules stay in host memory, page-locked ones
        (`offload.to_host`) staging at the link's full rate, and each is
        staged to the device for its phase and freed after it: the video VAE
        then UMT5 while preparing, the audio tower and the bridge for the
        whole denoise with each video expert for its own steps (the two
        experts are never on the device together), both VAEs for the decode.
        With `quantize`, each tower is staged, quantized on the device and
        moved back to host memory before the next one. "group": as
        "component", but the denoise stages only what the towers hold
        besides their blocks, and each pass streams the active expert's
        blocks, the audio tower's and the bridge's conditioners through the
        card `offload_group_size` layers at a time, two groups in flight
        (`diffusion/streamed.py`); `offload_resident_small` keeps the audio
        tower and the bridge on the card for each expert's phase instead, so
        only the video groups stream, and `offload_resident_video_groups`
        keeps the first K video groups there. Modules in pageable memory
        (the disk-backed store's memmaps, `convert/disk_store.py`) stage
        from it as they are.

        mask_ctx_pad: the text cross-attentions attend only each prompt's
        tokens (the per-batch kv mask) instead of the zero-padded 512, as
        the JAX package's opt-in flag; off by default, as the reference.

        mesh: a (data, fsdp, cp) `DeviceMesh` (`parallel.mesh.create_mesh`)
        this process is a rank of, the modules' block weights already
        sharded by `parallel.sharding.shard_params` where fsdp > 1. Every
        rank must build the pipeline and make the same calls with the same
        arguments: each draws the same noise from the same seeds, encodes
        and decodes whole, and runs each pass's blocks over the mesh
        (sequence chunks on cp, the batch on data where it divides, weights
        gathered per layer on fsdp). Group offload is refused on a mesh of
        more than one rank (the JAX package refuses it on a cp mesh; the
        streamed groups would carry fsdp shards), and quantized towers on
        an fsdp one."""
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if not callable(attn_impl) and attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if offload not in ("none", "component", "group"):
            raise ValueError(f"unknown offload mode {offload!r}")
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        if offload == "group" and self.mesh is not None:
            raise ValueError("offload='group' is a single-chip escape hatch; use cp/fsdp "
                             "sharding instead of offload on a multi-chip mesh")
        if quantize != "none" and mesh_shape(mesh).get("fsdp", 1) > 1:
            raise ValueError("quantized towers under fsdp sharding are not ported "
                             "(ROADMAP A7c)")
        self.device = resolve_device(device)
        self.offload = offload
        self.offload_group_size = int(offload_group_size)
        self.offload_resident_small = bool(offload_resident_small)
        self.offload_resident_video_groups = int(offload_resident_video_groups)
        # stream_stats: a streamed.StreamStats that group offload's sweeps count
        # into (bytes, copy-stream time), or None
        self.stream_stats = None
        home = self.device.type if offload == "none" else "cpu"
        for name, m in modules.items():
            p = next(m.parameters())
            if p.device.type != home:
                raise ValueError(f"{name} is on {p.device}; offload {offload!r} wants "
                                 f"it on {home}")
        if quantize != "none":
            modules = {name: (self._quantized(m, quantize) if name in QUANTIZED_TOWERS
                              else m)
                       for name, m in modules.items()}
        self.cfg = cfg
        self.modules = modules
        self.mask_ctx_pad = mask_ctx_pad
        self.attn_impl = attn_impl
        self.quantize = quantize
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        self.scheduler = FlowMatchPairScheduler(cfg.scheduler)
        # progress_cb(step, total): called on the host after each denoise step
        self.progress_cb = None

    def _quantized(self, module: torch.nn.Module, mode: str) -> torch.nn.Module:
        """`module` quantized; with offload, on the device and then moved to
        host memory, so only one tower's quantized weights are ever there."""
        if self.offload == "none":
            return dnn.quantize_modules(module, mode)
        with off.staged(module, self.device) as m:
            q = dnn.quantize_modules(m, mode)
            return off.to_host(q, self.device)

    @contextlib.contextmanager
    def _staged(self, *names: str):
        """The modules with `names` on the device for the block: the resident
        modules themselves, or (offload "component", "group") staged copies of them,
        freed when the block ends."""
        if self.offload == "none":
            yield self.modules
            return
        with contextlib.ExitStack() as stack:
            yield {n: stack.enter_context(off.staged(self.modules[n], self.device))
                   for n in names if n in self.modules}

    # --- text ---------------------------------------------------------------
    @torch.no_grad()
    def encode_prompt(self, prompts: List[str], max_len: int = 512,
                      modules: Optional[Dict[str, torch.nn.Module]] = None,
                      return_len: bool = False):
        """UMT5 embeddings [B, max_len, d_model], zero past each prompt's end;
        with `return_len` also each prompt's token count ([B] int32, at least
        1: the kernel's kv mask is undefined for length 0). `modules`: where
        the text encoder is (the pipeline's own by default)."""
        tok = self.tokenizer(
            [prompt_clean(p) for p in prompts], padding="max_length", max_length=max_len,
            truncation=True, add_special_tokens=True, return_attention_mask=True,
            return_tensors="np")
        ids = torch.from_numpy(np.asarray(tok["input_ids"])).to(self.device)
        mask = torch.from_numpy(np.asarray(tok["attention_mask"])).to(self.device)
        emb = umt5.encode((modules or self.modules)["text_encoder"], ids, mask,
                          compute_dtype=self.compute_dtype)
        emb = emb * mask[:, :, None].to(emb.dtype)
        if return_len:
            return emb, mask.sum(dim=1).clamp_min(1).to(torch.int32)
        return emb

    # --- latents ------------------------------------------------------------
    @torch.no_grad()
    def prepare_latents_batch(self, first_frames: List[np.ndarray], height: int,
                              width: int, num_frames: int,
                              generators: List[torch.Generator],
                              modules: Optional[Dict[str, torch.nn.Module]] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(noise latents [B, 16, F, h, w], condition [B, 20, F, h, w]), fp32.
        One VAE encode for the batch; each item's noise from its generator.
        `modules`: where the video VAE is (the pipeline's own by default)."""
        vcfg = self.cfg.video_vae
        st, ss = vcfg.scale_factor_temporal, vcfg.scale_factor_spatial
        if height % (ss * 2) or width % (ss * 2):
            raise ValueError(f"height/width must be divisible by {ss * 2}")
        if (num_frames - 1) % st:
            raise ValueError(f"num_frames-1 must be divisible by {st}")
        F_ = (num_frames - 1) // st + 1
        lh, lw = height // ss, width // ss
        b = len(first_frames)
        latents = torch.cat([
            torch.randn((1, vcfg.z_dim, F_, lh, lw), generator=g, device=self.device)
            for g in generators])

        # [first_frame, zeros...], built on the device from the first frames
        ff = torch.from_numpy(np.stack(first_frames).astype(np.float32)).to(self.device)
        video = torch.zeros((b, num_frames) + ff.shape[1:], dtype=torch.float32,
                            device=self.device)
        video[:, 0] = ff
        cond = wan_vae.encode_mode_streaming((modules or self.modules)["video_vae"], video)
        del video
        cond = wan_vae.normalize_latents(cond, vcfg).permute(0, 4, 1, 2, 3).float()

        # 4-channel first-frame mask, identical per item
        mask = np.ones((1, 1, num_frames, lh, lw), np.float32)
        mask[:, :, 1:] = 0.0
        first = np.repeat(mask[:, :, 0:1], st, axis=2)
        mask = np.concatenate([first, mask[:, :, 1:]], axis=2)
        mask = mask.reshape(1, F_, st, lh, lw).transpose(0, 2, 1, 3, 4)
        mask = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)
        condition = torch.cat([mask.expand(b, -1, -1, -1, -1), cond], dim=1)
        return latents, condition

    def prepare_audio_latents(self, num_frames: int, video_fps: float,
                              generator: torch.Generator) -> torch.Tensor:
        acfg = self.cfg.audio_vae
        num_samples = int(acfg.sample_rate * num_frames / video_fps)
        latent_t = (num_samples - 1) // acfg.hop_length + 1
        return torch.randn((1, acfg.latent_dim, latent_t), generator=generator,
                           device=self.device)

    # --- generation ---------------------------------------------------------
    def generate(self, prompts: List[str], images: List[np.ndarray],
                 negative_prompts: Optional[List[str]] = None,
                 seeds: Optional[List[int]] = None, **kwargs) -> List[GenerationResult]:
        """A batch of same-geometry requests; keyword arguments as for
        `prepare_state`."""
        state = self.prepare_state(prompts, images, negative_prompts=negative_prompts,
                                   seeds=seeds, **kwargs)
        return self.finalize_state(self.denoise_state(state))

    @torch.no_grad()
    def prepare_state(self, prompts: List[str], images: List[np.ndarray],
                      negative_prompts: Optional[List[str]] = None,
                      seeds: Optional[List[int]] = None, height: int = 352,
                      width: int = 640, num_frames: int = 193, video_fps: float = 24.0,
                      num_inference_steps: int = 50, sigma_shift: float = 5.0,
                      visual_shift: Optional[float] = None,
                      audio_shift: Optional[float] = None, cfg_scale: float = 5.0,
                      cfg_batch: bool = False, cfg_cache_interval: int = 1,
                      cfg_scale_bridge: float = 0.0) -> Dict[str, Any]:
        """Everything before the denoise loop: latent noise, VAE encode of the
        first frames, prompt encode. Returns the denoise state dict."""
        bsz = len(prompts)
        negative_prompts = negative_prompts or [""] * bsz
        seeds = seeds or [42] * bsz
        gens = [torch.Generator(self.device).manual_seed(int(s)) for s in seeds]
        with self._staged("video_vae") as m:
            latents, condition = self.prepare_latents_batch(images, height, width,
                                                            num_frames, gens, modules=m)
        audio_latents = torch.cat([self.prepare_audio_latents(num_frames, video_fps, g)
                                   for g in gens])
        ctx_neg = ctx_len_pos = ctx_len_neg = None
        with self._staged("text_encoder") as m:
            if self.mask_ctx_pad:
                ctx_pos, ctx_len_pos = self.encode_prompt(prompts, modules=m,
                                                          return_len=True)
                if cfg_scale != 1.0:
                    ctx_neg, ctx_len_neg = self.encode_prompt(negative_prompts, modules=m,
                                                              return_len=True)
            else:
                ctx_pos = self.encode_prompt(prompts, modules=m)
                if cfg_scale != 1.0:
                    ctx_neg = self.encode_prompt(negative_prompts, modules=m)
        return {
            "step": 0,
            "settings": dict(
                num_frames=num_frames, video_fps=video_fps,
                num_inference_steps=num_inference_steps, sigma_shift=sigma_shift,
                visual_shift=visual_shift, audio_shift=audio_shift, cfg_scale=cfg_scale,
                cfg_batch=cfg_batch, cfg_cache_interval=cfg_cache_interval,
                cfg_scale_bridge=cfg_scale_bridge),
            "latents": latents, "condition": condition, "audio_latents": audio_latents,
            "ctx_pos": ctx_pos, "ctx_neg": ctx_neg,
            "ctx_len_pos": ctx_len_pos, "ctx_len_neg": ctx_len_neg,
            "neg_cache_v": None, "neg_cache_a": None,
        }

    def _plan_for(self, s: Dict[str, Any]):
        """The sample plan for the state's settings (scheduler state is reset)."""
        self.scheduler.set_timesteps(s["num_inference_steps"], shift=s["sigma_shift"])
        if s["visual_shift"] is not None or s["audio_shift"] is not None:
            self.scheduler.set_pair_postprocess_by_name(
                "dual_sigma_shift",
                visual_shift=(s["visual_shift"] if s["visual_shift"] is not None
                              else s["sigma_shift"]),
                audio_shift=(s["audio_shift"] if s["audio_shift"] is not None
                             else s["sigma_shift"]))
        else:
            self.scheduler.set_pair_postprocess_by_name(None)
        return build_plan(self.scheduler, self.cfg.boundary_ratio)

    @torch.no_grad()
    def denoise_state(self, state: Dict[str, Any],
                      max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Advance the denoise by up to `max_steps` steps (all that remain when
        None). Partial ranges need offload "group", as in the JAX package:
        a state past step 0 or a `max_steps` short of the end raises
        otherwise. Under "group" the state carries the CFG negative cache
        (`neg_cache_v`, `neg_cache_a`), which a range resumed mid-phase
        continues from (never across the expert switch), so chained ranges
        give the whole range's bits. State arrays may be numpy or tensors."""
        s = state["settings"]
        plan = self._plan_for(s)
        n = plan.num_steps
        start = int(state["step"])
        stop = n if max_steps is None else min(n, start + int(max_steps))
        if start >= stop:
            return state
        if self.offload != "group" and (start != 0 or stop != n):
            raise ValueError("partial denoise_state ranges require offload='group'")

        def dev(x):
            return None if x is None else _to_device(x, self.device)

        latents, condition = dev(state["latents"]), dev(state["condition"])
        audio_latents = dev(state["audio_latents"])
        vcfg = self.cfg.video_dit
        pt, ph, pw = vcfg.patch_size
        grid = (latents.shape[2] // pt, latents.shape[3] // ph, latents.shape[4] // pw)
        rope_pack = make_rope_pack(
            vcfg, self.cfg.audio_dit, self.cfg.bridge, grid,
            audio_latents.shape[2] // self.cfg.audio_dit.patch_size, s["video_fps"],
            self.device)
        args = (latents, condition, audio_latents, dev(state["ctx_pos"]),
                dev(state["ctx_neg"]), plan)
        kw = dict(cfg_scale=s["cfg_scale"], video_fps=s["video_fps"],
                  cfg_batch=s["cfg_batch"], compute_dtype=self.compute_dtype,
                  rope_pack=rope_pack, cfg_cache_interval=s["cfg_cache_interval"],
                  cfg_scale_bridge=s["cfg_scale_bridge"], progress_fn=self.progress_cb,
                  ctx_len_pos=dev(state.get("ctx_len_pos")),
                  ctx_len_neg=dev(state.get("ctx_len_neg")), attn_impl=self.attn_impl)
        # each expert for its own steps: with offload, one on the device at a time
        split = plan.boundary_step if "video_dit_2" in self.modules else n
        phases = (("video_dit", 0, split), ("video_dit_2", split, n))
        cache = None
        if self.offload == "group":
            if state.get("neg_cache_v") is not None:
                cache = (dev(state["neg_cache_v"]), dev(state["neg_cache_a"]))
            for tower, p0, p1 in phases:
                a, b = max(p0, start), min(p1, stop)
                if b <= a:
                    continue
                # the cache carries only into a range resumed mid-phase: at an
                # expert switch the other expert's negative must not seed it
                carry = cache if a == start and a > p0 else None
                latents, audio_latents, cache = denoise_streamed(
                    self.modules[tower], self.modules["audio_dit"], self.modules["bridge"],
                    *args[:5], plan, a, b, group_size=self.offload_group_size,
                    resident_small=self.offload_resident_small,
                    resident_video_groups=self.offload_resident_video_groups,
                    neg_cache=carry, return_neg_cache=True, stats=self.stream_stats, **kw)
                args = (latents, condition, audio_latents) + args[3:]
        else:
            with self._staged("audio_dit", "bridge") as shared:
                for tower, p0, p1 in phases:
                    if p1 > p0:
                        latents, audio_latents = self._phase(tower, shared, args, p0, p1,
                                                             dict(kw, sp_mesh=self.mesh))
                        args = (latents, condition, audio_latents) + args[3:]
        neg_v, neg_a = cache if cache is not None else (None, None)
        return dict(state, step=stop, latents=latents, audio_latents=audio_latents,
                    neg_cache_v=neg_v, neg_cache_a=neg_a)

    def _phase(self, tower: str, shared, args, start: int, stop: int, kw):
        """Steps [start, stop) with the expert `tower` staged for them alone."""
        with self._staged(tower) as m:
            return denoise_range(m[tower], shared["audio_dit"], shared["bridge"], *args,
                                 start, stop, **kw)

    @torch.no_grad()
    def finalize_state(self, state: Dict[str, Any]) -> List[GenerationResult]:
        """Video and audio decode, the audio trimmed to the video's duration."""
        s = state["settings"]
        if int(state["step"]) < s["num_inference_steps"]:
            raise ValueError(f"denoise incomplete: step {state['step']} of "
                             f"{s['num_inference_steps']}")
        latents = _to_device(state["latents"], self.device)
        audio_latents = _to_device(state["audio_latents"], self.device)
        num_samples = int(self.cfg.audio_vae.sample_rate * s["num_frames"] / s["video_fps"])
        results = []
        # both VAEs staged once around the batch
        with self._staged("video_vae", "audio_vae") as m:
            for i in range(latents.shape[0]):
                video, audio = self._decode_with(m, latents[i:i + 1],
                                                 audio_latents[i:i + 1])
                results.append(GenerationResult(
                    video=video, audio=audio[:num_samples],
                    sample_rate=self.cfg.audio_vae.sample_rate, fps=s["video_fps"]))
        return results

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, audio_latents: torch.Tensor):
        """latents [1, 16, F, h, w] -> uint8 video [T, H, W, 3] (decoded in
        the compute dtype); audio latents -> fp32 waveform [S]."""
        with self._staged("video_vae", "audio_vae") as m:
            return self._decode_with(m, latents, audio_latents)

    def _decode_with(self, modules, latents: torch.Tensor, audio_latents: torch.Tensor):
        z = wan_vae.denormalize_latents(latents.permute(0, 2, 3, 4, 1), self.cfg.video_vae)
        video = wan_vae.decode_streaming(modules["video_vae"],
                                         z.to(self.compute_dtype))[0].float()
        video = ((video.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).cpu().numpy()
        audio = dac_vae.decode(modules["audio_vae"], audio_latents)
        return video, audio[0, 0].cpu().numpy()

    # --- serving warmup -------------------------------------------------------
    def warmup(self, height: int = 352, width: int = 640, num_frames: int = 193,
               num_inference_steps: int = 50, sigma_shift: float = 5.0,
               cfg_scale: float = 5.0, video_fps: float = 24.0,
               batch_size: int = 1, cfg_batch: bool = False,
               cfg_cache_interval: int = 1,
               cfg_scale_bridge: float = 0.0) -> None:
        """Prepare a geometry bucket for serving WITHOUT running it (the
        counterpart of the JAX package's AOT compile of the denoise program).
        The port compiles no program per geometry: what a first request
        would pay is loading the CUDA kernels of the attention route
        (`ops/_build.py`), built with nvcc where the checkout holds no build
        yet, and that is done here. The geometry arguments keep the JAX
        signature; the kernels take any shape. Nothing runs on the device,
        and on the CPU (plain versions) or for "ref" and callable routes
        there is nothing to load."""
        if self.device.type != "cuda" or callable(self.attn_impl) or self.attn_impl == "ref":
            return
        from dualforce_tpu_torch.ops import _build

        _build.load("sage_fwd" if self.attn_impl == "sage" else "flash_fwd")

    def __call__(self, prompt: str, image: np.ndarray, negative_prompt: str = "",
                 seed: int = 42, **kwargs) -> GenerationResult:
        """One request; keyword arguments as for `prepare_state`."""
        return self.generate([prompt], [image], negative_prompts=[negative_prompt],
                             seeds=[seed], **kwargs)[0]
