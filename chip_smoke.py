#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dualforce_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: every CUDA kernel of the port, from the sources in the checkout,
   with ptxas's registers, spills and C7512 lines; the SASS of the forward
   and the backward must show wgmma (HGMMA) and TMA loads (UTMALDG) in
   every flash kernel, and the forward no mma.sync (HMMA); the sage kernel
   integer wgmma (IGMMA) beside HGMMA and UTMALDG, and no mma.sync (HMMA,
   IMMA).
3. kernels: each kernel's wrapper at the main path's shapes, held against
   its plain PyTorch version on the same inputs (two heads per shape, bf16
   output against the fp32 plain version, relative L2 error <= 1e-2), plus
   a per-batch kv-length case whose length-0 row must be exactly 0 and a
   ragged case (Sq and Sk not multiples of 128, kv_len ending mid-tile, a
   length-0 batch) in exact and cap mode with the LSE (within 1e-3
   absolute; a keyless row's LSE -1e4 * ln 2 or cap * ln 2); times of the
   kernel, its plain version, its bound on an H100 SXM and the one PyTorch
   call that computes the same function (a yardstick only: the port never
   calls it); where a call splits its key range, the time of the same call
   unsplit beside it.
4. small input: one dual-tower step at a small head_dim-128 geometry
   through the kernel, against the same step through the plain fp32
   attention (relative L2 error <= 2e-2 on bf16 outputs).
5. main path: two 352x640, 193-frame, 24 fps requests through
   `MOVAPipeline.__call__` at MOVA-360p widths with depth cut (video 3
   layers per expert, two experts; audio 2; bridge shared depth 2; UMT5 2),
   random bf16 weights from a seed, 4 steps, CFG 5 with a negative prompt,
   shift 5. Each result must be a uint8 [193, 352, 640, 3] video and 386,000
   finite audio samples, and each request must launch the flash kernel
   exactly 112 times.
6. backward kernels: at the training path's three flash shapes (B 1, 40
   heads, D 128: video self 11,440 x 11,440, video text cross 11,440 x 512,
   a2v 11,440 x 103) the forward with its LSE output and the backward, held
   on two heads against their plain versions (LSE within 1e-3 absolute; o
   relative L2 <= 1e-2; dq, dk, dv relative L2 <= 2e-2), plus a masked case
   with an LSE cotangent whose length-0 batch must get exactly zero dq and
   whose masked keys exactly zero dk and dv, and a backward through
   `flash_attention` that must leave q.grad, k.grad and v.grad nonzero;
   times as in phase 3, the yardstick being the backward of
   `scaled_dot_product_attention`.
7. small backward: one LoRA `training_loss` at the head_dim-128 geometry of
   phase 4, its LoRA gradients through the kernels against those through
   plain fp32 attention (relative L2 <= 5e-2 over all of them).
8. train path: `LoRATrainer` on the main path's modules at the 360p training
   recipe (352x640, 49 frames at 24 fps: 11,440 video tokens, 103 audio
   tokens; LoRA rank 16, alpha 16, lr 1e-4 with 100 warmup steps, cosine,
   remat) for 4 optimizer steps on synthetic clips from a numpy seed. The
   experts must run 0, 1, 0, 1; loss and grad norm must be finite (the norm
   above 0); each micro-step must launch the forward kernel exactly 16 times
   and the (fused) backward kernel 8 times, the split one never; afterwards
   every module's LoRA `b` must be nonzero, and the saved `lora_weights.npz`
   must load back equal.
9. precision kernels: at the six shapes of phase 3, the flash forward's cap
   mode (the "fast" route) against its plain version (relative L2 <= 1e-2),
   sage's CUDA quantization prologue against its plain version (Q's codes
   and scales bit-equal; K's codes at most 1 apart in at most 1e-4 of them,
   its scales within 1e-6 relative) and the int8-QK sage kernel against its
   plain version on the same int8 quantization (<= 1e-2; its error against
   exact fp32 attention printed beside JAX's bound of 2.5e-2, for
   information), two heads each; the masked case for all three (the
   length-0 batch exactly 0) and a cap-mode forward with its LSE (<= 1e-3
   absolute; a keyless row's LSE cap * ln 2); times of each kernel beside
   the cap mode's at the same shape (the yardstick sage exists to beat), of
   the prologue beside its byte bound, of the plain
   versions (no yardstick), the bound and the library call (SDPA for the
   cap mode; none computes int8-QK attention or the prologue).
10. precision step: the phase-4 step with "fast" against "ref" and with
   "sage" through the kernel against "sage" through its plain version
   (relative L2 <= 2e-2), the latter also with int8 towers.
11. precision serving: on the main path's modules, which stay as they are,
   one request through `MOVAPipeline(attn_impl="sage", quantize="int8")`
   and one through `MOVAPipeline(attn_impl="fast", quantize="int4")`, as in
   phase 5. The sage request must launch the sage kernel and its prologue
   exactly 112 times each and the flash kernels never; the fast request the
   cap mode exactly 112 times and nothing else. Prints the seconds spent quantizing and the
   device memory of the quantized towers against the bf16 ones.
12. 720p backward kernels: at the six flash shapes of a 720p training
   micro-step (B 1, D 128: video self 40 x 176,400 x 176,400, video text
   cross 40 x 176,400 x 512 and a2v 40 x 176,400 x 403, which route the
   backward to the split kernels; v2a 12 x 403 x 176,400, audio self
   12 x 403 x 403 and audio text cross 12 x 403 x 512, which route it to the
   fused one) the forward with its LSE and the routed backward, held on two
   heads against their plain versions with phase 6's tolerances, and the
   forward without the LSE (its o bit-equal to the LSE forward's); at the
   split shapes the fused kernel on the same inputs too (its time and its
   gap to the split's results); times of the routed kernel, its bound, the
   SDPA backward and the plain version on the two heads (at >= 100k tokens
   one warm-up, the checked call, and two timed calls); a masked case with
   an LSE cotangent through the split kernels (B 3, N 2, Sq 98,305, Sk 512,
   kv_len [512, 77, 0]: the length-0 batch exactly zero dq, masked keys
   exactly zero dk and dv); and phase 7 again with every backward routed to
   the split kernels.
13. 720p train path: `LoRATrainer` on the main path's modules with phase 8's
   settings for 2 optimizer steps (experts 0, 1) on synthetic 1280x720
   clips of 193 frames at 24 fps with 386,000 audio samples (176,400 video
   and 403 audio tokens). Loss and grad norm must be finite (the norm above
   0); each micro-step must launch the forward kernel exactly 28 times, the
   split backward 8 times and the fused one 6 times; afterwards every
   module's LoRA `b` must be nonzero. Prints encode, loss+backward and
   optimizer seconds per step and the peak device memory.
14. full depth, staged: MOVA-360p at full depth (40 video layers per
   expert, 30 audio, 30 shared bridge layers, UMT5 24) from seed 0, each
   module drawn on the card and handed back in page-locked host memory
   (bf16 masters, 73.3 GiB: the card's host holds them, so the fp8
   fallback for smaller hosts is not taken), then phase 5's request
   through `MOVAPipeline(offload="component")`. It must give phase 5's
   shapes, launch the flash kernel exactly 1,600 times, peak under both
   experts' bf16 bytes (53.2 GiB, which no run holding both could stay
   under) and leave the allocated memory within 1 GiB of its level before
   the request. Prints prepare, step and decode seconds, each staging's
   seconds and rate, the host's memory and lock limit.
15. full depth, fp8: the same request with the towers and UMT5 stored in
   fp8 (`init_pipeline_params(dtype=float8_e4m3fn)`) resident on the card:
   1,600 launches; prints the fp8 modules' bytes against bf16's and the
   peak.
16. sampler options: at phase 5's geometry and depth cut (seed 0), one
   request with `cfg_batch` and `mask_ctx_pad`: exactly 56 launches, each at
   B = 2, the text cross-attentions with per-batch kv lengths, its decoded
   video within 2e-2 relative L2 (fp32) of the same request unbatched (112
   launches); one request with `cfg_cache_interval=2`, its launches
   printed; then the unbatched request again with the same modules moved
   to page-locked host memory, through `offload="component"`: bit-equal to
   the resident result.
17. checkpoint and CLIs: phase 5's modules (seed 0, drawn again) written
   with the port's writer as an HF-layout checkpoint in a temporary
   directory (towers and UMT5 bf16, VAEs fp32 with the DAC weight-normed),
   then phase 5's first request through `cli.inference_single.run` with its
   default flags: 112 launches, every loaded parameter equal to the one
   written (the DAC's folded weights within 1e-6 relative), the video
   bit-equal to phase 5's, the request's audio latents those of phase 5
   (the written DAC decodes them to phase 5's audio bit for bit) and their
   fp32 decodes through the loaded and the written DAC within 1e-5 relative
   L2 (the end-to-end audio differs more, ~6e-4: cuDNN runs the fp32
   convolutions in TF32, whose rounding any one-ulp weight change shows;
   printed); the same
   request with `--weight_dtype fp8 --profile DIR`: 112 launches, every fp8
   tower and UMT5 byte-equal to `nn.cast_modules_fp8` of the bf16 load, the
   ten operations with the most device time printed from the profiler's
   averages; and through `cli.inference_single_lora.run` with an
   accelerate-format LoRA (rank 16, alpha 16, scale 0.75, from a numpy
   seed) and `--offload cpu`: 112 launches, the experts never staged
   together, three merged weights within half a bf16 step (and a few fp32
   steps) of W + (alpha/r) * scale * B A computed on the card in fp32, the
   video changed. Each clip is written with `save_video_with_audio` (the
   WAV alone where PIL is absent). The checkpoint stays for phase 19.
18. low-resource training at full depth: MOVA-360p uncut from seed 0, the
   towers and UMT5 drawn on the card, cast to fp8 and moved into
   page-locked host memory, then `LoRATrainer` with the `trainer` settings
   of `configs/training/lora_low_resource.py` (AdamW8bit, component
   offload, remat, rank 16) on synthetic 352x640x49 clips, cut to 3
   optimizer steps of 2 micro-batches with the expert switched every step
   (experts 0, 0, 1, 1, 0, 0; the warmup's lr is 0 at the first step, so
   expert 0 trains at a nonzero lr only at the third). The two experts must
   never be staged together (a spy on `offload.staged`), the metrics be
   finite, each micro-step launch the forward kernel exactly 220 times and
   the fused backward and its preprocess 110 times (30 shared layers x 3
   video-side attentions + 10 tail layers x 2; the split kernels never),
   every module's LoRA `b` be nonzero afterwards, and the saved
   `lora_weights.npz` and the exported `lora_weights.pt` reload bit-equal.
   Prints per micro-step the encode, staging, loss+backward and optimizer
   seconds, the peak device memory and the host's RSS, and each staging's
   rate.
19. training CLI to LoRA CLI: 2 npz shards and 1 MJPEG AVI with audio at
   352x640, 49 frames, 24 fps and their `metadata.json`; `cli.train.run`
   with `configs/training/lora_low_resource.py` from phase 17's checkpoint
   (fp8 storage, component offload, AdamW8bit, 4 micro-batches per step;
   `--set` one data worker, the expert switched every step, jsonl logs, lr
   1e-3 after one warmup step) to step 2, then again to step 3, which must
   resume from `step-2` (16 forward and 8 fused backward launches per
   micro-step); the step's npz and exported `.pt` reload bit-equal and
   every LoRA `b` is nonzero; then phase 5's first request through
   `cli.inference_single_lora.run` with the exported
   `step-3/lora_weights.pt`: 112 launches, a uint8 video of the right shape
   that differs from phase 17's base video (its relative L2 printed). The
   checkpoint's directory is removed.

Every phase prints its wall time. The run sets
PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True unless the environment sets
it: phase 13 needs it to fit 193 frames on an 80 GB card.
The line before the last is the card's name and power limit; the one
before that lists each kernel as JSON. The last line of standard output is
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12   # fp32 outside the tensor cores
# above the H100's highest SM clock (1.98 GHz), so a spin of this many cycles
# per second of wanted delay lasts at least that long
SPIN_CYCLES_PER_S = 2.0e9
MAX_SPIN_S = 0.05

HEAD_DIM = 128
# (name, heads, Sq, Sk) of each flash-attention call on a 360p request (B = 1)
MAIN_PATH_SHAPES = [
    ("video_self", 40, 43120, 43120),
    ("video_text_cross", 40, 43120, 512),
    ("a2v_bridge", 40, 43120, 403),
    ("v2a_bridge", 12, 403, 43120),
    ("audio_self", 12, 403, 403),
    ("audio_text_cross", 12, 403, 512),
]
# (name, heads, Sq, Sk) of each flash-attention call of a 360p training step (B = 1):
# 49 frames give 13 x 22 x 40 = 11,440 video tokens; 98,000 audio samples 103 tokens
TRAIN_PATH_SHAPES = [
    ("video_self", 40, 11440, 11440),
    ("video_text_cross", 40, 11440, 512),
    ("a2v_bridge", 40, 11440, 103),
]
# H100 SXM data sheet: dense int8 tensor-core rate
PEAK_INT8_OPS = 1979e12
FAST_SOFTMAX_CAP = 30.0
SAGE_EXACT_REL_TOL = 2.5e-2     # JAX's bound against exact attention; printed only
KERNEL_REL_TOL = 1e-2
STEP_REL_TOL = 2e-2
LSE_ABS_TOL = 1e-3
GRAD_REL_TOL = 2e-2
LORA_GRAD_REL_TOL = 5e-2
PREP_REL_TOL = 1e-5     # the delta preprocess against `_delta`: fp32 sums in another order
# sage's CUDA prologue against its plain version: K codes that may differ by one (K's mean is
# summed in another order), as a share of the elements, and the K scales' relative error
PROLOGUE_CODE_SHARE = 1e-4
PROLOGUE_SCALE_TOL = 1e-6
# per request: (2 shared layers x 6 attentions + 1 tail layer x 2) x 2 CFG passes x 4 steps
LAUNCHES_PER_REQUEST = (2 * 6 + 1 * 2) * 2 * 4
# per training micro-step: the 3 video-side attentions of each of 2 shared layers (video
# self, video text cross, a2v; the 103-query audio side takes plain attention) and the 2 of
# the 1 tail layer; remat runs each forward twice
TRAIN_FLASH_CALLS = 2 * 3 + 1 * 2
TRAIN_FWD_LAUNCHES = 2 * TRAIN_FLASH_CALLS
TRAIN_BWD_LAUNCHES = TRAIN_FLASH_CALLS
TRAIN_STEPS = 4
# (name, heads, Sq, Sk) of each flash-attention call of a 720p training micro-step (B = 1):
# 193 frames at 1280x720 give 49 x 45 x 80 = 176,400 video tokens, 386,000 audio samples 403
# audio tokens. Sq >= 98,305 routes the backward to the split kernels, as in the JAX package.
TRAIN_720P_SHAPES = [
    ("video_self", 40, 176400, 176400),
    ("video_text_cross", 40, 176400, 512),
    ("a2v_bridge", 40, 176400, 403),
    ("v2a_bridge", 12, 403, 176400),
    ("audio_self", 12, 403, 403),
    ("audio_text_cross", 12, 403, 512),
]
TRAIN_720P = dict(height=720, width=1280, num_frames=193, audio_samples=386000)
TRAIN_720P_STEPS = 2
# per 720p micro-step: all 6 attentions of each of 2 shared layers take the kernels (the
# 403-token audio side passes the Sq >= 256 gate) and the 2 of the 1 tail layer: 14 calls,
# each forward twice under remat; the 8 with Sq = 176,400 (video self, video text cross, a2v
# in the shared layers; video self and text cross in the tail) take the split backward, the
# 6 with Sq = 403 (v2a, audio self, audio text cross) the fused one
TRAIN_720P_FWD_LAUNCHES = 2 * (2 * 6 + 1 * 2)
TRAIN_720P_SPLIT_LAUNCHES = 2 * 3 + 1 * 2
TRAIN_720P_FUSED_LAUNCHES = 2 * 3
# the serving requests of phases 5 and 11: 360p, 193 frames at 24 fps, 4 steps, CFG 5, shift 5
REQUEST = dict(height=352, width=640, num_frames=193, video_fps=24.0, num_inference_steps=4,
               sigma_shift=5.0, cfg_scale=5.0)


class ByteTokenizer:
    """Byte-level stand-in for the UMT5 tokenizer (no checkpoint is shipped)."""

    def __call__(self, prompts, padding=None, max_length=512, truncation=True,
                 add_special_tokens=True, return_attention_mask=True, return_tensors="np"):
        import numpy as np

        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            toks = [2 + (b % 500) for b in p.encode()][: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1):
    """(device ms, host us) per call: medians over `reps` CUDA-event pairs,
    after `warmup` calls. Each pair brackets enough back-to-back calls to
    last about a millisecond on the card. A spin kernel, sized from the
    host's measured time per call, holds the card until every call of the
    pair is queued, so the events time the card's work and not the host's
    launches; the host's own time per call is read beside it."""
    import torch

    def elapsed(calls: int, spin_s: float):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, 1e6 * host_s / calls

    for _ in range(warmup):
        fn()
    device_ms, host_us = elapsed(1, 0.0)
    calls = max(1, min(200, int(1.0 / max(device_ms, 1e-3))))
    # a call that keeps the card busy longer than its host work needs no
    # spin: the cap keeps the plain version's seconds-long calls from
    # doubling their run time
    spin_s = min(MAX_SPIN_S, 1e-3 + 2e-6 * calls * host_us)
    runs = [elapsed(calls, spin_s) for _ in range(reps)]
    return (statistics.median(r[0] for r in runs), statistics.median(r[1] for r in runs))


def rel_err(got, want) -> float:
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound_ms(b: int, n: int, sq: int, sk_valid: int, sk: int, lse: bool = False):
    """Least time on an H100 SXM: bf16 q, k, v read once and o written once
    (and the fp32 LSE, when written), against 4*Sq*Sk*D flops over the keys
    this input leaves valid."""
    nbytes = 2 * b * n * HEAD_DIM * (2 * sq + 2 * sk) + (4 * b * n * sq if lse else 0)
    return _bound(4 * b * n * sq * sk_valid * HEAD_DIM, nbytes)


def attention_bwd_bound_ms(b: int, n: int, sq: int, sk_valid: int, sk: int):
    """Least time on an H100 SXM for the backward: bf16 q, o, dO read and dq
    written (4 Sq rows), k, v read and dk, dv written (4 Sk rows), fp32 lse
    and delta read, against 10*Sq*Sk*D flops (the five products) over the
    keys this input leaves valid."""
    nbytes = 2 * b * n * HEAD_DIM * (4 * sq + 4 * sk) + 2 * 4 * b * n * sq
    return _bound(10 * b * n * sq * sk_valid * HEAD_DIM, nbytes)


def split_pass_bounds_ms(b: int, n: int, sq: int, sk_valid: int, sk: int):
    """Least times on an H100 SXM of the split pair's two passes, each
    counting the products it does itself: the dq pass S, dP and dQ
    (6*Sq*Sk*D flops; q, dO, k, v read, dq written), the dk/dv pass S, dP,
    dV and dK (8*Sq*Sk*D flops; q, dO, k, v read, dk, dv written); both read
    lse and delta (fp32)."""
    stats = 2 * 4 * b * n * sq
    dq = _bound(6 * b * n * sq * sk_valid * HEAD_DIM,
                2 * b * n * HEAD_DIM * (3 * sq + 2 * sk) + stats)
    dkv = _bound(8 * b * n * sq * sk_valid * HEAD_DIM,
                 2 * b * n * HEAD_DIM * (2 * sq + 4 * sk) + stats)
    return dq, dkv


def preprocess_bound_ms(b: int, n: int, sq: int):
    """Least time on an H100 SXM of the backward's preprocess: bf16 O and dO
    and the fp32 LSE read, delta and lse * log2(e) written as fp32 rows
    padded to 128, against 2*Sq*D fp32 flops at the CUDA cores' 67 TFLOP/s."""
    sq_pad = -(-sq // 128) * 128
    nbytes = 2 * 2 * b * n * sq * HEAD_DIM + 4 * b * n * sq + 2 * 4 * b * n * sq_pad
    t_ops, t_bytes = 2 * b * n * sq * HEAD_DIM / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_preprocess(fa, o, do, lse, dlse=None):
    """The preprocess kernel against `_delta` (relative L2 <= 1e-5) and its
    padded rows (delta 0, lse +inf); returns the relative and the largest
    absolute error of delta."""
    import torch

    sq = o.shape[1]
    delta, lse2 = fa.flash_bwd_preprocess(o, do, lse, dlse)
    torch.cuda.synchronize()
    want = fa._delta(o, do, dlse)
    err = rel_err(delta[..., :sq], want)
    mae = float((delta[..., :sq] - want).abs().max())
    lse_err = float((lse2[..., :sq] - lse * fa.LOG2E).abs().max())
    pad_ok = bool((delta[..., sq:] == 0).all() and torch.isposinf(lse2[..., sq:]).all())
    if not (err <= PREP_REL_TOL and lse_err <= 1e-6 * float(lse.abs().max()) and pad_ok):
        raise AssertionError(f"preprocess: delta rel err {err}, lse abs err {lse_err}, "
                             f"padded rows as due {pad_ok}")
    return err, mae


def timed_phase(name: str, fn, *args):
    """fn(*args), with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{name}] phase wall time {time.perf_counter() - t0:.1f} s")
    return out


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    # fp32 matmuls in full fp32 (the PyTorch default); cuDNN convolutions
    # (the fp32 Wan VAE encode, the DAC decode) in TF32 (the PyTorch default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("[device] torch.backends.cuda.matmul.allow_tf32=False "
        "torch.backends.cudnn.allow_tf32=True")
    return smi


# SASS opcodes counted in phase 2: warpgroup products (bf16 HGMMA, integer IGMMA), mma.sync
# (HMMA, IMMA), TMA tile loads, bulk copies, bulk reductions, global atomics (ATOMG, RED; a
# bulk reduction is UBLKRED), and the int-to-float conversions and MUFU ops of the sage kernel
SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG", "UBLKCP", "UBLKRED", "ATOMG", "RED",
            "I2F", "I2FP", "MUFU")
# each forward kernel variant (exact, cap) and the opcodes it must issue; HMMA (mma.sync) none
FWD_SASS_WANT = {"flash_fwd_kernelILb0E": ("HGMMA", "UTMALDG"),
                 "flash_fwd_kernelILb1E": ("HGMMA", "UTMALDG")}
# each backward kernel (mangled-name fragment) and the opcodes it must issue
BWD_SASS_WANT = {"flash_bwd_dkv_kernelILb1E": ("HGMMA", "UTMALDG", "UBLKRED"),
                 "flash_bwd_dkv_kernelILb0E": ("HGMMA", "UTMALDG"),
                 "flash_bwd_dq_kernel": ("HGMMA", "UTMALDG")}
# the sage kernel: integer wgmma for Q.K^T, bf16 wgmma for P.V, TMA loads; no mma.sync (HMMA,
# IMMA)
SAGE_SASS_WANT = {"sage_fwd_kernel": ("IGMMA", "HGMMA", "UTMALDG")}


def sass_counts(lib: str, nvcc: str):
    """{kernel name: {opcode: count}} from `cuobjdump -sass` of a built library."""
    import re
    from pathlib import Path

    tool = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if func and m:
            op = m.group(1)
            if op in counts[func]:
                counts[func][op] += 1
    return counts


def _check_sass(lib: str, counts, want) -> None:
    for frag, ops in want.items():
        found = [c for func, c in counts.items() if frag in func]
        if len(found) != 1 or any(found[0][op] == 0 for op in ops):
            raise AssertionError(f"{lib} {frag}: SASS lacks one of {ops}: {found}")


def phase_build():
    """Every kernel source, one nvcc each, all started together; the SASS
    must show wgmma (HGMMA) and TMA loads (UTMALDG) in both forward variants
    (and no mma.sync, HMMA) and in all three backward kernels, the fused
    kernel's bulk reduction of dQ, and no global atomics; and integer wgmma
    (IGMMA) beside HGMMA and UTMALDG in the sage kernel, with no mma.sync
    (HMMA, IMMA)."""
    from concurrent.futures import ThreadPoolExecutor

    from dualforce_tpu_torch.ops import _build

    names = ("flash_fwd", "flash_bwd", "sage_fwd")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(_build.build, names)))
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.2f} s of wall time")
    for name, built in builds.items():
        log(f"[build] {name}: {built.path.name} nvcc {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "Performance Loss" in line or "C7512" in line):
                log(f"[build]   {line.strip()}")
    sass = {name: sass_counts(str(builds[name].path), _build.nvcc()) for name in names}
    for name, counts in sass.items():
        for func, ops in counts.items():
            log(f"[build] sass {name} {func}: " + " ".join(f"{op}={n}" for op, n in ops.items()))
    _check_sass("flash_fwd", sass["flash_fwd"], FWD_SASS_WANT)
    mma_sync = {func: ops["HMMA"] for func, ops in sass["flash_fwd"].items() if ops["HMMA"]}
    if mma_sync:
        raise AssertionError(f"flash_fwd issues mma.sync (HMMA): {mma_sync}")
    log("[build] flash_fwd: HGMMA and UTMALDG in both variants (exact, cap), no HMMA")
    counts = sass["flash_bwd"]
    _check_sass("flash_bwd", counts, BWD_SASS_WANT)
    atomics = {func: ops["ATOMG"] + ops["RED"] for func, ops in counts.items()
               if ops["ATOMG"] + ops["RED"]}
    if atomics:
        raise AssertionError(f"flash_bwd issues global atomics: {atomics}")
    log("[build] flash_bwd: HGMMA and UTMALDG in the fused kernel, the dk/dv pass and the dq "
        "pass; the fused kernel's dQ by UBLKRED; no global atomics")
    _check_sage_sass(sass["sage_fwd"])


def _check_sage_sass(counts) -> None:
    """Integer and bf16 wgmma and TMA loads in the sage kernel, and no
    mma.sync anywhere in the library."""
    _check_sass("sage_fwd", counts, SAGE_SASS_WANT)
    mma_sync = {func: (ops["HMMA"], ops["IMMA"]) for func, ops in counts.items()
                if ops["HMMA"] or ops["IMMA"]}
    if mma_sync:
        raise AssertionError(f"sage_fwd issues mma.sync (HMMA, IMMA): {mma_sync}")
    log("[build] sage_fwd: IGMMA, HGMMA and UTMALDG in the sage kernel, no HMMA or IMMA")


def time_unsplit_ms(fa, fn):
    """`fn` timed with every forward call left whole (`fwd_splits` replaced
    by 1 for these calls only; the package has no switch)."""
    splits = fa.fwd_splits
    fa.fwd_splits = lambda ctas, sk, sms: 1
    try:
        return time_ms(fn, reps=7, warmup=2)[0]
    finally:
        fa.fwd_splits = splits


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from dualforce_tpu_torch.ops import flash_attention as fa
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_plain,
                                                         flash_attention_with_lse)

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    rows, max_abs = [], 0.0
    for name, n, sq, sk in MAIN_PATH_SHAPES:
        q = torch.randn(1, sq, n, HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn(1, sk, n, HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn(1, sk, n, HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        heads = [0, n - 1]
        want = flash_attention_plain(q[:, :, heads].float(), k[:, :, heads].float(),
                                     v[:, :, heads].float())
        got = out[:, :, heads]
        err = rel_err(got, want)
        mae = float((got.float() - want).abs().max())
        max_abs = max(max_abs, mae)
        if not err <= KERNEL_REL_TOL:
            raise AssertionError(f"{name}: relative L2 error {err} > {KERNEL_REL_TOL}")
        del want, got
        kernel_ms, host_us = time_ms(lambda: flash_attention(q, k, v), reps=7, warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms, library_host_us = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=7, warmup=2)
        plain_ms, _ = time_ms(lambda: flash_attention_plain(q, k, v), reps=3, warmup=1)
        bound_ms, bound_by = attention_bound_ms(1, n, sq, sk, sk)
        splits = fa.fwd_splits(n * -(-sq // fa.FWD_BLOCK_M), sk, fa._sm_count(dev))
        unsplit_ms = (time_unsplit_ms(fa, lambda: flash_attention(q, k, v)) if splits > 1
                      else None)
        row = dict(shape=name, heads=n, sq=sq, sk=sk, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, rel_err=err, max_abs_err=mae, splits=splits,
                   unsplit_ms=unsplit_ms, host_us=host_us)
        rows.append(row)
        split_note = (f" splits={splits} (unsplit_ms={unsplit_ms:.4f})" if splits > 1
                      else " splits=1")
        log(f"[kernel] flash_fwd {name} N={n} Sq={sq} Sk={sk}: kernel_ms={kernel_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={library_ms:.4f} "
            f"plain_ms={plain_ms:.4f} (not a yardstick) rel_err={err:.3e} "
            f"max_abs_err={mae:.3e} host_us={host_us:.1f} "
            f"library_host_us={library_host_us:.1f}" + split_note)
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()

    # per-batch kv lengths, one of them 0: that row must come back exactly 0
    b, n, sq, sk, lens = 3, 8, 4096, 512, [512, 77, 0]
    q = torch.randn(b, sq, n, HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, sk, n, HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, sk, n, HEAD_DIM, generator=g, device=dev, dtype=torch.bfloat16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    want = flash_attention_plain(q.float(), k.float(), v.float(), kv_len)
    err = rel_err(out, want)
    mae = float((out.float() - want).abs().max())
    max_abs = max(max_abs, mae)
    zeros = int(torch.count_nonzero(out[2]))
    if not err <= KERNEL_REL_TOL or zeros != 0:
        raise AssertionError(f"masked case: rel err {err}, {zeros} nonzero in the "
                             f"length-0 row")
    log(f"[kernel] flash_fwd masked B={b} N={n} Sq={sq} Sk={sk} kv_len={lens}: "
        f"rel_err={err:.3e} max_abs_err={mae:.3e} length-0 row exactly 0")

    # ragged: Sq and Sk not multiples of 128, kv_len ending inside a key tile, a length-0
    # batch; exact and cap mode, with the LSE
    b, n, sq, sk, lens = 3, 4, 1000, 1100, [1100, 300, 0]
    q, k, v = (_rand(g, b, s, n, HEAD_DIM) for s in (sq, sk, sk))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    for cap in (None, FAST_SOFTMAX_CAP):
        out, lse = flash_attention_with_lse(q, k, v, kv_len, softmax_cap=cap)
        torch.cuda.synchronize()
        want, want_lse = flash_attention_plain(q.float(), k.float(), v.float(), kv_len,
                                               return_lse=True, softmax_cap=cap)
        err = rel_err(out, want)
        mae = float((out.float() - want).abs().max())
        max_abs = max(max_abs, mae)
        lse_err = float((lse - want_lse).abs().max())
        keyless = (fa._MAX_FLOOR if cap is None else cap) * math.log(2.0)
        keyless_err = float((lse[2] - keyless).abs().max())
        zeros = int(torch.count_nonzero(out[2]))
        if not (err <= KERNEL_REL_TOL and lse_err <= LSE_ABS_TOL and zeros == 0
                and keyless_err <= LSE_ABS_TOL):
            raise AssertionError(f"ragged case (cap {cap}): rel err {err}, lse abs err "
                                 f"{lse_err}, {zeros} nonzero in the length-0 batch, keyless "
                                 f"LSE off by {keyless_err}")
        log(f"[kernel] flash_fwd{'' if cap is None else ' cap'} ragged B={b} N={n} Sq={sq} "
            f"Sk={sk} kv_len={lens} with LSE: rel_err={err:.3e} max_abs_err={mae:.3e} "
            f"lse_abs_err={lse_err:.3e}; length-0 batch exactly 0, its LSE "
            f"{'-1e4' if cap is None else 'cap'} * ln 2")
    return rows, max_abs


def _small_config():
    from dualforce_tpu_torch.config import (AudioDiTConfig, BridgeConfig, MOVAConfig,
                                            VideoDiTConfig)

    return MOVAConfig(
        video_dit=VideoDiTConfig(dim=512, in_dim=36, ffn_dim=1536, out_dim=16,
                                 text_dim=256, freq_dim=64, num_heads=4, num_layers=4,
                                 rope_max_len=64),
        audio_dit=AudioDiTConfig(dim=256, in_dim=32, ffn_dim=768, out_dim=32,
                                 text_dim=256, freq_dim=64, num_heads=2, num_layers=2,
                                 rope_max_len=512),
        bridge=BridgeConfig(visual_layers=4, audio_layers=2, visual_hidden_dim=512,
                            audio_hidden_dim=256, head_dim=128))


def phase_small_step():
    import torch

    from dualforce_tpu_torch.diffusion.step import dual_tower_step
    from dualforce_tpu_torch.models.factory import init_pipeline_params

    cfg = _small_config()
    mods = init_pipeline_params(cfg, device="cuda", dtype=torch.bfloat16, seed=3,
                                with_vaes=False, with_text=False, two_video_towers=False)
    g = torch.Generator("cuda").manual_seed(4)
    visual = torch.randn(1, 36, 3, 32, 48, generator=g, device="cuda")   # 1,152 tokens
    audio = torch.randn(1, 32, 300, generator=g, device="cuda")
    ctx = torch.randn(1, 512, 256, generator=g, device="cuda")
    t = torch.full((1,), 700.0, device="cuda")
    outs = {}
    with torch.no_grad():
        for impl in ("auto", "ref"):
            outs[impl] = dual_tower_step(mods["video_dit"], mods["audio_dit"], mods["bridge"],
                                         visual, audio, ctx, t, attn_impl=impl)
    for i, name in enumerate(("video", "audio")):
        got, want = outs["auto"][i], outs["ref"][i].float()
        err = rel_err(got, want)
        if not (torch.isfinite(got).all() and err <= STEP_REL_TOL):
            raise AssertionError(f"small step {name}: rel err {err}")
        log(f"[small] dual_tower_step {name} {tuple(got.shape)} through the kernel vs "
            f"plain attention: rel_err={err:.3e} (tolerance {STEP_REL_TOL})")


def _check_result(res, request) -> None:
    """uint8 [T, H, W, 3] video and finite audio of the request's length."""
    import numpy as np

    shape = (request["num_frames"], request["height"], request["width"], 3)
    samples = int(48000 * request["num_frames"] / request["video_fps"])
    if res.video.dtype != np.uint8 or res.video.shape != shape:
        raise AssertionError(f"video {res.video.dtype} {res.video.shape}, expected {shape}")
    if res.audio.shape != (samples,) or not np.isfinite(res.audio).all():
        raise AssertionError(f"audio {res.audio.shape}, finite="
                             f"{bool(np.isfinite(res.audio).all())}")


def main_path_config():
    """MOVA-360p widths with `bench.py`'s depth cut: video 3 layers per
    expert, audio 2, bridge shared depth 2 (so the video-only tail runs),
    UMT5 2."""
    import dataclasses

    from dualforce_tpu_torch.config import mova_360p

    base = mova_360p()
    return dataclasses.replace(
        base,
        video_dit=dataclasses.replace(base.video_dit, num_layers=3),
        audio_dit=dataclasses.replace(base.audio_dit, num_layers=2),
        bridge=dataclasses.replace(base.bridge, visual_layers=3, audio_layers=2),
        text_encoder=dataclasses.replace(base.text_encoder, num_layers=2))


def phase_main_path():
    import numpy as np
    import torch

    from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.diffusion.sampler import build_plan
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.ops.flash_attention import flash_attention

    cfg = main_path_config()
    request = REQUEST
    sched = FlowMatchPairScheduler(cfg.scheduler)
    sched.set_timesteps(request["num_inference_steps"], shift=request["sigma_shift"])
    boundary = build_plan(sched, cfg.boundary_ratio).boundary_step
    if not 0 < boundary < request["num_inference_steps"]:
        raise AssertionError(f"boundary_step {boundary}: both experts must run")

    t0 = time.perf_counter()
    modules = init_pipeline_params(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in modules.values() for p in m.parameters())
    log(f"[main] {n_params / 1e9:.2f} B random parameters on the card in "
        f"{time.perf_counter() - t0:.1f} s (video 3 layers x 2 experts, audio 2, "
        f"bridge shared depth 2, UMT5 2; widths of MOVA-360p); boundary_step={boundary}")
    pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(),
                        compute_dtype=torch.bfloat16, device="cuda")

    marks = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            marks[name] = time.perf_counter() - start
            return out
        return run

    step_s = []
    last = [0.0]

    def on_step(step, total):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now

    def denoise(state):
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        return denoise_state(state)

    denoise_state = pipe.denoise_state
    pipe.prepare_state = timed("prepare", pipe.prepare_state)
    pipe.denoise_state = timed("denoise", denoise)
    pipe.finalize_state = timed("decode", pipe.finalize_state)
    pipe.progress_cb = on_step

    rng = np.random.default_rng(0)
    requests = [("a cat playing the piano in a sunlit room", 0),
                ("ocean waves at dusk, gulls calling over the surf", 1)]
    negative = "blurry, low quality, distorted audio"
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0            # the main path's count starts here
    per_request = []
    first = None
    for prompt, seed in requests:
        image = rng.uniform(-1, 1, (request["height"], request["width"], 3)).astype(np.float32)
        before = flash_attention.launches
        step_s.clear()
        res = pipe(prompt, image, negative_prompt=negative, seed=seed, **request)
        launched = flash_attention.launches - before
        per_request.append(launched)
        if first is None:       # phase 17 serves this request again from a checkpoint
            first = dict(prompt=prompt, negative=negative, seed=seed, image=image,
                         video=res.video, audio=res.audio)
        log(f"[main] request seed={seed}: prepare {marks['prepare']:.2f} s, denoise steps "
            f"{', '.join(f'{s:.2f}' for s in step_s)} s, decode {marks['decode']:.2f} s; "
            f"flash launches {launched}")
        _check_result(res, request)
        if launched != LAUNCHES_PER_REQUEST:
            raise AssertionError(f"{launched} flash launches, expected "
                                 f"{LAUNCHES_PER_REQUEST}")
        log(f"[main] video uint8 {res.video.shape} mean {res.video.mean():.2f}; audio "
            f"{res.audio.shape[0]} finite samples, rms {float(np.sqrt(np.mean(res.audio ** 2))):.4f}")
    launches = flash_attention.launches     # ... and is read here
    log(f"[main] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash launches over both requests {launches}")
    if launches == 0:
        raise AssertionError("the main path never launched the flash kernel")
    return launches, cfg, modules, first


def _rand(g, *shape, dtype=None):
    import torch

    return torch.randn(*shape, generator=g, device="cuda", dtype=dtype or torch.bfloat16)


def phase_backward_kernels():
    """The forward with its LSE output and the backward kernel at the
    training path's shapes, against their plain versions, and timed."""
    import torch
    import torch.nn.functional as F

    from dualforce_tpu_torch.ops import flash_attention as fa
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_bwd,
                                                         flash_attention_bwd_plain,
                                                         flash_attention_plain,
                                                         flash_attention_with_lse)

    g = torch.Generator("cuda").manual_seed(1)
    rows, max_abs = [], {"fwd": 0.0, "bwd": 0.0, "prep": 0.0}
    for name, n, sq, sk in TRAIN_PATH_SHAPES:
        q, k, v, do = (_rand(g, 1, s, n, HEAD_DIM) for s in (sq, sk, sk, sq))
        o, lse = flash_attention_with_lse(q, k, v)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        heads = [0, n - 1]
        sub = [x[:, :, heads].float() for x in (q, k, v, o, do)]
        want_o, want_lse = flash_attention_plain(*sub[:3], return_lse=True)
        lse_err = float((lse[:, heads] - want_lse).abs().max())
        o_err = rel_err(o[:, :, heads], want_o)
        want = flash_attention_bwd_plain(*sub[:4], lse[:, heads], sub[4])
        errs = {gn: rel_err(got[:, :, heads], w)
                for gn, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        mae = max(float((got[:, :, heads].float() - w).abs().max())
                  for got, w in zip((dq, dk, dv), want))
        max_abs["fwd"] = max(max_abs["fwd"], float((o[:, :, heads].float() - want_o)
                                                   .abs().max()))
        max_abs["bwd"] = max(max_abs["bwd"], mae)
        if not (lse_err <= LSE_ABS_TOL and o_err <= KERNEL_REL_TOL
                and all(e <= GRAD_REL_TOL for e in errs.values())):
            raise AssertionError(f"{name}: lse abs err {lse_err}, o rel err {o_err}, "
                                 f"grad rel errs {errs}")
        del sub, want_o, want_lse, want, dq, dk, dv
        fwd_ms, _ = time_ms(lambda: flash_attention_with_lse(q, k, v), reps=7, warmup=2)
        fwd_plain_ms, _ = time_ms(lambda: flash_attention_plain(q, k, v, return_lse=True),
                                  reps=3, warmup=1)
        bwd_ms, bwd_host_us = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do),
                                      reps=7, warmup=2)
        bwd_plain_ms, _ = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do),
                                  reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        lib_fwd_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                reps=7, warmup=2)
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib_bwd_ms, _ = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                            retain_graph=True),
                                reps=7, warmup=2)
        fwd_bound, fwd_by = attention_bound_ms(1, n, sq, sk, sk, lse=True)
        bwd_bound, bwd_by = attention_bwd_bound_ms(1, n, sq, sk, sk)
        # the delta preprocess against `_delta`, and the split pair's passes one by one
        prep_err, prep_mae = check_preprocess(fa, o, do, lse)
        max_abs["prep"] = max(max_abs["prep"], prep_mae)
        prep_ms, _ = time_ms(lambda: fa.flash_bwd_preprocess(o, do, lse), reps=7, warmup=2)
        prep_plain_ms, _ = time_ms(lambda: fa._delta(o, do, None), reps=3, warmup=1)
        prep_bound, prep_by = preprocess_bound_ms(1, n, sq)
        passes = fa._Bwd(q, k, v, o, lse, do, None, None, split=True)
        dq_pass_ms, _ = time_ms(passes.dq_pass, reps=7, warmup=2)
        dkv_pass_ms, _ = time_ms(passes.dkv_pass, reps=7, warmup=2)
        del passes
        (dq_bound, _), (dkv_bound, _) = split_pass_bounds_ms(1, n, sq, sk, sk)
        row = dict(shape=name, heads=n, sq=sq, sk=sk, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                   fwd_library_ms=lib_fwd_ms, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
                   bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_library_ms=lib_bwd_ms,
                   bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by, max_abs_err=mae,
                   prep_ms=prep_ms, prep_plain_ms=prep_plain_ms, prep_bound_ms=prep_bound,
                   prep_bound_by=prep_by, prep_rel_err=prep_err, split_dq_pass_ms=dq_pass_ms,
                   split_dq_pass_bound_ms=dq_bound, split_dkv_pass_ms=dkv_pass_ms,
                   split_dkv_pass_bound_ms=dkv_bound)
        rows.append(row)
        log(f"[kernel] flash_fwd+lse {name} N={n} Sq={sq} Sk={sk}: kernel_ms={fwd_ms:.4f} "
            f"bound_ms={fwd_bound:.4f} ({fwd_by}) library_ms={lib_fwd_ms:.4f} "
            f"plain_ms={fwd_plain_ms:.4f} (not a yardstick) lse_abs_err={lse_err:.3e} "
            f"o_rel_err={o_err:.3e}")
        log(f"[kernel] flash_bwd {name} N={n} Sq={sq} Sk={sk}: kernel_ms={bwd_ms:.4f} "
            f"bound_ms={bwd_bound:.4f} ({bwd_by}) library_ms={lib_bwd_ms:.4f} "
            f"(sdpa backward) plain_ms={bwd_plain_ms:.4f} (not a yardstick) "
            + " ".join(f"{gn}_rel_err={e:.3e}" for gn, e in errs.items())
            + f" max_abs_err={mae:.3e} host_us={bwd_host_us:.1f}")
        log(f"[kernel] flash_bwd_preprocess {name} N={n} Sq={sq}: kernel_ms={prep_ms:.4f} "
            f"bound_ms={prep_bound:.4f} ({prep_by}) plain_ms={prep_plain_ms:.4f} (`_delta`, not "
            f"a yardstick) delta_rel_err={prep_err:.3e}")
        log(f"[kernel] flash_bwd split passes {name} N={n} Sq={sq} Sk={sk}: dq_pass_ms="
            f"{dq_pass_ms:.4f} (bound {dq_bound:.4f}, 6 units) dkv_pass_ms={dkv_pass_ms:.4f} "
            f"(bound {dkv_bound:.4f}, 8 units); not this path's route, timed for the split pair")
        del q, k, v, do, o, lse, qt, kt, vt, out, dot
        torch.cuda.empty_cache()

    # per-batch kv lengths, one of them 0, and an LSE cotangent
    b, n, sq, sk, lens = 3, 8, 4096, 512, [512, 77, 0]
    q, do = _rand(g, b, sq, n, HEAD_DIM), _rand(g, b, sq, n, HEAD_DIM)
    k, v = _rand(g, b, sk, n, HEAD_DIM), _rand(g, b, sk, n, HEAD_DIM)
    dlse = _rand(g, b, n, sq, dtype=torch.float32)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = flash_attention_with_lse(q, k, v, kv_len)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, kv_len, dlse)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), kv_len, dlse)
    errs = {gn: rel_err(got, w) for gn, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    mae = max(float((got.float() - w).abs().max()) for got, w in zip((dq, dk, dv), want))
    max_abs["bwd"] = max(max_abs["bwd"], mae)
    nonzero = int(torch.count_nonzero(dq[2])) + sum(
        int(torch.count_nonzero(x[i, length:])) for x in (dk, dv)
        for i, length in enumerate(lens))
    if not all(e <= GRAD_REL_TOL for e in errs.values()) or nonzero:
        raise AssertionError(f"masked backward: rel errs {errs}, {nonzero} nonzero where "
                             f"exact zeros are due")
    prep_err, prep_mae = check_preprocess(fa, o, do, lse, dlse)
    max_abs["prep"] = max(max_abs["prep"], prep_mae)
    log(f"[kernel] flash_bwd masked B={b} N={n} Sq={sq} Sk={sk} kv_len={lens} with dlse: "
        + " ".join(f"{gn}_rel_err={e:.3e}" for gn, e in errs.items())
        + f" max_abs_err={mae:.3e}; length-0 dq and masked dk/dv exactly 0; preprocess "
        f"delta_rel_err={prep_err:.3e}")

    # autograd: a backward through `flash_attention` reaches q, k and v through the kernels
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    flash_attention(q, k, v, kv_len).backward(do)
    torch.cuda.synchronize()
    launched = (flash_attention.launches - fwd, flash_attention_bwd.launches - bwd)
    empty = [name for name, x in zip("qkv", (q, k, v))
             if x.grad is None or not torch.count_nonzero(x.grad)]
    if empty or launched != (1, 1):
        raise AssertionError(f"autograd through the kernels: grads None or zero for "
                             f"{empty}, launches (fwd, bwd) {launched}")
    log("[kernel] autograd through flash_attention: q.grad, k.grad, v.grad nonzero; one "
        "forward (with LSE) and one backward launch")
    return rows, max_abs


def _train_tables(cfg):
    from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
    from dualforce_tpu_torch.diffusion.training import build_train_tables

    sched = FlowMatchPairScheduler(cfg.scheduler)
    sched.set_timesteps(cfg.scheduler.num_train_timesteps, training=True)
    return build_train_tables(sched, cfg.boundary_ratio)


def phase_small_backward(split: bool = False):
    """LoRA gradients of one training loss through the kernels against the
    same through plain fp32 attention. With `split`, every backward is routed
    to the split kernels for this one run (the routing predicate replaced
    here; the package has no switch)."""
    import torch

    from dualforce_tpu_torch.diffusion.training import lora_grads
    from dualforce_tpu_torch.engine import lora as lora_mod
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.ops import flash_attention as fa

    cfg = _small_config()
    mods = init_pipeline_params(cfg, device="cuda", dtype=torch.bfloat16, seed=3,
                                with_vaes=False, with_text=False, two_video_towers=False)
    g = torch.Generator("cuda").manual_seed(5)
    enc = {"video_latents": _rand(g, 1, 16, 3, 32, 48, dtype=torch.float32),   # 1,152 tokens
           "condition": _rand(g, 1, 20, 3, 32, 48, dtype=torch.float32),
           "audio_latents": _rand(g, 1, 32, 300, dtype=torch.float32),
           "context": _rand(g, 1, 512, 256)}
    noise = (_rand(g, 1, 16, 3, 32, 48, dtype=torch.float32),
             _rand(g, 1, 32, 300, dtype=torch.float32))
    host = torch.Generator().manual_seed(6)
    lora = lora_mod.init_pipeline_lora(mods, 16, host)
    with torch.no_grad():            # nonzero b, so both factors get gradients
        for p in lora_mod.lora_parameters(lora)[1::2]:
            p.copy_(torch.randn(p.shape, generator=host) * 1e-2)
    tables = _train_tables(cfg)
    flat = {}
    takes_split = fa.bwd_takes_split
    if split:
        fa.bwd_takes_split = lambda sq, d=HEAD_DIM: True
    try:
        for impl in ("auto", "ref"):
            before = (fa.flash_attention_bwd.launches, fa.flash_attention_bwd.split_launches)
            grads, _ = lora_grads(lora, mods, cfg, tables, enc, None, 0,
                                  compute_dtype=torch.bfloat16, remat=True, attn_impl=impl,
                                  noise_override=noise, timestep_id=100, device="cuda")
            flat[impl] = torch.cat([x.float().flatten() for x in grads])
            fused = fa.flash_attention_bwd.launches - before[0]
            splits = fa.flash_attention_bwd.split_launches - before[1]
            want_launch = impl == "auto"
            if (fused > 0, splits > 0) != (want_launch and not split, want_launch and split):
                raise AssertionError(f"attn_impl={impl}: {fused} fused and {splits} split "
                                     f"backward launches")
            if want_launch:
                launched = splits if split else fused
    finally:
        fa.bwd_takes_split = takes_split
    err = rel_err(flat["auto"], flat["ref"])
    if not (torch.isfinite(flat["auto"]).all() and err <= LORA_GRAD_REL_TOL):
        raise AssertionError(f"small backward: LoRA grads rel err {err}")
    route = "split" if split else "routed (fused at this size)"
    log(f"[small] training_loss LoRA grads ({flat['auto'].numel()} values) through the "
        f"kernels, backward {route}, vs plain attention: rel_err={err:.3e} (tolerance "
        f"{LORA_GRAD_REL_TOL}); {launched} backward launches")


def _synthetic_clips(count: int, height: int = 352, width: int = 640, num_frames: int = 49,
                     audio_samples: int = int(48000 * 49 / 24)):
    """Clips from a numpy seed (by default the 360p training recipe's):
    uniform video in [-1, 1], a tone plus noise for audio, a byte-tokenised
    caption."""
    import numpy as np

    rng = np.random.default_rng(0)
    tok = ByteTokenizer()
    t = np.arange(audio_samples) / 48000.0
    for i in range(count):
        ids = tok([f"clip {i}: a drummer on a rooftop at dusk"], max_length=512)
        audio = 0.3 * np.sin(2 * np.pi * 110.0 * (i + 2) * t) + 0.05 * rng.standard_normal(t.size)
        yield {"video": rng.uniform(-1, 1, (1, num_frames, height, width, 3)).astype(np.float32),
               "audio": audio.astype(np.float32)[None, None],
               "text_ids": ids["input_ids"], "text_mask": ids["attention_mask"]}


def phase_train_path(cfg, modules, root: str):
    """`LoRATrainer` for TRAIN_STEPS optimizer steps at the 360p recipe."""
    import shutil

    import torch

    from dualforce_tpu_torch.engine import lora as lora_mod
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                         flash_bwd_preprocess)

    save_dir = os.path.join(root, "build", "chip_smoke_train")
    shutil.rmtree(save_dir, ignore_errors=True)
    tcfg = TrainerConfig(lr=1e-4, weight_decay=1e-2, warmup_steps=100,
                         max_steps=TRAIN_STEPS, lr_schedule="cosine", lora_rank=16,
                         lora_alpha=16.0, log_interval=1, save_interval=1000,
                         save_dir=save_dir, logger="jsonl", remat=True)
    trainer = LoRATrainer(cfg, modules, tcfg, device="cuda")
    n_lora = sum(p.numel() for p in lora_mod.lora_parameters(trainer.lora))
    log(f"[train] LoRATrainer on the main path's modules: {n_lora / 1e6:.2f} M LoRA "
        f"parameters (rank 16) over {sum(len(t) for t in trainer.lora.values())} weights")

    steps = []
    torch.cuda.reset_peak_memory_stats()
    # the train path's counts
    flash_attention.launches = flash_attention_bwd.launches = 0
    flash_attention_bwd.split_launches = flash_bwd_preprocess.launches = 0
    t0 = time.perf_counter()
    final = trainer.train(_synthetic_clips(TRAIN_STEPS), on_micro_step=steps.append)
    wall = time.perf_counter() - t0
    launches = {"fwd": flash_attention.launches, "bwd": flash_attention_bwd.launches,
                "split": flash_attention_bwd.split_launches,
                "prep": flash_bwd_preprocess.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, st in enumerate(steps):
        log(f"[train] step {i + 1}: expert {st['expert']} timestep {st['timestep']:.1f} "
            f"loss {st['loss']:.5f} (video {st['video_loss']:.5f}, audio "
            f"{st['audio_loss']:.5f}) grad_norm {st['grad_norm']:.5f}; encode "
            f"{st['encode_s']:.3f} s, loss+backward {st['loss_backward_s']:.3f} s, "
            f"optimizer {st['optimizer_s']:.4f} s; flash launches fwd {st['flash_fwd']} "
            f"bwd {st['flash_bwd']}")
    log(f"[train] {final} steps in {wall:.2f} s (saves included); max_memory_allocated "
        f"{peak:.2f} GiB; flash launches over the phase fwd {launches['fwd']} "
        f"bwd {launches['bwd']} preprocess {launches['prep']}")
    if launches["prep"] != launches["bwd"] + launches["split"]:
        raise AssertionError(f"preprocess launches {launches['prep']}, one per backward due")

    if final != TRAIN_STEPS or [st["expert"] for st in steps] != [0, 1, 0, 1]:
        raise AssertionError(f"{final} steps, experts {[st['expert'] for st in steps]}")
    for st in steps:
        values = [st[k] for k in ("loss", "video_loss", "audio_loss", "grad_norm")]
        if not all(math.isfinite(x) for x in values) or st["grad_norm"] <= 0:
            raise AssertionError(f"non-finite or zero metrics {st}")
        if (st["flash_fwd"], st["flash_bwd"], st["flash_bwd_split"]) != (
                TRAIN_FWD_LAUNCHES, TRAIN_BWD_LAUNCHES, 0):
            raise AssertionError(f"flash launches per micro-step fwd {st['flash_fwd']} bwd "
                                 f"{st['flash_bwd']} split {st['flash_bwd_split']}, expected "
                                 f"{TRAIN_FWD_LAUNCHES}, {TRAIN_BWD_LAUNCHES} and 0")
    for mod, tree in trainer.lora.items():
        zero = [n for n, ab in tree.items() if not torch.count_nonzero(ab["b"])]
        if zero:
            raise AssertionError(f"{mod}: LoRA b still zero at {zero[:3]}")
    back, _ = lora_mod.load_lora(os.path.join(save_dir, f"step-{final}", "lora_weights.npz"),
                                 cfg.bridge.interaction_layers())
    for mod, tree in trainer.lora.items():
        for name, ab in tree.items():
            for part in ("a", "b"):
                if not torch.equal(back[mod][name][part], ab[part].detach().cpu()):
                    raise AssertionError(f"saved LoRA differs at {mod} {name} {part}")
    log(f"[train] experts 0, 1, 0, 1; every module's LoRA b nonzero; "
        f"step-{final}/lora_weights.npz reloads equal to the live LoRA")
    return launches


def sage_bound_ms(b: int, n: int, sq: int, sk_valid: int, sk: int):
    """Least time on an H100 SXM for the sage kernel: 2*Sq*Sk*D int8
    operations for Q.K^T at the int8 rate plus 2*Sq*Sk*D bf16 flops for P.V
    at the bf16 rate, over the keys this input leaves valid, against int8 q
    and k, bf16 v and o and the fp32 per-row and per-key scales moved once."""
    work = 2 * b * n * sq * sk_valid * HEAD_DIM
    t_ops = work / PEAK_INT8_OPS + work / PEAK_BF16_FLOPS
    nbytes = b * n * HEAD_DIM * (sq + sk + 2 * sk + 2 * sq) + 4 * b * n * (sq + sk)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sage_prologue_bound_ms(b: int, n: int, sq: int, sk: int):
    """Least time on an H100 SXM for sage's quantization prologue: bf16 q
    and k read once, int8 q and k and the fp32 per-row and per-key scales
    written once; its arithmetic (a subtract, a max, a divide and a round
    per element) is far below the bytes' time at the fp32 rate."""
    nbytes = b * n * (sq + sk) * (2 * HEAD_DIM + HEAD_DIM + 4)
    t_ops, t_bytes = 4 * b * n * (sq + sk) * HEAD_DIM / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_prologue(sa, q, k, kv_len=None):
    """The CUDA prologue against `sage_quantize_plain`: Q's codes and scales
    bit-equal; K's codes at most 1 apart in at most 1e-4 of the elements,
    its scales within 1e-6 relative (K's mean summed in another order).
    Returns (K codes that differ, the K scales' relative error)."""
    import torch

    got = sa.sage_quantize(q, k, kv_len)
    torch.cuda.synchronize()
    want = sa.sage_quantize_plain(q, k, kv_len)
    diff = (got[1].int() - want[1].int()).abs()
    k_codes, k_max = int(torch.count_nonzero(diff)), int(diff.max())
    k_scale_err = float(((got[3] - want[3]).abs() / want[3]).max())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]) and k_max <= 1
            and k_codes <= PROLOGUE_CODE_SHARE * diff.numel()
            and k_scale_err <= PROLOGUE_SCALE_TOL):
        raise AssertionError(f"sage prologue: q codes equal {torch.equal(got[0], want[0])}, "
                             f"q scales equal {torch.equal(got[2], want[2])}, k codes "
                             f"{k_codes} differ (max {k_max}), k scales rel err {k_scale_err}")
    return k_codes, k_scale_err


def _check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: relative L2 error {err} > {tol}")


def phase_precision_kernels():
    """The cap mode and the sage kernel at the main path's shapes against
    their plain versions, and timed."""
    import torch
    import torch.nn.functional as F

    from dualforce_tpu_torch.ops import sage_attention as sa
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_plain,
                                                         flash_attention_with_lse)

    cap = FAST_SOFTMAX_CAP
    g = torch.Generator("cuda").manual_seed(7)
    rows = {"cap": [], "sage": [], "prologue": []}
    max_abs = {"cap": 0.0, "sage": 0.0, "prologue": 0.0}
    for name, n, sq, sk in MAIN_PATH_SHAPES:
        q, k, v = (_rand(g, 1, s, n, HEAD_DIM) for s in (sq, sk, sk))
        heads = [0, n - 1]
        sub = [x[:, :, heads] for x in (q, k, v)]
        # cap mode
        out = flash_attention(q, k, v, softmax_cap=cap)
        torch.cuda.synchronize()
        want = flash_attention_plain(*(x.float() for x in sub), softmax_cap=cap)
        got = out[:, :, heads]
        cap_err, cap_mae = rel_err(got, want), float((got.float() - want).abs().max())
        _check(f"cap {name}", cap_err, KERNEL_REL_TOL)
        exact = flash_attention_plain(*(x.float() for x in sub))
        # sage, on the CUDA prologue's quantization of all heads, held to the plain
        # prologue first
        k_codes, k_scale_err = check_prologue(sa, q, k)
        max_abs["prologue"] = max(max_abs["prologue"], 1.0 if k_codes else 0.0)
        qi, ki, qs, ks = sa.sage_quantize(q, k)
        sout = sa.sage_fwd(qi, ki, v, qs, ks)
        torch.cuda.synchronize()
        swant = sa.sage_fwd_plain(qi[:, :, heads], ki[:, :, heads], sub[2].float(),
                                  qs[:, heads], ks[:, heads])
        sgot = sout[:, :, heads]
        sage_err, sage_mae = rel_err(sgot, swant), float((sgot.float() - swant).abs().max())
        _check(f"sage {name}", sage_err, KERNEL_REL_TOL)
        sage_exact_err = rel_err(sgot, exact)
        max_abs["cap"] = max(max_abs["cap"], cap_mae)
        max_abs["sage"] = max(max_abs["sage"], sage_mae)
        del want, got, exact, swant, sgot, out, sout

        cap_ms, cap_host_us = time_ms(lambda: flash_attention(q, k, v, softmax_cap=cap),
                                      reps=7, warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                reps=7, warmup=2)
        sub_f = [x.float() for x in sub]
        cap_plain_ms, _ = time_ms(lambda: flash_attention_plain(*sub_f, softmax_cap=cap),
                                  reps=3, warmup=1)
        sage_ms, sage_host_us = time_ms(lambda: sa.sage_fwd(qi, ki, v, qs, ks),
                                        reps=7, warmup=2)
        prologue_ms, prologue_host_us = time_ms(lambda: sa.sage_quantize(q, k), reps=7, warmup=2)
        prologue_plain_ms, _ = time_ms(lambda: sa.sage_quantize_plain(q, k), reps=3, warmup=1)
        prologue_bound, prologue_by = sage_prologue_bound_ms(1, n, sq, sk)
        ssub = (qi[:, :, heads].contiguous(), ki[:, :, heads].contiguous(), sub_f[2],
                qs[:, heads].contiguous(), ks[:, heads].contiguous())
        sage_plain_ms, _ = time_ms(lambda: sa.sage_fwd_plain(*ssub), reps=3, warmup=1)
        cap_bound, cap_by = attention_bound_ms(1, n, sq, sk, sk)
        sage_bound, sage_by = sage_bound_ms(1, n, sq, sk, sk)
        bq, bk = sa.sage_blocks(sq, sk, False)
        splits = sa.fwd_splits(n * -(-sq // sa.FWD_BLOCK_M), sk, sa._sm_count(q.device))
        rows["cap"].append(dict(shape=name, heads=n, sq=sq, sk=sk, kernel_ms=cap_ms,
                                plain_ms_2_heads=cap_plain_ms, library_ms=library_ms,
                                bound_ms=cap_bound, bound_by=cap_by, rel_err=cap_err,
                                max_abs_err=cap_mae))
        rows["sage"].append(dict(shape=name, heads=n, sq=sq, sk=sk, kernel_ms=sage_ms,
                                 plain_ms_2_heads=sage_plain_ms, library_ms=None,
                                 bound_ms=sage_bound, bound_by=sage_by, rel_err=sage_err,
                                 exact_rel_err=sage_exact_err, max_abs_err=sage_mae,
                                 blocks=(bq, bk), splits=splits, cap_ms=cap_ms))
        rows["prologue"].append(dict(shape=name, heads=n, sq=sq, sk=sk, kernel_ms=prologue_ms,
                                     plain_ms=prologue_plain_ms, bound_ms=prologue_bound,
                                     bound_by=prologue_by, k_codes_differing=k_codes,
                                     k_scale_rel_err=k_scale_err))
        log(f"[kernel] flash_fwd cap {name} N={n} Sq={sq} Sk={sk}: kernel_ms={cap_ms:.4f} "
            f"bound_ms={cap_bound:.4f} ({cap_by}) library_ms={library_ms:.4f} "
            f"plain_ms={cap_plain_ms:.4f} (2 heads, not a yardstick) rel_err={cap_err:.3e} "
            f"max_abs_err={cap_mae:.3e} host_us={cap_host_us:.1f}")
        log(f"[kernel] sage_fwd {name} N={n} Sq={sq} Sk={sk} blocks {bq}/{bk} splits={splits}: "
            f"kernel_ms={sage_ms:.4f} cap_mode_ms={cap_ms:.4f} (the yardstick) "
            f"bound_ms={sage_bound:.4f} ({sage_by}) library_ms=none plain_ms="
            f"{sage_plain_ms:.4f} (2 heads, not a yardstick) rel_err={sage_err:.3e} "
            f"max_abs_err={sage_mae:.3e} vs exact fp32 {sage_exact_err:.3e} (JAX's bound "
            f"{SAGE_EXACT_REL_TOL}, informative) host_us={sage_host_us:.1f}")
        log(f"[kernel] sage_quantize {name} N={n} Sq={sq} Sk={sk}: kernel_ms={prologue_ms:.4f} "
            f"bound_ms={prologue_bound:.4f} ({prologue_by}) plain_ms={prologue_plain_ms:.4f} "
            f"(`sage_quantize_plain`, not a yardstick) host_us={prologue_host_us:.1f}; q codes "
            f"and scales bit-equal to plain, {k_codes} k codes differ by 1, k scales rel err "
            f"{k_scale_err:.3e}")
        del q, k, v, qt, kt, vt, sub, sub_f, qi, ki, qs, ks, ssub
        torch.cuda.empty_cache()

    # per-batch kv lengths, one of them 0: that batch must come back exactly 0
    b, n, sq, sk, lens = 3, 8, 4096, 512, [512, 77, 0]
    q, k, v = (_rand(g, b, s, n, HEAD_DIM) for s in (sq, sk, sk))
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, lse = flash_attention_with_lse(q, k, v, kv_len, softmax_cap=cap)
    check_prologue(sa, q, k, kv_len)
    qi, ki, qs, ks = sa.sage_quantize(q, k, kv_len)
    sout = sa.sage_fwd(qi, ki, v, qs, ks, kv_len)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_plain(q.float(), k.float(), v.float(), kv_len,
                                           return_lse=True, softmax_cap=cap)
    swant = sa.sage_fwd_plain(qi, ki, v.float(), qs, ks, kv_len)
    errs = {"cap": rel_err(out, want), "sage": rel_err(sout, swant)}
    lse_err = float((lse - want_lse).abs().max())
    zeros = int(torch.count_nonzero(out[2])) + int(torch.count_nonzero(sout[2]))
    keyless_lse = float((lse[2] - cap * math.log(2.0)).abs().max())
    max_abs["cap"] = max(max_abs["cap"], float((out.float() - want).abs().max()))
    max_abs["sage"] = max(max_abs["sage"], float((sout.float() - swant).abs().max()))
    if not (all(e <= KERNEL_REL_TOL for e in errs.values()) and lse_err <= LSE_ABS_TOL
            and zeros == 0 and keyless_lse <= LSE_ABS_TOL):
        raise AssertionError(f"masked precision case: rel errs {errs}, lse abs err "
                             f"{lse_err}, {zeros} nonzero in the length-0 batch, keyless "
                             f"LSE off by {keyless_lse}")
    log(f"[kernel] masked B={b} N={n} Sq={sq} Sk={sk} kv_len={lens}: cap (with LSE) "
        f"rel_err={errs['cap']:.3e} lse_abs_err={lse_err:.3e} (keyless rows cap*ln2); sage "
        f"rel_err={errs['sage']:.3e} (its prologue held to plain); the length-0 batch exactly "
        f"0 in both")
    return rows, max_abs


def phase_precision_step():
    """The phase-4 step through the cap mode and through sage."""
    import torch

    from dualforce_tpu_torch import nn as dnn
    from dualforce_tpu_torch.diffusion.step import dual_tower_step
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.ops import attention as att
    from dualforce_tpu_torch.ops import sage_attention as sa
    from dualforce_tpu_torch.ops.flash_attention import flash_attention

    cfg = _small_config()
    mods = init_pipeline_params(cfg, device="cuda", dtype=torch.bfloat16, seed=3,
                                with_vaes=False, with_text=False, two_video_towers=False)
    towers = {"plain": mods, "int8": {name: dnn.quantize_modules(m, "int8")
                                      for name, m in mods.items()}}
    g = torch.Generator("cuda").manual_seed(4)
    visual = torch.randn(1, 36, 3, 32, 48, generator=g, device="cuda")   # 1,152 tokens
    audio = torch.randn(1, 32, 300, generator=g, device="cuda")
    ctx = torch.randn(1, 512, 256, generator=g, device="cuda")
    t = torch.full((1,), 700.0, device="cuda")

    def step(m, impl):
        with torch.no_grad():
            return dual_tower_step(m["video_dit"], m["audio_dit"], m["bridge"], visual, audio,
                                   ctx, t, attn_impl=impl)

    def compare(what, got, want, launched):
        for i, name in enumerate(("video", "audio")):
            err = rel_err(got[i], want[i].float())
            if not (torch.isfinite(got[i]).all() and err <= STEP_REL_TOL) or not launched:
                raise AssertionError(f"small step {what} {name}: rel err {err}, "
                                     f"{launched} kernel launches")
            log(f"[small] dual_tower_step {what} {name}: rel_err={err:.3e} (tolerance "
                f"{STEP_REL_TOL}); {launched} kernel launches")

    before = flash_attention.cap_launches
    fast = step(mods, "fast")
    compare("fast (cap-mode kernel) vs ref", fast, step(mods, "ref"),
            flash_attention.cap_launches - before)
    for kind, m in towers.items():
        before = sa.sage_attention.launches
        kernel = step(m, "sage")
        launched = sa.sage_attention.launches - before
        att.sage_attention = sa.sage_attention_plain     # the same route, plain version
        try:
            plain = step(m, "sage")
        finally:
            att.sage_attention = sa.sage_attention
        if sa.sage_attention.launches - before != launched:
            raise AssertionError("the plain sage run launched the kernel")
        compare(f"sage kernel vs sage plain ({kind} towers)", kernel, plain, launched)


def _module_bytes(modules) -> int:
    seen = {}
    for m in modules:
        for x in list(m.parameters()) + list(m.buffers()):
            seen[x.data_ptr()] = x.numel() * x.element_size()
    return sum(seen.values())


def phase_precision_serving(cfg, modules):
    """One request each through ("sage", int8) and ("fast", int4) on the main
    path's modules."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.diffusion.pipeline import QUANTIZED_TOWERS, MOVAPipeline
    from dualforce_tpu_torch.ops import sage_attention as sa
    from dualforce_tpu_torch.ops.flash_attention import flash_attention

    request = REQUEST
    towers = [modules[n] for n in QUANTIZED_TOWERS if n in modules]
    bf16_bytes = _module_bytes(towers)
    before_state = {n: {k: v.data_ptr() for k, v in modules[n].state_dict().items()}
                    for n in QUANTIZED_TOWERS if n in modules}
    rng = np.random.default_rng(1)
    launches = {}
    for impl, mode, prompt, seed in (("sage", "int8", "a violinist on a rainy street", 2),
                                     ("fast", "int4", "a steam train crossing a bridge", 3)):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(),
                            compute_dtype=torch.bfloat16, device="cuda", attn_impl=impl,
                            quantize=mode)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - mem0
        q_bytes = _module_bytes([pipe.modules[n] for n in QUANTIZED_TOWERS if n in modules])
        step_s, last = [], [0.0]

        def on_step(step, total):
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_s.append(now - last[0])
            last[0] = now

        pipe.progress_cb = on_step
        image = rng.uniform(-1, 1, (request["height"], request["width"], 3)).astype(np.float32)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention.cap_launches = 0   # this path's counts
        sa.sage_attention.launches = sa.sage_quantize.launches = 0
        t0 = time.perf_counter()
        state = pipe.prepare_state([prompt], [image], negative_prompts=["blurry"],
                                   seeds=[seed], **request)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        last[0] = time.perf_counter()
        state = pipe.denoise_state(state)
        t0 = time.perf_counter()
        res = pipe.finalize_state(state)[0]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts = {"exact": flash_attention.launches, "cap": flash_attention.cap_launches,
                  "sage": sa.sage_attention.launches, "prologue": sa.sage_quantize.launches}
        launches[impl] = counts
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[precision] attn_impl={impl} quantize={mode}: quantized the towers in "
            f"{quant_s:.2f} s; towers {q_bytes / 2**30:.3f} GiB quantized (+"
            f"{added / 2**30:.3f} GiB allocated) against {bf16_bytes / 2**30:.3f} GiB bf16; "
            f"prepare {prepare_s:.2f} s, denoise steps "
            f"{', '.join(f'{x:.2f}' for x in step_s)} s, decode {decode_s:.2f} s; peak "
            f"{peak:.2f} GiB; launches {counts}")
        _check_result(res, request)
        want = ({"exact": 0, "cap": 0, "sage": LAUNCHES_PER_REQUEST,
                 "prologue": LAUNCHES_PER_REQUEST} if impl == "sage" else
                {"exact": 0, "cap": LAUNCHES_PER_REQUEST, "sage": 0, "prologue": 0})
        if counts != want:
            raise AssertionError(f"attn_impl={impl}: launches {counts}, expected {want}")
        log(f"[precision] video uint8 {res.video.shape} mean {res.video.mean():.2f}; audio "
            f"{res.audio.shape[0]} finite samples, rms "
            f"{float(np.sqrt(np.mean(res.audio ** 2))):.4f}")
        del pipe, state, res
        torch.cuda.empty_cache()
    after_state = {n: {k: v.data_ptr() for k, v in modules[n].state_dict().items()}
                   for n in before_state}
    from dualforce_tpu_torch.nn import Int4Linear, Int8Linear

    if after_state != before_state or any(isinstance(m, (Int8Linear, Int4Linear))
                                          for t in towers for m in t.modules()):
        raise AssertionError("quantizing changed the caller's modules")
    log("[precision] the main path's bf16 modules are unchanged")
    return launches


def time_long_ms(fn, reps: int = 2, warmup: int = 1) -> float:
    """Device ms per call for calls that last seconds: the mean of `reps`
    calls, each between two CUDA events, after `warmup` calls (0 where the
    caller's checked call has just warmed it)."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_720p_backward_kernels():
    """The forward with its LSE output and the routed backward at the 720p
    micro-step's six shapes against their plain versions on two heads, the
    fused kernel beside the split pair at the split shapes, a masked case
    with an LSE cotangent through the split kernels, and the phase-7 LoRA
    backward with every backward routed to the split kernels; timed."""
    import torch
    import torch.nn.functional as F

    from dualforce_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(11)
    rows, max_abs = [], {"fwd": 0.0, "fused": 0.0, "split": 0.0, "prep": 0.0}
    for name, n, sq, sk in TRAIN_720P_SHAPES:
        split = fa.bwd_takes_split(sq)
        route = "split" if split else "fused"
        q, k, v, do = (_rand(g, 1, s, n, HEAD_DIM) for s in (sq, sk, sk, sq))
        o, lse = fa.flash_attention_with_lse(q, k, v)
        before = (fa.flash_attention_bwd.launches, fa.flash_attention_bwd.split_launches)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        launched = (fa.flash_attention_bwd.launches - before[0],
                    fa.flash_attention_bwd.split_launches - before[1])
        if launched != ((0, 1) if split else (1, 0)):
            raise AssertionError(f"{name}: backward launches (fused, split) {launched}, "
                                 f"expected the {route} route")
        heads = [0, n - 1]
        sub = [x[:, :, heads].float() for x in (q, k, v, o, do)]
        t0 = time.perf_counter()
        want_o, want_lse = fa.flash_attention_plain(*sub[:3], return_lse=True)
        want = fa.flash_attention_bwd_plain(*sub[:4], lse[:, heads], sub[4])
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        lse_err = float((lse[:, heads] - want_lse).abs().max())
        o_err = rel_err(o[:, :, heads], want_o)
        errs = {gn: rel_err(got[:, :, heads], w)
                for gn, got, w in zip(("dq", "dk", "dv"), grads, want)}
        mae = max(float((got[:, :, heads].float() - w).abs().max())
                  for got, w in zip(grads, want))
        max_abs["fwd"] = max(max_abs["fwd"], float((o[:, :, heads].float() - want_o)
                                                   .abs().max()))
        max_abs[route] = max(max_abs[route], mae)
        if not (lse_err <= LSE_ABS_TOL and o_err <= KERNEL_REL_TOL
                and all(e <= GRAD_REL_TOL for e in errs.values())):
            raise AssertionError(f"720p {name}: lse abs err {lse_err}, o rel err {o_err}, "
                                 f"grad rel errs {errs}")
        del want_o, want_lse, want
        long = max(sq, sk) >= 100_000
        if long:     # the checked calls above were the warm-ups
            fwd_ms = time_long_ms(lambda: fa.flash_attention_with_lse(q, k, v), warmup=0)
            bwd_ms = time_long_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                                  warmup=0)
            plain_fwd_ms = time_long_ms(
                lambda: fa.flash_attention_plain(*sub[:3], return_lse=True), warmup=0)
            plain_bwd_ms = time_long_ms(
                lambda: fa.flash_attention_bwd_plain(*sub[:4], lse[:, heads], sub[4]),
                warmup=0)
        else:
            fwd_ms, _ = time_ms(lambda: fa.flash_attention_with_lse(q, k, v), reps=7, warmup=2)
            bwd_ms, _ = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                                reps=7, warmup=2)
            plain_fwd_ms, _ = time_ms(
                lambda: fa.flash_attention_plain(*sub[:3], return_lse=True), reps=3, warmup=1)
            plain_bwd_ms, _ = time_ms(
                lambda: fa.flash_attention_bwd_plain(*sub[:4], lse[:, heads], sub[4]),
                reps=3, warmup=1)
        fused_note, fused_ms = "", None
        if split:    # the fused kernel on the same inputs: its time and its gap to the split's
            fused = fa.flash_attention_bwd_fused(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            gap = {gn: rel_err(a, b.float()) for gn, a, b in zip(("dq", "dk", "dv"), grads,
                                                                  fused)}
            equal_kv = bool(torch.equal(grads[1], fused[1]) and torch.equal(grads[2], fused[2]))
            del fused
            if long:
                fused_ms = time_long_ms(lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse,
                                                                             do), warmup=0)
            else:
                fused_ms, _ = time_ms(lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse, do),
                                      reps=7, warmup=2)
            fused_note = (f" fused_ms={fused_ms:.4f} (the fused kernel on the same inputs; "
                          f"split vs fused: " + " ".join(f"{gn}_rel={e:.3e}"
                                                          for gn, e in gap.items())
                          + f", dk/dv bit-equal {equal_kv})")
        del grads
        timer = ((lambda fn: time_long_ms(fn, warmup=1)) if long else
                 (lambda fn: time_ms(fn, reps=7, warmup=2)[0]))
        pass_note, dq_pass_ms, dkv_pass_ms, dq_bound, dkv_bound = "", None, None, None, None
        if split:    # the split pair's passes one by one, each beside its own bound
            passes = fa._Bwd(q, k, v, o, lse, do, None, None, split=True)
            dq_pass_ms, dkv_pass_ms = timer(passes.dq_pass), timer(passes.dkv_pass)
            del passes
            (dq_bound, _), (dkv_bound, _) = split_pass_bounds_ms(1, n, sq, sk, sk)
            pass_note = (f" dq_pass_ms={dq_pass_ms:.4f} (bound {dq_bound:.4f}, 6 units) "
                         f"dkv_pass_ms={dkv_pass_ms:.4f} (bound {dkv_bound:.4f}, 8 units)")
        nolse_note, nolse_ms = "", None
        if name == "video_self":   # the forward without the LSE: the LSE's cost apart
            o_nolse = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if not torch.equal(o_nolse, o):
                raise AssertionError("720p video_self: the forward without the LSE differs from "
                                     "the forward with it")
            del o_nolse
            nolse_ms = time_long_ms(lambda: fa.flash_attention(q, k, v), warmup=0)
            nolse_note = f" nolse_ms={nolse_ms:.4f} (the forward without the LSE, o bit-equal)"
        prep_note, prep = "", None
        if name == "video_self":   # the delta preprocess at the path's largest query length
            prep_err, prep_mae = check_preprocess(fa, o, do, lse)
            prep_ms = timer(lambda: fa.flash_bwd_preprocess(o, do, lse))
            prep_plain_ms = timer(lambda: fa._delta(o, do, None))
            prep_bound, prep_by = preprocess_bound_ms(1, n, sq)
            max_abs["prep"] = max(max_abs["prep"], prep_mae)
            prep = dict(ms=prep_ms, plain_ms=prep_plain_ms, bound_ms=prep_bound,
                        bound_by=prep_by)
            prep_note = (f" preprocess_ms={prep_ms:.4f} (bound {prep_bound:.4f}, {prep_by}; "
                         f"`_delta` {prep_plain_ms:.4f}, not a yardstick; "
                         f"delta_rel_err={prep_err:.3e})")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        lib_fwd_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

        lib_bwd_ms = (time_long_ms(sdpa_bwd) if long else
                      time_ms(sdpa_bwd, reps=7, warmup=2)[0])
        fwd_bound, fwd_by = attention_bound_ms(1, n, sq, sk, sk, lse=True)
        bwd_bound, bwd_by = attention_bwd_bound_ms(1, n, sq, sk, sk)
        rows.append(dict(shape=name, heads=n, sq=sq, sk=sk, route=route, fwd_ms=fwd_ms,
                         fwd_plain_ms_2_heads=plain_fwd_ms, fwd_bound_ms=fwd_bound,
                         fwd_library_ms=lib_fwd_ms, bwd_ms=bwd_ms,
                         bwd_plain_ms_2_heads=plain_bwd_ms, bwd_library_ms=lib_bwd_ms,
                         bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by, fused_ms=fused_ms,
                         split_dq_pass_ms=dq_pass_ms, split_dq_pass_bound_ms=dq_bound,
                         split_dkv_pass_ms=dkv_pass_ms, split_dkv_pass_bound_ms=dkv_bound,
                         preprocess=prep, max_abs_err=mae, fwd_nolse_ms=nolse_ms))
        log(f"[720p] flash_fwd+lse {name} N={n} Sq={sq} Sk={sk}: kernel_ms={fwd_ms:.4f} "
            f"bound_ms={fwd_bound:.4f} ({fwd_by}) library_ms={lib_fwd_ms:.4f} (sdpa forward) "
            f"plain_ms={plain_fwd_ms:.4f} (2 heads, not a yardstick) lse_abs_err={lse_err:.3e} "
            f"o_rel_err={o_err:.3e}" + nolse_note)
        log(f"[720p] flash_bwd ({route}) {name} N={n} Sq={sq} Sk={sk}: kernel_ms={bwd_ms:.4f} "
            f"bound_ms={bwd_bound:.4f} ({bwd_by}) library_ms={lib_bwd_ms:.4f} (sdpa backward) "
            f"plain_ms={plain_bwd_ms:.4f} (2 heads, not a yardstick) "
            + " ".join(f"{gn}_rel_err={e:.3e}" for gn, e in errs.items())
            + f" max_abs_err={mae:.3e} check_s={check_s:.1f}" + fused_note + pass_note
            + prep_note)
        del q, k, v, do, o, lse, sub, qt, kt, vt, out, dot
        torch.cuda.empty_cache()

    # per-batch kv lengths, one of them 0, and an LSE cotangent, through the split kernels
    b, n, sq, sk, lens = 3, 2, 98305, 512, [512, 77, 0]
    q, do = _rand(g, b, sq, n, HEAD_DIM), _rand(g, b, sq, n, HEAD_DIM)
    k, v = _rand(g, b, sk, n, HEAD_DIM), _rand(g, b, sk, n, HEAD_DIM)
    dlse = _rand(g, b, n, sq, dtype=torch.float32)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention_with_lse(q, k, v, kv_len)
    before = fa.flash_attention_bwd.split_launches
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, kv_len, dlse)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                        do.float(), kv_len, dlse)
    errs = {gn: rel_err(got, w) for gn, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    mae = max(float((got.float() - w).abs().max()) for got, w in zip((dq, dk, dv), want))
    max_abs["split"] = max(max_abs["split"], mae)
    nonzero = int(torch.count_nonzero(dq[2])) + sum(
        int(torch.count_nonzero(x[i, length:])) for x in (dk, dv)
        for i, length in enumerate(lens))
    if (not all(e <= GRAD_REL_TOL for e in errs.values()) or nonzero
            or fa.flash_attention_bwd.split_launches != before + 1):
        raise AssertionError(f"masked split backward: rel errs {errs}, {nonzero} nonzero "
                             f"where exact zeros are due")
    log(f"[720p] flash_bwd (split) masked B={b} N={n} Sq={sq} Sk={sk} kv_len={lens} with "
        "dlse: " + " ".join(f"{gn}_rel_err={e:.3e}" for gn, e in errs.items())
        + f" max_abs_err={mae:.3e}; length-0 dq and masked dk/dv exactly 0")
    del q, k, v, do, dlse, o, lse, dq, dk, dv, want
    torch.cuda.empty_cache()
    phase_small_backward(split=True)
    return rows, max_abs


def phase_train_720p(cfg, modules, root: str):
    """`LoRATrainer` for TRAIN_720P_STEPS optimizer steps on 1280x720 clips
    of 193 frames, on the main path's modules."""
    import shutil

    import torch

    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                         flash_bwd_preprocess)

    save_dir = os.path.join(root, "build", "chip_smoke_train_720p")
    shutil.rmtree(save_dir, ignore_errors=True)
    tcfg = TrainerConfig(lr=1e-4, weight_decay=1e-2, warmup_steps=100,
                         max_steps=TRAIN_720P_STEPS, lr_schedule="cosine", lora_rank=16,
                         lora_alpha=16.0, log_interval=1, save_interval=1000,
                         save_dir=save_dir, logger="jsonl", remat=True)
    trainer = LoRATrainer(cfg, modules, tcfg, device="cuda")
    clips = _synthetic_clips(TRAIN_720P_STEPS, TRAIN_720P["height"], TRAIN_720P["width"],
                             TRAIN_720P["num_frames"], TRAIN_720P["audio_samples"])
    steps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the 720p train path's counts
    flash_attention.launches = flash_attention_bwd.launches = 0
    flash_attention_bwd.split_launches = flash_bwd_preprocess.launches = 0
    t0 = time.perf_counter()
    final = trainer.train(clips, on_micro_step=steps.append)
    wall = time.perf_counter() - t0
    launches = {"fwd": flash_attention.launches, "bwd": flash_attention_bwd.launches,
                "split": flash_attention_bwd.split_launches,
                "prep": flash_bwd_preprocess.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, st in enumerate(steps):
        log(f"[train720] step {i + 1}: expert {st['expert']} timestep {st['timestep']:.1f} "
            f"loss {st['loss']:.5f} (video {st['video_loss']:.5f}, audio "
            f"{st['audio_loss']:.5f}) grad_norm {st['grad_norm']:.5f}; encode "
            f"{st['encode_s']:.3f} s, loss+backward {st['loss_backward_s']:.3f} s, "
            f"optimizer {st['optimizer_s']:.4f} s; flash launches fwd {st['flash_fwd']} "
            f"fused bwd {st['flash_bwd']} split bwd {st['flash_bwd_split']}")
    log(f"[train720] {final} steps at {TRAIN_720P['width']}x{TRAIN_720P['height']}, "
        f"{TRAIN_720P['num_frames']} frames in {wall:.2f} s (clip synthesis and saves "
        f"included); max_memory_allocated {peak:.2f} GiB; flash launches over the phase "
        f"{launches}")
    if launches["prep"] != launches["bwd"] + launches["split"]:
        raise AssertionError(f"preprocess launches {launches['prep']}, one per backward due")
    if final != TRAIN_720P_STEPS or [st["expert"] for st in steps] != [0, 1]:
        raise AssertionError(f"{final} steps, experts {[st['expert'] for st in steps]}")
    want = (TRAIN_720P_FWD_LAUNCHES, TRAIN_720P_FUSED_LAUNCHES, TRAIN_720P_SPLIT_LAUNCHES)
    for st in steps:
        values = [st[k] for k in ("loss", "video_loss", "audio_loss", "grad_norm")]
        if not all(math.isfinite(x) for x in values) or st["grad_norm"] <= 0:
            raise AssertionError(f"non-finite or zero metrics {st}")
        got = (st["flash_fwd"], st["flash_bwd"], st["flash_bwd_split"])
        if got != want:
            raise AssertionError(f"flash launches per micro-step (fwd, fused, split) {got}, "
                                 f"expected {want}")
    for mod, tree in trainer.lora.items():
        zero = [n for n, ab in tree.items() if not torch.count_nonzero(ab["b"])]
        if zero:
            raise AssertionError(f"{mod}: LoRA b still zero at {zero[:3]}")
    log("[train720] experts 0, 1; every module's LoRA b nonzero")
    del trainer
    torch.cuda.empty_cache()
    return launches, peak


# a full-depth MOVA-360p request (4 steps, CFG 5): 30 shared layers x 6 attentions + 10
# video-only tail layers x 2, per pass, x 2 passes x 4 steps
FULL_DEPTH_LAUNCHES = (30 * 6 + 10 * 2) * 2 * 4
# bf16 masters of the full-depth model fit the card's host: 101 GiB (`free -g` on the
# H100's machine), of which the masters page-lock 73.3 GiB; fp8 masters (37.6 GiB) would
# be the fallback for a smaller host, and are not needed there
FULL_DEPTH_MASTER_DTYPE = "bfloat16"
MEMORY_RETURN_GIB = 1.0
OPTIONS_REL_TOL = 2e-2


def _host_memory():
    """(this process's resident host memory in GiB, `free -g`'s total line)."""
    import resource

    with open("/proc/self/status") as f:
        rss_kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=30).stdout
    mem = next((line for line in free.splitlines() if line.startswith("Mem:")), free)
    lock = resource.getrlimit(resource.RLIMIT_MEMLOCK)[0]
    lock = "unlimited" if lock == resource.RLIM_INFINITY else f"{lock // 1024} KiB"
    return rss_kb / 2**20, (f"{' '.join(mem.split())} (total used free shared cache "
                            f"available); ulimit -l {lock}")


def _serve_request(pipe, prompt, seed, request, rng, **extra):
    """One request through prepare_state / denoise_state / finalize_state, timed
    on the host (each end synchronised), with the steps timed by the progress
    hook. Returns (result, prepare s, step s list, decode s)."""
    import torch

    step_s, last = [], [0.0]

    def on_step(step, total):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now

    pipe.progress_cb = on_step
    image = rng.uniform(-1, 1, (request["height"], request["width"], 3)).astype("float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = pipe.prepare_state([prompt], [image], negative_prompts=["blurry, low quality"],
                               seeds=[seed], **dict(request, **extra))
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    last[0] = time.perf_counter()
    state = pipe.denoise_state(state)
    t0 = time.perf_counter()
    res = pipe.finalize_state(state)[0]
    torch.cuda.synchronize()
    return res, prepare_s, step_s, time.perf_counter() - t0


def _count_flash(fn):
    """fn() with the forward kernels' counts set to 0 just before and read just
    after: {"exact": ..., "cap": ..., "sage": ...}."""
    from dualforce_tpu_torch.ops import sage_attention as sa
    from dualforce_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = flash_attention.cap_launches = 0
    sa.sage_attention.launches = 0
    out = fn()
    return out, {"exact": flash_attention.launches, "cap": flash_attention.cap_launches,
                 "sage": sa.sage_attention.launches}


def _staging_spy(offload):
    """Wrap `offload.staged` to time each staging and keep the order in which
    modules enter and leave the card: (events [(kind, id, s)], restore)."""
    import contextlib

    import torch

    real, events = offload.staged, []

    @contextlib.contextmanager
    def timed(module, device):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with real(module, device) as copy:
            torch.cuda.synchronize()
            events.append(("in", id(module), time.perf_counter() - start))
            try:
                yield copy
            finally:
                events.append(("out", id(module), 0.0))

    offload.staged = timed
    return events, lambda: setattr(offload, "staged", real)


def phase_full_depth_staged():
    """Phase 14: MOVA-360p at full depth through `offload="component"`, bf16
    masters in page-locked host memory (FULL_DEPTH_MASTER_DTYPE: the host
    holds them)."""
    import numpy as np
    import torch

    from dualforce_tpu_torch import offload
    from dualforce_tpu_torch.config import mova_360p
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.models.factory import init_pipeline_params

    cfg = mova_360p()
    rss, free = _host_memory()
    log(f"[full] host before init: rss {rss:.2f} GiB; free -g: {free}")
    t0 = time.perf_counter()
    modules = init_pipeline_params(cfg, device="cuda", dtype=getattr(torch,
                                   FULL_DEPTH_MASTER_DTYPE), seed=0, host=True)
    init_s = time.perf_counter() - t0
    if not all(t.is_pinned() for m in modules.values()
               for t in list(m.parameters()) + list(m.buffers())):
        raise AssertionError("a master is not in page-locked host memory")
    sizes = {n: offload.nbytes(m) for n, m in modules.items()}
    rss, free = _host_memory()
    log(f"[full] {sum(p.numel() for m in modules.values() for p in m.parameters()) / 1e9:.3f}"
        f" B parameters drawn on the card and moved to page-locked host memory in "
        f"{init_s:.1f} s: " + ", ".join(f"{n} {b / 2**30:.2f} GiB" for n, b in sizes.items())
        + f"; card allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB; host rss "
        f"{rss:.2f} GiB; free -g: {free}")
    peak_limit = sizes["video_dit"] + sizes["video_dit_2"]
    pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(), compute_dtype=torch.bfloat16,
                        device="cuda", offload="component")
    names = {id(m): n for n, m in modules.items()}
    events, restore = _staging_spy(offload)
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (res, prep_s, step_s, dec_s), counts = _count_flash(lambda: _serve_request(
            pipe, "a cat playing the piano in a sunlit room", 0, REQUEST,
            np.random.default_rng(14)))
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        restore()
    staging = [(names[mid], t) for kind, mid, t in events if kind == "in"]
    rss, free = _host_memory()
    log(f"[full] staged bf16 request: prepare {prep_s:.2f} s, denoise steps "
        f"{', '.join(f'{x:.2f}' for x in step_s)} s, decode {dec_s:.2f} s; launches {counts}")
    log("[full] staging: " + "; ".join(
        f"{n} {sizes[n] / 2**30:.2f} GiB in {t:.3f} s ({sizes[n] / t / 1e9:.1f} GB/s)"
        for n, t in staging))
    log(f"[full] max_memory_allocated {peak / 2**30:.2f} GiB (limit: both experts' bf16 "
        f"bytes, {peak_limit / 2**30:.2f} GiB); allocated {mem0 / 2**30:.3f} GiB before, "
        f"{after / 2**30:.3f} GiB after; host rss {rss:.2f} GiB; free -g: {free}")
    _check_result(res, REQUEST)
    log(f"[full] video uint8 {res.video.shape} mean {res.video.mean():.2f}; audio "
        f"{res.audio.shape[0]} finite samples, rms {float(np.sqrt(np.mean(res.audio ** 2))):.4f}")
    want = {"exact": FULL_DEPTH_LAUNCHES, "cap": 0, "sage": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    if peak >= peak_limit:
        raise AssertionError(f"peak {peak / 2**30:.2f} GiB, not under the two experts' "
                             f"{peak_limit / 2**30:.2f} GiB")
    if abs(after - mem0) > MEMORY_RETURN_GIB * 2**30:
        raise AssertionError(f"allocated {after / 2**30:.3f} GiB after the request, "
                             f"{mem0 / 2**30:.3f} GiB before")
    stats = {"launches": counts["exact"], "peak_gib": peak / 2**30, "step_s": step_s,
             "init_s": init_s, "staging": staging}
    return stats


def phase_full_depth_fp8():
    """Phase 15: the same request with every tower and UMT5 stored in fp8,
    resident on the card (`offload="none"`)."""
    import numpy as np
    import torch

    from dualforce_tpu_torch import offload
    from dualforce_tpu_torch.config import mova_360p
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.models.factory import init_pipeline_params

    cfg = mova_360p()
    t0 = time.perf_counter()
    modules = init_pipeline_params(cfg, device="cuda", dtype=torch.float8_e4m3fn, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fp8_names = ("video_dit", "video_dit_2", "audio_dit", "bridge", "text_encoder")
    fp8_bytes = sum(offload.nbytes(modules[n]) for n in fp8_names)
    bf16_bytes = sum(2 * p.numel() for n in fp8_names for p in modules[n].parameters())
    log(f"[fp8] drawn in bf16 and cast on the card in {init_s:.1f} s: towers and UMT5 "
        f"{fp8_bytes / 2**30:.3f} GiB in fp8 storage against {bf16_bytes / 2**30:.3f} GiB "
        f"in bf16 ({100 * fp8_bytes / bf16_bytes:.1f} %); card allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(), compute_dtype=torch.bfloat16,
                        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    (res, prep_s, step_s, dec_s), counts = _count_flash(lambda: _serve_request(
        pipe, "a cat playing the piano in a sunlit room", 0, REQUEST,
        np.random.default_rng(14)))
    peak = torch.cuda.max_memory_allocated()
    log(f"[fp8] resident fp8 request: prepare {prep_s:.2f} s, denoise steps "
        f"{', '.join(f'{x:.2f}' for x in step_s)} s, decode {dec_s:.2f} s; launches {counts}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    _check_result(res, REQUEST)
    log(f"[fp8] video uint8 {res.video.shape} mean {res.video.mean():.2f}; audio "
        f"{res.audio.shape[0]} finite samples, rms {float(np.sqrt(np.mean(res.audio ** 2))):.4f}")
    want = {"exact": FULL_DEPTH_LAUNCHES, "cap": 0, "sage": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    return {"launches": counts["exact"], "peak_gib": peak / 2**30, "step_s": step_s,
            "fp8_share": fp8_bytes / bf16_bytes}


def phase_sampler_options():
    """Phase 16: the sampler's serving options on the card at phase 5's
    geometry and modules (depth cut, seed 0)."""
    import numpy as np
    import torch

    from dualforce_tpu_torch import offload
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.diffusion.sampler import build_plan
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.ops import attention as attn_mod

    cfg = main_path_config()
    modules = init_pipeline_params(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(), compute_dtype=torch.bfloat16,
                        device="cuda", mask_ctx_pad=True)
    calls = []
    real = attn_mod.flash_attention

    def spy(q, k, v, kv_valid_len=None, **kw):
        calls.append((q.shape[0], None if kv_valid_len is None else kv_valid_len.tolist()))
        return real(q, k, v, kv_valid_len, **kw)

    prompt = "a cat playing the piano in a sunlit room"
    attn_mod.flash_attention = spy
    try:
        (batched, _, b_steps, _), b_counts = _count_flash(lambda: _serve_request(
            pipe, prompt, 0, REQUEST, np.random.default_rng(16), cfg_batch=True))
    finally:
        attn_mod.flash_attention = real
    (single, _, s_steps, _), s_counts = _count_flash(lambda: _serve_request(
        pipe, prompt, 0, REQUEST, np.random.default_rng(16)))
    plain = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(),
                         compute_dtype=torch.bfloat16, device="cuda")
    (cached, _, c_steps, _), c_counts = _count_flash(lambda: _serve_request(
        plain, prompt, 0, REQUEST, np.random.default_rng(16), cfg_cache_interval=2))
    # the same modules moved to page-locked host memory and staged per phase
    for m in modules.values():
        offload.to_host(m, "cuda")
    staged = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(),
                          compute_dtype=torch.bfloat16, device="cuda", mask_ctx_pad=True,
                          offload="component")
    (restaged, _, r_steps, _), r_counts = _count_flash(lambda: _serve_request(
        staged, prompt, 0, REQUEST, np.random.default_rng(16)))
    rel = float(np.linalg.norm(batched.video.astype(np.float32) - single.video.astype(np.float32))
                / np.linalg.norm(single.video.astype(np.float32)))
    rel_audio = float(np.linalg.norm(batched.audio - single.audio)
                      / max(np.linalg.norm(single.audio), 1e-30))
    with_len = [lens for b, lens in calls if lens is not None]
    log(f"[options] mask_ctx_pad + cfg_batch: launches {b_counts}, batch sizes "
        f"{sorted(set(b for b, _ in calls))}, {len(with_len)} calls with per-batch kv lengths "
        f"{with_len[0] if with_len else None}; steps {', '.join(f'{x:.2f}' for x in b_steps)} s")
    log(f"[options] mask_ctx_pad unbatched: launches {s_counts}; steps "
        f"{', '.join(f'{x:.2f}' for x in s_steps)} s; decoded video rel L2 batched against "
        f"unbatched {rel:.3e} (limit {OPTIONS_REL_TOL}), audio {rel_audio:.3e}")
    log(f"[options] cfg_cache_interval=2: launches {c_counts}; steps "
        f"{', '.join(f'{x:.2f}' for x in c_steps)} s")
    same = (np.array_equal(restaged.video, single.video)
            and np.array_equal(restaged.audio, single.audio))
    log(f"[options] the unbatched request through offload='component' (the modules in "
        f"page-locked host memory): launches {r_counts}; steps "
        f"{', '.join(f'{x:.2f}' for x in r_steps)} s; bit-equal to resident: {same}")
    for res in (batched, single, cached, restaged):
        _check_result(res, REQUEST)
    if not same or r_counts != s_counts:
        raise AssertionError("the staged request differs from the resident one")
    if b_counts != {"exact": LAUNCHES_PER_REQUEST // 2, "cap": 0, "sage": 0}:
        raise AssertionError(f"batched launches {b_counts}, expected "
                             f"{LAUNCHES_PER_REQUEST // 2}")
    if len(calls) != LAUNCHES_PER_REQUEST // 2 or any(b != 2 for b, _ in calls):
        raise AssertionError(f"batched calls {[b for b, _ in calls]}, expected 56 at B = 2")
    if not with_len or any(len(lens) != 2 or lens[0] == lens[1] == 512 for lens in with_len):
        raise AssertionError(f"text cross-attention kv lengths {with_len}")
    if s_counts["exact"] != LAUNCHES_PER_REQUEST:
        raise AssertionError(f"unbatched launches {s_counts}")
    # the cached request runs its negative pass at steps i % 2 == 0 and at each
    # expert's first step: one positive pass per step, one negative per refresh
    steps = REQUEST["num_inference_steps"]
    plain.scheduler.set_timesteps(steps, shift=REQUEST["sigma_shift"])
    boundary = build_plan(plain.scheduler, cfg.boundary_ratio).boundary_step
    refreshes = {i for i in range(steps) if i % 2 == 0 or i == boundary}
    want = {"exact": LAUNCHES_PER_REQUEST // (2 * steps) * (steps + len(refreshes)),
            "cap": 0, "sage": 0}
    if c_counts != want:
        raise AssertionError(f"cfg_cache_interval=2 launches {c_counts}, expected {want} "
                             f"(negative passes at steps {sorted(refreshes)})")
    if rel > OPTIONS_REL_TOL:
        raise AssertionError(f"batched video rel L2 {rel:.3e} > {OPTIONS_REL_TOL}")
    return {"cfg_batch": b_counts["exact"], "unbatched": s_counts["exact"],
            "cfg_cache_interval_2": c_counts["exact"], "rel": rel}


# phase 17: the DAC's weight norm is folded in fp32 (sums in another order than the
# unfolded module's), so its loaded weights and the audio they decode (in fp32) may differ
# a little
FOLD_REL_TOL = 1e-6
CLI_AUDIO_REL_TOL = 1e-5
LORA_RANK, LORA_ALPHA, LORA_SCALE = 16, 16.0, 0.75


def _reference_lora(modules, root: str, seed: int = 17):
    """An accelerate-format LoRA directory (`lora_weights.pt`, `lora_config.pt`)
    over q, k, v and o of every block's self and cross attention of both video
    experts and of the bridge's a2v and v2a conditioners; A ~ N(0, 1/in), B ~
    N(0, 0.01^2), from a numpy seed. Returns {(module, weight name): (A, B)}."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.engine.lora import lora_targets

    rng = np.random.default_rng(seed)
    sd, factors = {}, {}
    for mod, prefix in (("video_dit", "video_dit"), ("video_dit_2", "video_dit_2"),
                        ("bridge", "dual_tower_bridge")):
        for name in lora_targets(modules[mod]):
            out_dim, in_dim = modules[mod].get_parameter(name).shape
            a = (rng.standard_normal((LORA_RANK, in_dim)) / math.sqrt(in_dim)).astype("float32")
            b = (0.01 * rng.standard_normal((out_dim, LORA_RANK))).astype("float32")
            stem = f"{prefix}.{name[:-len('.weight')]}"
            sd[f"{stem}.lora_A.weight"] = torch.from_numpy(a)
            sd[f"{stem}.lora_B.weight"] = torch.from_numpy(b)
            factors[(mod, name)] = (a, b)
    os.makedirs(root, exist_ok=True)
    torch.save(sd, os.path.join(root, "lora_weights.pt"))
    torch.save({"rank": LORA_RANK, "alpha": LORA_ALPHA}, os.path.join(root, "lora_config.pt"))
    return factors


def _trace_busy(path: str):
    """(summed kernel microseconds, microseconds in which at least one kernel,
    copy or memset ran, microseconds from the first to the last) of a
    `torch.profiler` Chrome trace."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not events:
        return 0.0, 0.0, 0.0
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels = sum(float(e["dur"]) for e in events if e["cat"] == "kernel")
    return kernels, busy, end - spans[0][0]


def _write_av(path: str, res) -> str:
    """The clip through the port's `save_video_with_audio`, or the WAV alone
    where PIL (which encodes the frames) is absent."""
    import importlib.util

    from dualforce_tpu_torch.utils import av_io

    if importlib.util.find_spec("PIL") is None:
        wav = os.path.splitext(path)[0] + ".wav"
        av_io.write_wav(wav, res.audio, res.sample_rate)
        log(f"[cli] PIL is absent: wrote the WAV alone, {wav}")
        return wav
    return av_io.save_video_with_audio(path, res.video, res.audio, fps=res.fps,
                                       sample_rate=res.sample_rate)


def phase_checkpoint_cli(first, root: str):
    """Phase 17: phase 5's modules written as an HF-layout checkpoint under
    `root` (a temporary directory, removed by the caller once phase 19 has
    trained from the checkpoint) and served from it through the port's two
    inference CLIs."""
    import copy
    import shutil

    import numpy as np
    import torch

    from dualforce_tpu_torch import nn as dnn
    from dualforce_tpu_torch import offload
    from dualforce_tpu_torch.cli import inference_single as cli
    from dualforce_tpu_torch.cli import inference_single_lora as lora_cli
    from dualforce_tpu_torch.convert import load_checkpoint as lc
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.models import dac_vae
    from dualforce_tpu_torch.models.factory import init_pipeline_params

    cfg = main_path_config()
    source = init_pipeline_params(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    ckpt = os.path.join(root, "mova_360p_depth_cut")
    free = shutil.disk_usage(root).free
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = lc.save_pipeline_params(source, cfg, ckpt)
    write_s = time.perf_counter() - t0
    os.sync()
    sync_s = time.perf_counter() - t0 - write_s
    log(f"[cli] wrote the checkpoint, {nbytes / 1e9:.3f} GB of tensors ("
        + ", ".join(f"{n} {offload.nbytes(m) / 1e9:.3f}" for n, m in source.items())
        + f" GB in the modules), in {write_s:.2f} s ({nbytes / write_s / 1e9:.2f} GB/s) "
        f"and synced in {sync_s:.2f} s; {free / 1e9:.1f} GB free on the temporary "
        f"directory's disk before")

    request = ["--prompt", first["prompt"], "--negative_prompt", first["negative"],
               "--seed", str(first["seed"]), "--ref_path", "unused (first frame given)",
               "--height", str(REQUEST["height"]), "--width", str(REQUEST["width"]),
               "--num_frames", str(REQUEST["num_frames"]), "--fps", str(REQUEST["video_fps"]),
               "--num_inference_steps", str(REQUEST["num_inference_steps"]),
               "--cfg_scale", str(REQUEST["cfg_scale"]),
               "--sigma_shift", str(REQUEST["sigma_shift"])]
    want = {"exact": LAUNCHES_PER_REQUEST, "cap": 0, "sage": 0}

    # 2. the base CLI with its default flags (the denoised audio latents kept)
    rss0 = _host_memory()[0]
    args = cli.parse_args(["--ckpt_path", ckpt, "--output", os.path.join(root, "base.mp4")]
                          + request)
    kept, finalize = {}, MOVAPipeline.finalize_state

    def keep(self, state):
        kept["audio_latents"] = state["audio_latents"]
        return finalize(self, state)

    MOVAPipeline.finalize_state = keep
    try:
        t0 = time.perf_counter()
        (base, pipe), counts = _count_flash(lambda: cli.run(
            args, tokenizer=ByteTokenizer(), image=first["image"]))
    finally:
        MOVAPipeline.finalize_state = finalize
    log(f"[cli] base request (load, then generate) {time.perf_counter() - t0:.2f} s; host "
        f"rss {rss0:.2f} GiB before, {_host_memory()[0]:.2f} GiB after; launches {counts}")
    if counts != want:
        raise AssertionError(f"base CLI launches {counts}, expected {want}")
    worst_fold = 0.0
    for name, module in pipe.modules.items():
        loaded = dict(module.named_parameters())
        for k, p in source[name].named_parameters():
            q = loaded[k]
            if name == "audio_vae" and k.endswith(".weight"):
                err = float((q - p).abs().max() / p.abs().max())
                worst_fold = max(worst_fold, err)
                ok = err <= FOLD_REL_TOL
            else:
                ok = q.dtype == p.dtype and torch.equal(q, p)
            if not ok:
                raise AssertionError(f"loaded {name}.{k} differs from the module written")
    _check_result(base, REQUEST)
    same_video = np.array_equal(base.video, first["video"])
    audio_rel = float(np.linalg.norm(base.audio - first["audio"])
                      / np.linalg.norm(first["audio"]))
    # the DAC decode: cuDNN runs fp32 convolutions in TF32 (PyTorch's default), whose
    # rounding (~6e-4 relative at the DAC's output) any one-ulp weight change shows;
    # the fold is held in fp32 on the request's own audio latents
    z, n = kept["audio_latents"].to("cuda"), first["audio"].shape[0]
    with torch.no_grad():
        again = dac_vae.decode(source["audio_vae"], z)[0, 0, :n].cpu().numpy()
        with torch.backends.cudnn.flags(enabled=True,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            got32 = dac_vae.decode(pipe.modules["audio_vae"], z)[0, 0, :n]
            want32 = dac_vae.decode(source["audio_vae"], z)[0, 0, :n]
    same_latents = np.array_equal(again, first["audio"])
    fold_rel = rel_err(got32, want32.float())
    tf32_rel = rel_err(torch.from_numpy(again).cuda(), want32.float())
    log(f"[cli] every loaded parameter equal to the one written (DAC folds within "
        f"{worst_fold:.2e} relative); video bit-equal to phase 5's first request: "
        f"{same_video}; audio rel L2 {audio_rel:.3e} against phase 5's (TF32 "
        f"convolutions); its latents decoded by the written DAC give phase 5's audio bit "
        f"for bit: {same_latents}; decoded in fp32 by the loaded and the written DAC: rel "
        f"L2 {fold_rel:.3e} (limit {CLI_AUDIO_REL_TOL}); the written DAC's TF32 decode "
        f"against its fp32 one: rel L2 {tf32_rel:.3e}")
    if not same_video:
        diff = np.abs(base.video.astype(np.int16) - first["video"].astype(np.int16))
        raise AssertionError(f"the CLI's video differs from phase 5's: {int(diff.max())} "
                             f"levels at most, in {float(np.mean(diff > 0)):.2e} of values")
    if not same_latents or fold_rel > CLI_AUDIO_REL_TOL:
        raise AssertionError(f"audio: latents as phase 5's {same_latents}, fp32 decode "
                             f"rel L2 {fold_rel:.3e} (limit {CLI_AUDIO_REL_TOL})")
    # the request's audio against phase 5's: each TF32 decode within about tf32_rel of
    # its fp32 one, and the two fp32 decodes fold_rel apart
    audio_limit = 2 * tf32_rel + fold_rel
    log(f"[cli] audio rel L2 {audio_rel:.3e} against phase 5's, limit {audio_limit:.3e} "
        f"(2 x TF32 vs fp32 + the fp32 fold gap)")
    if audio_rel > audio_limit:
        raise AssertionError(f"the CLI's audio is {audio_rel:.3e} from phase 5's "
                             f"(limit {audio_limit:.3e})")
    written = [_write_av(os.path.join(root, "base.mp4"), base)]

    # 3. fp8 storage, profiled
    trace_dir = os.path.join(root, "profile")
    args8 = cli.parse_args(["--ckpt_path", ckpt, "--weight_dtype", "fp8", "--profile",
                            trace_dir] + request)
    t0 = time.perf_counter()
    (res8, pipe8), counts8 = _count_flash(lambda: cli.run(
        args8, tokenizer=ByteTokenizer(), image=first["image"]))
    log(f"[cli] fp8 request, profiled (load, generate, trace export) "
        f"{time.perf_counter() - t0:.2f} s; launches {counts8}")
    if counts8 != want:
        raise AssertionError(f"fp8 CLI launches {counts8}, expected {want}")
    for name in ("video_dit", "video_dit_2", "audio_dit", "bridge", "text_encoder"):
        cast = dnn.cast_modules_fp8(copy.deepcopy(pipe.modules[name]))
        loaded = dict(pipe8.modules[name].named_parameters())
        for k, p in cast.named_parameters():
            q = loaded[k]
            if q.dtype != p.dtype or not torch.equal(q.view(torch.uint8),
                                                     p.view(torch.uint8)):
                raise AssertionError(f"fp8 load of {name}.{k} differs from "
                                     "cast_modules_fp8 of the bf16 load")
        del cast
    _check_result(res8, REQUEST)
    with open(os.path.join(trace_dir, "device_ops.json")) as f:
        ops = [o for o in json.load(f)
               if o["device_type"] == "CUDA" and o["self_device_us"] > 0]
    total_us = sum(o["self_device_us"] for o in ops)
    kernel_us, busy_us, span_us = _trace_busy(os.path.join(trace_dir, "trace.json"))
    log(f"[cli] fp8 towers and UMT5 byte-equal to cast_modules_fp8 of the bf16 load; "
        f"trace.json {os.path.getsize(os.path.join(trace_dir, 'trace.json')) / 1e6:.1f} "
        f"MB: kernels {kernel_us / 1e6:.3f} s, the card busy {busy_us / 1e6:.3f} s of "
        f"{span_us / 1e6:.3f} s from the first kernel to the last (idle "
        f"{100 * (1 - busy_us / max(span_us, 1e-9)):.1f} %); the profiler's averages: "
        f"{len(ops)} device operations, {total_us / 1e6:.3f} s; the ten with the most:")
    for o in ops[:10]:
        log(f"[cli]   {o['self_device_us'] / 1e3:10.2f} ms "
            f"({100 * o['self_device_us'] / max(total_us, 1e-9):5.1f} %), "
            f"{o['calls']:6d} calls: {o['name'][:110]}")
    if total_us <= 0:
        log("[cli] the profiler's averages hold no device time")
    written.append(_write_av(os.path.join(root, "fp8.mp4"), res8))
    del pipe8, res8, pipe
    torch.cuda.empty_cache()

    # 4. a reference-format LoRA through the LoRA CLI, staged from host memory
    lora_dir = os.path.join(root, "lora")
    factors = _reference_lora(source, lora_dir)
    argsl = lora_cli.parse_args(["--base_model", ckpt, "--lora_path", lora_dir,
                                 "--lora_scale", str(LORA_SCALE), "--offload", "cpu"]
                                + request)
    events, restore = _staging_spy(offload)
    try:
        t0 = time.perf_counter()
        (resl, pipel), countsl = _count_flash(lambda: lora_cli.run(
            argsl, tokenizer=ByteTokenizer(), image=first["image"]))
    finally:
        restore()
    names = {id(m): n for n, m in pipel.modules.items()}
    live, together = set(), False
    for kind, mid, _ in events:
        (live.add if kind == "in" else live.discard)(names[mid])
        together |= {"video_dit", "video_dit_2"} <= live
    log(f"[cli] LoRA request (load, merge on the card, page-lock, generate) "
        f"{time.perf_counter() - t0:.2f} s; launches {countsl}; staging: " + "; ".join(
            f"{names[mid]} {offload.nbytes(pipel.modules[names[mid]]) / 1e9:.3f} GB in "
            f"{s:.3f} s ({offload.nbytes(pipel.modules[names[mid]]) / s / 1e9:.1f} GB/s)"
            for kind, mid, s in events if kind == "in"))
    if countsl != want:
        raise AssertionError(f"LoRA CLI launches {countsl}, expected {want}")
    if together:
        raise AssertionError("the two video experts were staged together")
    if not all(t.is_pinned() for m in pipel.modules.values() for t in m.parameters()):
        raise AssertionError("a LoRA master is not in page-locked host memory")
    scaling = LORA_ALPHA / LORA_RANK * LORA_SCALE
    for mod, name in (("video_dit", "blocks.0.self_attn.q.weight"),
                      ("video_dit_2",
                       f"blocks.{cfg.video_dit.num_layers - 1}.cross_attn.o.weight"),
                      ("bridge", f"video_to_audio_conditioners."
                                 f"{cfg.bridge.interaction_layers()[-1]}.inner.k.weight")):
        a, b = (torch.from_numpy(x).cuda() for x in factors[(mod, name)])
        w = source[mod].get_parameter(name).float()
        want32 = w + scaling * (b @ a)
        got = pipel.modules[mod].get_parameter(name).cuda()
        # W + delta rounded once to bf16: within half a bf16 step of the fp32 value,
        # give or take a few fp32 steps for another order of the sums
        step = torch.ldexp(torch.ones_like(want32), torch.frexp(want32)[1] - 8)
        slack = 4 * torch.finfo(torch.float32).eps * (w.abs() + (b @ a).abs() * scaling)
        err = (got.float() - want32).abs()
        exact = float((got == want32.bfloat16()).float().mean())
        log(f"[cli] merged {mod}.{name}: max |merged - fp32 reference| / half step "
            f"{float((err / (0.5 * step)).max()):.4f}; bit-equal to the reference "
            f"rounded once in {exact:.6f} of values; |delta| max "
            f"{float((b @ a).abs().max()) * scaling:.3e}")
        if got.dtype != torch.bfloat16 or bool((err > 0.5 * step + slack).any()):
            raise AssertionError(f"merged {mod}.{name} is not W + (alpha/r) * scale * B A")
    _check_result(resl, REQUEST)
    if np.array_equal(resl.video, base.video):
        raise AssertionError("the LoRA left the video unchanged")
    rel = float(np.linalg.norm(resl.video.astype(np.float32) - base.video.astype(np.float32))
                / np.linalg.norm(base.video.astype(np.float32)))
    log(f"[cli] LoRA video rel L2 against the base request {rel:.3e}")
    written.append(_write_av(os.path.join(root, "lora.mp4"), resl))

    # 5. the files
    log("[cli] wrote " + ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 1e6:.1f} MB"
                                   for p in written))
    return {"launches": counts["exact"] + counts8["exact"] + countsl["exact"],
            "write_s": write_s, "ckpt": ckpt}


# phase 18: the low-resource LoRA recipe (configs/training/lora_low_resource.py) at full
# depth. Per micro-step (B 1, 352x640x49: 11,440 video and 103 audio tokens) the 3
# video-side attentions of each of the 30 shared layers (video self, video text cross,
# a2v; the 103-query audio side takes plain attention) and the 2 of each of the 10 tail
# layers take the kernels: 110 calls, each forward twice under remat, each backward fused
# (Sq 11,440 < 98,305) after one delta preprocess
LOW_RESOURCE_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "training", "lora_low_resource.py")
FULL_TRAIN_FLASH_CALLS = 30 * 3 + 10 * 2
# the recipe's cuts: 3 optimizer steps of 2 micro-batches with the expert switched every
# step (experts 0, 0, 1, 1, 0, 0): the warmup gives lr 0 at the first step, so expert 0
# trains at a nonzero lr only at the third
FULL_TRAIN_CUTS = dict(max_steps=3, grad_accum_steps=2, expert_switch_interval=1)
FULL_TRAIN_EXPERTS = [0, 0, 1, 1, 0, 0]


def _recipe_trainer_config():
    """The `trainer` dict of the low-resource recipe, read from the checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("low_resource_recipe", LOW_RESOURCE_RECIPE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.config


def _check_saved_lora(trainer, step_dir: str, cfg, tag: str) -> None:
    """The step's `lora_weights.npz` and its reference export `lora_weights.pt`
    reload bit-equal to the live LoRA."""
    import torch

    from dualforce_tpu_torch.convert.lora_import import load_reference_lora
    from dualforce_tpu_torch.engine import lora as lora_mod

    npz, _ = lora_mod.load_lora(os.path.join(step_dir, "lora_weights.npz"),
                                cfg.bridge.interaction_layers())
    ref, meta = load_reference_lora(step_dir, cfg)
    for mod, tree in trainer.lora.items():
        for name, ab in tree.items():
            for part in ("a", "b"):
                live = ab[part].detach().cpu()
                if not torch.equal(npz[mod][name][part], live):
                    raise AssertionError(f"{tag}: lora_weights.npz differs at {mod} {name}")
                if not torch.equal(ref[mod][name][part], live):
                    raise AssertionError(f"{tag}: lora_weights.pt differs at {mod} {name}")
    log(f"[{tag}] {os.path.basename(step_dir)}/lora_weights.npz and the exported "
        f"lora_weights.pt (rank {meta['rank']}, alpha {meta['alpha']}) reload bit-equal to "
        f"the live LoRA")


def phase_train_low_resource(root: str):
    """Phase 18: `LoRATrainer` with the low-resource recipe's trainer settings at
    MOVA-360p full width and depth: fp8 modules in page-locked host memory,
    staged per phase, AdamW8bit, remat, rank 16."""
    import shutil

    import numpy as np
    import torch

    from dualforce_tpu_torch import offload
    from dualforce_tpu_torch.config import mova_360p
    from dualforce_tpu_torch.engine import lora as lora_mod
    from dualforce_tpu_torch.engine.optim import AdamW8bit
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                         flash_bwd_preprocess)

    recipe = _recipe_trainer_config()
    save_dir = os.path.join(root, "build", "chip_smoke_low_resource")
    shutil.rmtree(save_dir, ignore_errors=True)
    settings = dict(recipe["trainer"], **FULL_TRAIN_CUTS, save_dir=save_dir, logger="jsonl",
                    log_interval=1)
    log(f"[lowres] recipe {os.path.relpath(LOW_RESOURCE_RECIPE, root)}: pipeline "
        f"{recipe['pipeline']}, trainer {recipe['trainer']}; cuts: {FULL_TRAIN_CUTS} "
        f"(experts {FULL_TRAIN_EXPERTS}), save_dir and logger jsonl for this run; clips "
        f"synthetic 352x640x49 at 24 fps")
    cfg = mova_360p()
    t0 = time.perf_counter()
    modules = init_pipeline_params(cfg, device="cuda", dtype=torch.float8_e4m3fn, seed=0,
                                   host=True)
    init_s = time.perf_counter() - t0
    if not all(t.is_pinned() for m in modules.values()
               for t in list(m.parameters()) + list(m.buffers())):
        raise AssertionError("a master is not in page-locked host memory")
    sizes = {n: offload.nbytes(m) for n, m in modules.items()}
    n_params = sum(p.numel() for m in modules.values() for p in m.parameters())
    rss, free = _host_memory()
    log(f"[lowres] {n_params / 1e9:.3f} B parameters drawn on the card, towers and UMT5 "
        f"cast to fp8, moved to page-locked host memory in {init_s:.1f} s: "
        + ", ".join(f"{n} {b / 2**30:.2f} GiB" for n, b in sizes.items())
        + f"; card allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB; host rss "
        f"{rss:.2f} GiB; free -g: {free}")

    trainer = LoRATrainer(cfg, modules, TrainerConfig(**settings), device="cuda")
    if not isinstance(trainer.optimizer, AdamW8bit) or trainer.tcfg.offload != "component":
        raise AssertionError("the recipe's AdamW8bit and component offload are not in use")
    n_lora = sum(p.numel() for p in lora_mod.lora_parameters(trainer.lora))
    state_bytes = sum(q.numel() + 4 * s.numel() for q, s in
                      trainer.optimizer.mu + trainer.optimizer.nu)
    log(f"[lowres] {n_lora / 1e6:.2f} M LoRA parameters (rank {trainer.tcfg.lora_rank}) over "
        f"{sum(len(t) for t in trainer.lora.values())} weights, on the card; AdamW8bit "
        f"moments {state_bytes / 2**20:.1f} MiB (fp32 moments would take "
        f"{8 * n_lora / 2**20:.1f})")

    names = {id(m): n for n, m in modules.items()}
    events, restore = _staging_spy(offload)
    steps = []

    def record(st):
        st["max_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
        st["rss_gib"] = _host_memory()[0]
        steps.append(st)
        torch.cuda.reset_peak_memory_stats()

    try:
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        # the low-resource path's counts
        flash_attention.launches = flash_attention_bwd.launches = 0
        flash_attention_bwd.split_launches = flash_bwd_preprocess.launches = 0
        t0 = time.perf_counter()
        final = trainer.train(_synthetic_clips(2 * FULL_TRAIN_CUTS["max_steps"]),
                              on_micro_step=record)
        wall = time.perf_counter() - t0
        launches = {"fwd": flash_attention.launches, "bwd": flash_attention_bwd.launches,
                    "split": flash_attention_bwd.split_launches,
                    "prep": flash_bwd_preprocess.launches}
        after = torch.cuda.memory_allocated()
    finally:
        restore()
    stagings = [(names[mid], t) for kind, mid, t in events if kind == "in"]
    live, together = set(), False
    for kind, mid, _ in events:
        (live.add if kind == "in" else live.discard)(names[mid])
        together |= {"video_dit", "video_dit_2"} <= live
    for i, st in enumerate(steps):
        log(f"[lowres] micro-step {i + 1}: expert {st['expert']} timestep "
            f"{st['timestep']:.1f} loss {st['loss']:.5f} (video {st['video_loss']:.5f}, "
            f"audio {st['audio_loss']:.5f})"
            + (f" grad_norm {st['grad_norm']:.5f}" if "grad_norm" in st else "")
            + f"; encode {st['encode_s']:.3f} s, staging {st['stage_s']:.3f} s, "
            f"loss+backward {st['loss_backward_s']:.3f} s, optimizer {st['optimizer_s']:.3f} s;"
            f" flash fwd {st['flash_fwd']} bwd {st['flash_bwd']} split "
            f"{st['flash_bwd_split']}; max_memory_allocated {st['max_allocated_gib']:.2f} GiB; "
            f"host rss {st['rss_gib']:.2f} GiB")
    log("[lowres] staging: " + "; ".join(
        f"{n} {sizes[n] / 2**30:.2f} GiB in {t:.3f} s ({sizes[n] / t / 1e9:.1f} GB/s)"
        for n, t in stagings))
    log(f"[lowres] {final} steps in {wall:.2f} s (saves included); allocated "
        f"{mem0 / 2**30:.3f} GiB before, {after / 2**30:.3f} GiB after; flash launches over "
        f"the phase fwd {launches['fwd']} bwd {launches['bwd']} split {launches['split']} "
        f"preprocess {launches['prep']}")

    if final != FULL_TRAIN_CUTS["max_steps"] or [st["expert"] for st in steps] != \
            FULL_TRAIN_EXPERTS:
        raise AssertionError(f"{final} steps, experts {[st['expert'] for st in steps]}")
    if together:
        raise AssertionError("the two video experts were staged together")
    staged = [n for n, _ in stagings]
    if staged.count("video_dit") != 2 or staged.count("video_dit_2") != 1 or \
            staged.count("text_encoder") != len(steps):
        raise AssertionError(f"stagings {staged}")
    for st in steps:
        values = [st[k] for k in ("loss", "video_loss", "audio_loss")]
        values += [st["grad_norm"]] if "grad_norm" in st else []
        if not all(math.isfinite(x) for x in values) or st.get("grad_norm", 1.0) <= 0:
            raise AssertionError(f"non-finite or zero metrics {st}")
        if (st["flash_fwd"], st["flash_bwd"], st["flash_bwd_split"]) != (
                2 * FULL_TRAIN_FLASH_CALLS, FULL_TRAIN_FLASH_CALLS, 0):
            raise AssertionError(f"flash launches per micro-step fwd {st['flash_fwd']} bwd "
                                 f"{st['flash_bwd']} split {st['flash_bwd_split']}, expected "
                                 f"{2 * FULL_TRAIN_FLASH_CALLS}, {FULL_TRAIN_FLASH_CALLS}, 0")
    if launches["prep"] != launches["bwd"] + launches["split"]:
        raise AssertionError(f"preprocess launches {launches['prep']}, one per backward due")
    for mod, tree in trainer.lora.items():
        zero = [n for n, ab in tree.items() if not torch.count_nonzero(ab["b"])]
        if zero:
            raise AssertionError(f"{mod}: LoRA b still zero at {zero[:3]}")
    _check_saved_lora(trainer, os.path.join(save_dir, f"step-{final}"), cfg, "lowres")
    log(f"[lowres] experts {FULL_TRAIN_EXPERTS}, never staged together; every module's LoRA "
        f"b nonzero; {2 * FULL_TRAIN_FLASH_CALLS} forward, {FULL_TRAIN_FLASH_CALLS} fused "
        f"backward and preprocess launches per micro-step")
    stats = {"launches": launches, "steps": steps, "stagings": stagings, "init_s": init_s,
             "peak_gib": max(st["max_allocated_gib"] for st in steps)}
    del trainer, modules
    shutil.rmtree(save_dir, ignore_errors=True)
    return stats


# phase 19: clips written as the dataset reads them (2 npz shards, 1 MJPEG AVI with audio)
# at the 360p recipe's geometry, trained through the CLI from phase 17's checkpoint; lr
# 1e-3 from the second step (warmup 1) so that three steps move the LoRA past bf16's
# rounding of the base weights, and the served video shows it
CLI_TRAIN_SETS = ["data.num_workers=1", "trainer.expert_switch_interval=1",
                  "trainer.logger=jsonl", "trainer.log_interval=1", "trainer.lr=1e-3",
                  "trainer.warmup_steps=1"]


def _write_clips(root: str, height: int = 352, width: int = 640, num_frames: int = 49,
                 fps: float = 24.0, sample_rate: int = 48000) -> str:
    """Two npz shards and one MJPEG AVI from a numpy seed, and their
    `metadata.json`; returns its path."""
    import numpy as np

    from dualforce_tpu_torch.utils.av_io import write_mjpeg_avi

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(19)
    n_audio = int(sample_rate * num_frames / fps)
    t = np.arange(n_audio) / sample_rate
    items = []
    for i in range(3):
        # smooth frames (JPEG keeps them) with a moving bright square
        base = rng.integers(0, 256, (num_frames, height // 16, width // 16, 3))
        video = np.repeat(np.repeat(base, 16, axis=1), 16, axis=2).astype(np.uint8)
        for f in range(num_frames):
            video[f, 100:160, 10 * f:10 * f + 60] = 255
        audio = (0.3 * np.sin(2 * np.pi * 220.0 * (i + 1) * t)).astype(np.float32)
        if i < 2:
            name = f"clip{i}.npz"
            np.savez(os.path.join(root, name), video=video, audio=audio, fps=fps,
                     sr=sample_rate)
        else:
            name = "clip2.avi"
            write_mjpeg_avi(os.path.join(root, name), video, fps, audio, sample_rate)
        items.append({"video_path": name, "caption": f"clip {i}: a square crossing a "
                                                     f"noisy field, a tone of {220 * (i + 1)} Hz"})
    path = os.path.join(root, "metadata.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path


def phase_train_cli(first, ckpt: str, root: str):
    """Phase 19: the training CLI with the low-resource recipe from phase 17's
    checkpoint, a resume, and the exported LoRA served through the LoRA CLI."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.cli import inference_single_lora as lora_cli
    from dualforce_tpu_torch.cli import train as train_cli
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                         flash_bwd_preprocess)

    meta = _write_clips(os.path.join(root, "clips"))
    save_dir = os.path.join(root, "lora_cli")
    log(f"[traincli] clips: " + ", ".join(
        f"{n} {os.path.getsize(os.path.join(root, 'clips', n)) / 1e6:.1f} MB"
        for n in sorted(os.listdir(os.path.join(root, "clips")))))
    launches = {"fwd": 0, "bwd": 0, "split": 0, "prep": 0}
    trainers = []
    for max_steps in (2, 3):
        argv = [LOW_RESOURCE_RECIPE, "--set", f"pipeline.ckpt_path={ckpt}",
                f"data.metadata_path={meta}", f"trainer.save_dir={save_dir}",
                f"trainer.max_steps={max_steps}"] + CLI_TRAIN_SETS
        flash_attention.launches = flash_attention_bwd.launches = 0
        flash_attention_bwd.split_launches = flash_bwd_preprocess.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_cli.run(argv, tokenizer=ByteTokenizer())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"fwd": flash_attention.launches, "bwd": flash_attention_bwd.launches,
               "split": flash_attention_bwd.split_launches,
               "prep": flash_bwd_preprocess.launches}
        for k in launches:
            launches[k] += run[k]
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        log(f"[traincli] `python -m dualforce_tpu_torch.cli.train {' '.join(argv)}`: "
            f"{wall:.2f} s (load, clips, train, saves); step {trainer.global_step}; flash "
            f"launches {run}; last metrics {lines[-1]}")
        micro = trainer.tcfg.grad_accum_steps * (max_steps - (0 if max_steps == 2 else 2))
        if trainer.global_step != max_steps or run["fwd"] != 2 * TRAIN_FLASH_CALLS * micro \
                or run["bwd"] != TRAIN_FLASH_CALLS * micro or run["split"] != 0:
            raise AssertionError(f"step {trainer.global_step}, launches {run} for {micro} "
                                 f"micro-steps")
        if not all(math.isfinite(x["loss"]) for x in lines):
            raise AssertionError(f"non-finite losses {lines}")
        for name in ("state.pt", "lora_weights.npz", "lora_weights.pt", "lora_config.pt"):
            if not os.path.isfile(os.path.join(save_dir, f"step-{max_steps}", name)):
                raise AssertionError(f"step-{max_steps}/{name} was not written")
        trainers.append(trainer)
    first_run, resumed = trainers
    if resumed.optimizer.count != 3:
        raise AssertionError(f"the second run did not resume from step-2 "
                             f"(optimizer count {resumed.optimizer.count})")
    cfg = resumed.cfg
    _check_saved_lora(resumed, os.path.join(save_dir, "step-3"), cfg, "traincli")
    for mod, tree in resumed.lora.items():
        if not all(torch.count_nonzero(ab["b"]) for ab in tree.values()):
            raise AssertionError(f"{mod}: a LoRA b is still zero after three steps")
    del trainers, first_run, resumed
    torch.cuda.empty_cache()

    lora_pt = os.path.join(save_dir, "step-3", "lora_weights.pt")
    request = ["--prompt", first["prompt"], "--negative_prompt", first["negative"],
               "--seed", str(first["seed"]), "--ref_path", "unused (first frame given)",
               "--height", str(REQUEST["height"]), "--width", str(REQUEST["width"]),
               "--num_frames", str(REQUEST["num_frames"]), "--fps", str(REQUEST["video_fps"]),
               "--num_inference_steps", str(REQUEST["num_inference_steps"]),
               "--cfg_scale", str(REQUEST["cfg_scale"]),
               "--sigma_shift", str(REQUEST["sigma_shift"])]
    args = lora_cli.parse_args(["--base_model", ckpt, "--lora_path", lora_pt] + request)
    t0 = time.perf_counter()
    (res, pipe), counts = _count_flash(lambda: lora_cli.run(args, tokenizer=ByteTokenizer(),
                                                            image=first["image"]))
    log(f"[traincli] the exported {os.path.relpath(lora_pt, root)} through "
        f"`cli.inference_single_lora` (load, merge, generate) {time.perf_counter() - t0:.2f} "
        f"s; launches {counts}")
    _check_result(res, REQUEST)
    rel = float(np.linalg.norm(res.video.astype(np.float32) - first["video"].astype(np.float32))
                / np.linalg.norm(first["video"].astype(np.float32)))
    log(f"[traincli] video uint8 {res.video.shape}; rel L2 against phase 17's base video "
        f"(phase 5's first request) {rel:.3e}")
    want = {"exact": LAUNCHES_PER_REQUEST, "cap": 0, "sage": 0}
    if counts != want:
        raise AssertionError(f"LoRA CLI launches {counts}, expected {want}")
    if np.array_equal(res.video, first["video"]):
        raise AssertionError("the trained LoRA left the video unchanged")
    del pipe
    torch.cuda.empty_cache()
    return {"launches": launches, "serve": counts["exact"], "rel": rel}


def main() -> int:
    # Freed blocks of any size serve later requests of any size: without it the
    # 720p training phase loses some 11 GiB of the card to fragmentation and
    # does not fit 193 frames (set before PyTorch's CUDA allocator starts).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "dualforce_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)

    smi = timed_phase("device", phase_device)
    timed_phase("build", phase_build)
    rows, max_abs = timed_phase("kernel", phase_kernels)
    timed_phase("small", phase_small_step)
    serve_launches, cfg, modules, first = timed_phase("main", phase_main_path)
    bwd_rows, bwd_max_abs = timed_phase("backward", phase_backward_kernels)
    timed_phase("small-backward", phase_small_backward)
    train = timed_phase("train", phase_train_path, cfg, modules, root)
    prec_rows, prec_max_abs = timed_phase("precision-kernels", phase_precision_kernels)
    timed_phase("precision-step", phase_precision_step)
    prec = timed_phase("precision", phase_precision_serving, cfg, modules)
    rows_720p, max_abs_720p = timed_phase("720p", phase_720p_backward_kernels)
    train720, peak_720p = timed_phase("train720", phase_train_720p, cfg, modules, root)
    del modules                             # the depth-cut model leaves the card
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    full = timed_phase("full", phase_full_depth_staged)
    gc.collect()
    torch.cuda.empty_cache()
    fp8 = timed_phase("fp8", phase_full_depth_fp8)
    gc.collect()
    torch.cuda.empty_cache()
    options = timed_phase("options", phase_sampler_options)
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = timed_phase("cli", phase_checkpoint_cli, first, ckpt_root)
        gc.collect()
        torch.cuda.empty_cache()
        lowres = timed_phase("lowres", phase_train_low_resource, root)
        gc.collect()
        torch.cuda.empty_cache()
        train_cli = timed_phase("traincli", phase_train_cli, first, ckpt["ckpt"], ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    lr_l, cli_l = lowres["launches"], train_cli["launches"]

    video_self, train_self = rows[0], bwd_rows[0]
    cap_self, sage_self = prec_rows["cap"][0], prec_rows["sage"][0]
    prologue_self = prec_rows["prologue"][0]
    split_self = rows_720p[0]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:132",
        "launches": (serve_launches + train["fwd"] + train720["fwd"] + full["launches"]
                     + fp8["launches"] + options["cfg_batch"] + options["unbatched"]
                     + options["cfg_cache_interval_2"] + ckpt["launches"] + lr_l["fwd"]
                     + cli_l["fwd"] + train_cli["serve"]),
        "launches_by_path": {"serve": serve_launches, "train": train["fwd"],
                             "serve_sage_int8": prec["sage"]["exact"],
                             "serve_fast_int4": prec["fast"]["exact"],
                             "train_720p": train720["fwd"],
                             "serve_full_depth_staged": full["launches"],
                             "serve_full_depth_fp8": fp8["launches"],
                             "serve_cfg_batch_mask_ctx_pad": options["cfg_batch"],
                             "serve_mask_ctx_pad": options["unbatched"],
                             "serve_cfg_cache_interval_2": options["cfg_cache_interval_2"],
                             "serve_cli_checkpoint": ckpt["launches"],
                             "train_low_resource_full_depth": lr_l["fwd"],
                             "train_cli": cli_l["fwd"], "serve_cli_trained_lora":
                             train_cli["serve"]},
        "full_depth_staged_peak_gib": full["peak_gib"],
        "full_depth_fp8_peak_gib": fp8["peak_gib"],
        "max_abs_err": max(max_abs, bwd_max_abs["fwd"], max_abs_720p["fwd"]),
        "ms": video_self["kernel_ms"],
        "plain_ms": video_self["plain_ms"],
        "plain_heads": 40,
        "bound_ms": video_self["bound_ms"],
        "bound_by": video_self["bound_by"],
        "library_ms": video_self["library_ms"],
        "held_against_plain": True,
        "fwd_lse_720p_ms": split_self["fwd_ms"],
        "fwd_nolse_720p_ms": split_self["fwd_nolse_ms"],
        "v2a_ms": rows[3]["kernel_ms"],
        "v2a_splits": rows[3]["splits"],
        "v2a_unsplit_ms": rows[3]["unsplit_ms"],
        "shape": "video_self: 40 heads, Sq = Sk = 43120, D 128, no LSE (the 720p times: 40 "
                 "heads, Sq = Sk = 176400, with and without the LSE; v2a: 12 heads, Sq 403, Sk "
                 "43120, split over keys); the other shapes are on the [kernel] and [720p] lines",
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:365",
        "launches": train["bwd"] + train720["bwd"] + lr_l["bwd"] + cli_l["bwd"],
        "launches_by_path": {"serve": 0, "train": train["bwd"], "train_720p": train720["bwd"],
                             "train_low_resource_full_depth": lr_l["bwd"],
                             "train_cli": cli_l["bwd"]},
        "train_low_resource_peak_gib": lowres["peak_gib"],
        "max_abs_err": max(bwd_max_abs["bwd"], max_abs_720p["fused"]),
        "ms": train_self["bwd_ms"],
        "plain_ms": train_self["bwd_plain_ms"],
        "plain_heads": 40,
        "bound_ms": train_self["bwd_bound_ms"],
        "bound_by": train_self["bwd_bound_by"],
        "library_ms": train_self["bwd_library_ms"],
        "held_against_plain": True,
        "shape": "video_self at training: 40 heads, Sq = Sk = 11440, D 128; the other "
                 "shapes, 720p's fused ones and the fused kernel at the split shapes are on "
                 "the [kernel] and [720p] lines",
    }, {
        "name": "flash_bwd_split",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:284 and :321",
        "mode": "split: the dq pass (_bwd_dq_kernel) and the dk/dv pass (_bwd_dkv_kernel), "
                "one launch of each per backward, where Sq >= 98,305",
        "launches": train720["split"] + lr_l["split"] + cli_l["split"],
        "launches_by_path": {"serve": 0, "train": train["split"],
                             "train_720p": train720["split"],
                             "train_low_resource_full_depth": lr_l["split"],
                             "train_cli": cli_l["split"]},
        "max_abs_err": max_abs_720p["split"],
        "ms": split_self["bwd_ms"],
        "plain_ms": split_self["bwd_plain_ms_2_heads"],
        "plain_heads": 2,
        "bound_ms": split_self["bwd_bound_ms"],
        "bound_by": split_self["bwd_bound_by"],
        "library_ms": split_self["bwd_library_ms"],
        "fused_ms_same_shape": split_self["fused_ms"],
        "dq_pass_ms": split_self["split_dq_pass_ms"],
        "dq_pass_bound_ms": split_self["split_dq_pass_bound_ms"],
        "dkv_pass_ms": split_self["split_dkv_pass_ms"],
        "dkv_pass_bound_ms": split_self["split_dkv_pass_bound_ms"],
        "held_against_plain": True,
        "shape": "video_self at 720p training: 40 heads, Sq = Sk = 176400, D 128 (plain_ms on "
                 "2 heads); the other shapes are on the [720p] lines",
        "train_720p_peak_gib": peak_720p,
    }, {
        "name": "flash_bwd_preprocess",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:484 (delta in `_bwd_prepare`, jnp "
                    "code beside the Pallas kernels)",
        "launches": train["prep"] + train720["prep"] + lr_l["prep"] + cli_l["prep"],
        "launches_by_path": {"serve": 0, "train": train["prep"],
                             "train_720p": train720["prep"],
                             "train_low_resource_full_depth": lr_l["prep"],
                             "train_cli": cli_l["prep"]},
        "max_abs_err": max(bwd_max_abs["prep"], max_abs_720p["prep"]),
        "ms": split_self["preprocess"]["ms"],
        "plain_ms": split_self["preprocess"]["plain_ms"],
        "plain_heads": 40,
        "bound_ms": split_self["preprocess"]["bound_ms"],
        "bound_by": split_self["preprocess"]["bound_by"],
        "library_ms": None,
        "held_against_plain": True,
        "shape": "video_self at 720p training: 40 heads, Sq = 176400, D 128 (delta and lse "
                 "padded to 176512 rows); the training shapes are on the [kernel] lines",
    }, {
        "name": "flash_fwd_cap",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:132",
        "mode": "cap (the TPU kernel's cap branch, :166-173), attn_impl 'fast'",
        "launches": prec["fast"]["cap"],
        "launches_by_path": {"serve_fast_int4": prec["fast"]["cap"],
                             "serve_sage_int8": prec["sage"]["cap"]},
        "max_abs_err": prec_max_abs["cap"],
        "ms": cap_self["kernel_ms"],
        "plain_ms": cap_self["plain_ms_2_heads"],
        "plain_heads": 2,
        "bound_ms": cap_self["bound_ms"],
        "bound_by": cap_self["bound_by"],
        "library_ms": cap_self["library_ms"],
        "held_against_plain": True,
        "shape": "video_self: 40 heads, Sq = Sk = 43120, D 128 (plain_ms on 2 heads); the "
                 "other shapes are on the [kernel] lines",
    }, {
        "name": "sage_fwd",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/sage_fwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:731",
        "launches": prec["sage"]["sage"],
        "launches_by_path": {"serve_sage_int8": prec["sage"]["sage"],
                             "serve_fast_int4": prec["fast"]["sage"]},
        "max_abs_err": prec_max_abs["sage"],
        "ms": sage_self["kernel_ms"],
        "plain_ms": sage_self["plain_ms_2_heads"],
        "plain_heads": 2,
        "bound_ms": sage_self["bound_ms"],
        "bound_by": sage_self["bound_by"],
        "library_ms": None,
        "cap_mode_ms_same_shape": sage_self["cap_ms"],
        "held_against_plain": True,
        "shape": "video_self: 40 heads, Sq = Sk = 43120, D 128, quantization blocks "
                 "1232/1960 (plain_ms on 2 heads); the other shapes are on the [kernel] lines",
    }, {
        "name": "sage_quantize",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/sage_fwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:800-813 (the jnp prologue of "
                    "`_sage_fwd`: K's mean-centring, `_block_quant_int8` :778 on Q and K, the "
                    "scale fold)",
        "launches": prec["sage"]["prologue"],
        "launches_by_path": {"serve_sage_int8": prec["sage"]["prologue"],
                             "serve_fast_int4": prec["fast"]["prologue"]},
        "max_abs_err": prec_max_abs["prologue"],
        "ms": prologue_self["kernel_ms"],
        "plain_ms": prologue_self["plain_ms"],
        "plain_heads": 40,
        "bound_ms": prologue_self["bound_ms"],
        "bound_by": prologue_self["bound_by"],
        "library_ms": None,
        "held_against_plain": True,
        "shape": "video_self: 40 heads, Sq = Sk = 43120, D 128, blocks 1232/1960 (one call: the "
                 "K sums and the quantization kernel; max_abs_err is the largest gap between "
                 "its int8 codes and the plain version's); the other shapes are on the "
                 "[kernel] lines",
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
