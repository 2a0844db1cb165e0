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
   settings for 2 optimizer steps (experts 0, 1) on a synthetic 1280x720
   clip of 193 frames at 24 fps with 386,000 audio samples (176,400 video
   and 403 audio tokens), both steps on the one clip, its second encode
   served from the first. Loss and grad norm must be finite (the norm above
   0); each micro-step must launch the forward kernel exactly 28 times, the
   split backward 8 times and the fused one 6 times; afterwards every
   module's LoRA `b` must be nonzero. Prints encode, loss+backward and
   optimizer seconds per step and the peak device memory.
14. full depth, staged: MOVA-360p at full depth (40 video layers per
   expert, 30 audio, 30 shared bridge layers, UMT5 24) from seed 0, each
   module drawn on the card and handed back in page-locked host memory
   (bf16 masters, 73.3 GiB: the card's host holds them, so the fp8
   fallback for smaller hosts is not taken), then phase 5's request at 2
   steps (step 0 on the high-noise expert, step 1 on the low-noise one)
   through `MOVAPipeline(offload="component")`. It must give phase 5's
   shapes, launch the flash kernel exactly 800 times, peak under both
   experts' bf16 bytes (53.2 GiB, which no run holding both could stay
   under) and leave the allocated memory within 1 GiB of its level before
   the request. Prints prepare, step and decode seconds, each staging's
   seconds and rate, the host's memory and lock limit. Then the same
   request through `MOVAPipeline(offload="group")` at group size 8 (6
   groups), its denoise as two chained one-step ranges: video and audio
   bit-equal to the staged request's, the same 800 launches, the
   denoise's peak under one expert's bf16 bytes (26.6 GiB); prints per
   step the bytes streamed, the copy stream's busy seconds and rate and
   the step against the staged one, and the prepare, denoise and decode
   peaks. Last, step 0 again with `offload_resident_small` (only the video
   groups stream): 400 launches, latents bit-equal to the first range's,
   its bytes against the full stream's.
15. full depth, fp8: the same request, its first step alone, with the
   towers and UMT5 stored in fp8 (`init_pipeline_params(dtype=float8_e4m3fn)`)
   resident on the card: 400 launches; prints the fp8 modules' bytes against
   bf16's and the peak.
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
   optimizer steps of one micro-batch with the expert switched every step
   (experts 0, 1, 0; the warmup's lr is 0 at the first step, so expert 0
   trains at a nonzero lr only at the third). The two experts must
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
   1e-3 after one warmup step) to step 2, then again to step 3 (its
   modules served from the first run's load), which must resume from
   `step-2` (16 forward and 8 fused backward launches per
   micro-step); the step's npz and exported `.pt` reload bit-equal and
   every LoRA `b` is nonzero; then phase 5's first request through
   `cli.inference_single_lora.run` with the exported
   `step-3/lora_weights.pt`: 112 launches, a uint8 video of the right shape
   that differs from phase 17's base video (its relative L2 printed). The
   checkpoint stays for phase 20.
20. serving over HTTP: phase 17's checkpoint through the port's server,
   `cli.serve.build_server` with `examples/serve_360p.sh`'s settings
   (`--weight_dtype fp8 --cfg_cache_interval 3 --max_batch 2`, plus
   `--warmup 640x352x193x4`) and `ByteTokenizer`, on 127.0.0.1 at a free
   port, the studio's proxy (`workflow/studio.py`) at another; requests
   through the port's `VideoClient`, each with a PNG reference from seed-0
   numpy noise: two of phase 5's geometry (4 steps, CFG 5) submitted
   together must run as one backend call of 2; one submitted while they
   run and cancelled must end `cancelled` and never reach the backend; one
   whose reference bytes are no image must end `failed` with PIL's error;
   one of 49 frames through the studio must show a non-decreasing progress
   ending at 1.0; `POST /workflow/full` with no LLM provider must complete
   on the offline first frame and list its artifacts. The flash kernel
   must launch exactly 14 (193 frames) or 8 (49 frames) times per forward
   pass, with 7 passes per request (`cfg_passes`: 4 positive, a negative
   at each expert's first step and at step 3), per backend call, and
   never for the cancelled or failed request; `peak_memory_mb` must equal
   `torch.cuda.max_memory_allocated` / 1e6; every clip downloaded over
   HTTP (the 49-frame one through the studio) must decode, and its file
   be byte-equal, to the same group run again in process through
   `pipe.generate` and saved with `save_video_with_audio`. Then the eval
   CLI (`python -m dualforce_tpu_torch.cli.eval CLIP --first_frame REF`)
   on a downloaded clip: its JSON's first-frame, temporal and audio
   numbers must be finite. Prints the load, each request's queue wait,
   `inference_time_s`, submit-to-download and download seconds and MB, and
   each group's prepare, step and decode seconds.
21. full fine-tuning: `cli.train.run` with `configs/training/lora_360p.py`
   from phase 17's checkpoint, `--set mesh={} trainer.mode=full` (video_dit,
   video_dit_2, audio_dit and the bridge train in bf16 with AdamW; lr 1e-4
   after one warmup step, constant) on phase 19's clips for 4 steps
   (experts 0, 1, 0, 1): finite losses and norms; per micro-step 16 forward,
   8 fused backward and 8 preprocess launches; the expert a step does not
   run bit-equal across it, its AdamW moments too (zeros before it first
   trains); every trained module differs from the checkpoint afterwards,
   the encoders do not. The step's per-module export loads back bit-equal
   through `load_module`; with phase 17's encoders linked beside it, it
   serves one 49-frame request through `cli.inference_single` (64 launches)
   whose clip is bit-equal to the same request in process on the trainer's
   modules. Then the first two steps again with
   `trainer.remat_save_attention=true`: the same losses bit for bit (the
   first step's lr is 0, so both see the checkpoint's weights), grad norms
   within 1e-2 relative (B2's dQ sums in a varying order), and 8 forward,
   8 fused backward and 8 preprocess launches per micro-step. Last, each of
   the sixteen registry optimizers takes two steps on 8.5 MB of fp32 and
   bf16 parameters on the card and on CPU copies: finite, the updates'
   relative L2 gap within 5e-3 (fp32) and 5e-2 (bf16). Prints per step the
   encode, loss+backward and optimizer seconds, the peaks with and without
   remat_save_attention, the export's and the resume state's GB and
   seconds, each line beside the card's name and power limit. The
   checkpoint's directory is removed.
22. group streaming and the disk store through the CLI (run after phase
   17, on its checkpoint): phase 5's first request through
   `cli.inference_single.run` with `--offload group --offload_group_size 1
   --offload_to_disk_path DIR` (the first run exports the store: the CLI
   prints its GB and seconds), with `--offload component
   --offload_to_disk_path DIR` (the manifest's fingerprint matches: no
   export) and with `--offload group --offload_resident_small
   --offload_resident_groups 1`: 112 launches each, each video bit-equal to
   phase 5's. Then, in process on the last pipeline, the request's
   `denoise_state` under `cfg_cache_interval` 2 as one call and as four
   chained one-step calls: bit-equal, the same launches.
23. the model code of A9: pooled AdaLN's per-frame pooling and AdaLN at
   360p geometry (y 49 x 880 tokens of width 5,120 over 40 heads, x 403
   tokens of width 1,536) in bf16 against the same functions in fp32 on
   the card (relative L2 <= 2e-2); with cuDNN's TF32 off, the DAC at
   MOVA's widths on phase 17's audio latents, `decompress` and `compress`
   in windows of 128 frames against `decode` and `encode_mode` (relative
   L2 <= 1e-4), and an RVQ DAC at the reference's defaults (9 codebooks of
   1024 x 8): `decode_codes` against `decode(z_q)` (<= 1e-4) and
   `compress`'s codes against the one pass's (>= 99 % equal, printed);
   the Wan VAE's `encode_sample_streaming` at 352x640x193 bit-equal to
   mean + exp(logvar / 2) * noise with the same noise.
24. serving under a mesh (run after phase 21, on phase 17's checkpoint,
   in the world phase 25 shares): one world of two processes on the one
   card under torchrun (this script with `--mesh-worker`; backend gloo,
   since NCCL refuses two ranks on one card): (a) the video self ring (40
   heads, 43,120 tokens split 21,560 / 21,560) and the v2a LSE combine (12
   heads, 404 queries x 43,120 keys) against B1 on the whole sequence
   computed here (relative L2 <= 1e-2), each ring step's kernel and
   transfer timed apart; (b) phase 17's base request through
   `cli.inference_single.run` at `--cp_size 2`: the clip within 2e-2
   relative L2 of phase 17's, the first step's block stack within 1e-2 of
   `forward_dual_tower` on the same inputs; (c) the same request at
   `--fsdp_size 2`: bit-equal to phase 17's, each rank holding half the
   block weights. B1's launches per rank with and without the LSE as the
   plan gives them (cp 2: 64 and 40; fsdp 2: 0 and 112); rank 0 writes
   each clip alone; per step and rank the seconds, bytes sent and peak
   memory.
25. training under a mesh, in the same world (the checkpoint read once in
   each rank, each training batch encoded once): `cli.train.run` with
   `configs/training/lora_360p.py` (352x640x49: 11,440 video and 103 audio
   tokens) from phase 17's checkpoint on phase 19's clips, 2 steps (experts
   0 then 1, lr 1e-3 after the warmup's 0), against the same run in this
   process first (`--set mesh={}`): (a) LoRA at `mesh.cp=2` (the ring's
   backward through B2 with its LSE cotangent): each step's loss within
   1e-2 relative, the global grad norm within 2e-2, each module's LoRA
   factors within 2e-2 relative L2, every LoRA b nonzero after step 2,
   every value finite; (b) LoRA at `mesh.fsdp=2`, losses and LoRA after each
   step bit-equal (every backward, here and in its reference, on the split
   pair, whose dq is deterministic), each rank holding half the block
   weights; (c) full fine-tuning of video_dit and the bridge at
   `mesh.fsdp=2` (AdamW, lr 1e-4, the split pair as in (b)): the first
   step's loss bit-equal, the trained weights within 1e-4 relative L2 after
   each step, each sharded tensor halved on each rank, rank 0's `step-2/`
   export equal to the gathered weights, the other rank's optimizer state
   beside it. Launches per rank and micro-step exactly as derived at
   `MESH_CALLS`; the two ranks' LoRAs bit-equal; per step and rank the
   encode, loss+backward and optimizer seconds, the bytes sent and seconds
   in collectives in the forward and in the backward, the peak.

Every phase prints its wall time, and a summary line before the kernels
lists every phase's seconds and the script's. The run sets
PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True unless the environment sets
it: phase 13 needs it to fit 193 frames on an 80 GB card.
The line before the last is the card's name and power limit; the one
before that lists each kernel as JSON. The last line of standard output is
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

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


PHASE_SECONDS = {}


def timed_phase(name: str, fn, *args):
    """fn(*args), with its wall time printed and kept for the summary."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[{name}] phase wall time {PHASE_SECONDS[name]:.1f} s")
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
        if sq * sk >= 10**8:    # seconds per call (3.5 s at video self): one call
            plain_ms = time_long_ms(lambda: flash_attention_plain(q, k, v), reps=1, warmup=0)
        else:
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
        if long:     # the checked calls above were the warm-ups; one timed call each
            fwd_ms = time_long_ms(lambda: fa.flash_attention_with_lse(q, k, v), reps=1,
                                  warmup=0)
            bwd_ms = time_long_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                                  reps=1, warmup=0)
            # the plain versions are yardsticks of seconds per call: one call each
            plain_fwd_ms = time_long_ms(
                lambda: fa.flash_attention_plain(*sub[:3], return_lse=True), reps=1, warmup=0)
            plain_bwd_ms = time_long_ms(
                lambda: fa.flash_attention_bwd_plain(*sub[:4], lse[:, heads], sub[4]),
                reps=1, warmup=0)
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
            if long:     # not the route here: one call (8.2 s at video self)
                fused_ms = time_long_ms(lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse,
                                                                             do), reps=1,
                                        warmup=0)
            else:
                fused_ms, _ = time_ms(lambda: fa.flash_attention_bwd_fused(q, k, v, o, lse, do),
                                      reps=7, warmup=2)
            fused_note = (f" fused_ms={fused_ms:.4f} (the fused kernel on the same inputs; "
                          f"split vs fused: " + " ".join(f"{gn}_rel={e:.3e}"
                                                          for gn, e in gap.items())
                          + f", dk/dv bit-equal {equal_kv})")
        del grads
        timer = ((lambda fn: time_long_ms(fn, reps=1, warmup=1)) if long else
                 (lambda fn: time_ms(fn, reps=7, warmup=2)[0]))
        pass_note, dq_pass_ms, dkv_pass_ms, dq_bound, dkv_bound = "", None, None, None, None
        if split:    # the split pair's passes one by one, each beside its own bound
            passes = fa._Bwd(q, k, v, o, lse, do, None, None, split=True)
            # the split backward above has warmed both passes
            pass_timer = ((lambda fn: time_long_ms(fn, reps=1, warmup=0)) if long else timer)
            dq_pass_ms, dkv_pass_ms = pass_timer(passes.dq_pass), pass_timer(passes.dkv_pass)
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
            nolse_ms = time_long_ms(lambda: fa.flash_attention(q, k, v), reps=1, warmup=0)
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

        lib_bwd_ms = (time_long_ms(sdpa_bwd, reps=1) if long else
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
    # one clip for both steps, its second encode served from the first (a cut: the
    # steps, their launches and checks as with two clips)
    clips = list(_synthetic_clips(1, TRAIN_720P["height"], TRAIN_720P["width"],
                                  TRAIN_720P["num_frames"], TRAIN_720P["audio_samples"]))
    clips *= TRAIN_720P_STEPS
    steps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the 720p train path's counts
    flash_attention.launches = flash_attention_bwd.launches = 0
    flash_attention_bwd.split_launches = flash_bwd_preprocess.launches = 0
    restore = _cached_encodes()
    t0 = time.perf_counter()
    try:
        final = trainer.train(clips, on_micro_step=steps.append)
    finally:
        restore()
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
# the full-depth requests of phases 14-15: phase 5's at 2 steps (step 0 on the high-noise
# expert, step 1 on the low-noise one: shift 5 puts t = 833 below the 900 boundary), cut from
# 4 to make room for the group-streamed requests; per request (30 shared layers x 6
# attentions + 10 tail layers x 2) x 2 CFG passes x 2 steps
FULL_DEPTH_STEPS = 2
FULL_DEPTH_REQUEST = dict(REQUEST, num_inference_steps=FULL_DEPTH_STEPS)
# phase 15's fp8-resident request: one step (the high-noise expert), cut from 2 to make room
# for the training world of phase 25
FP8_REQUEST = dict(REQUEST, num_inference_steps=1)
FULL_DEPTH_LAUNCHES = (30 * 6 + 10 * 2) * 2 * FULL_DEPTH_STEPS
# the group-streamed request: the CLI's default group size
GROUP_SIZE = 8
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
    def timed(module, device, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with real(module, device, **kw) as copy:
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
    holds them); then the same request through `offload="group"`."""
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
    plan = pipe._plan_for(dict(num_inference_steps=FULL_DEPTH_STEPS,
                               sigma_shift=FULL_DEPTH_REQUEST["sigma_shift"],
                               visual_shift=None, audio_shift=None))
    if plan.boundary_step != 1:
        raise AssertionError(f"boundary_step {plan.boundary_step}: step 0 must run the "
                             "high-noise expert and step 1 the low-noise one")
    names = {id(m): n for n, m in modules.items()}
    events, restore = _staging_spy(offload)
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (res, prep_s, step_s, dec_s), counts = _count_flash(lambda: _serve_request(
            pipe, "a cat playing the piano in a sunlit room", 0, FULL_DEPTH_REQUEST,
            np.random.default_rng(14)))
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        restore()
    staging = [(names[mid], t) for kind, mid, t in events if kind == "in"]
    rss, free = _host_memory()
    log(f"[full] staged bf16 request ({FULL_DEPTH_STEPS} steps, boundary_step 1): prepare "
        f"{prep_s:.2f} s, denoise steps {', '.join(f'{x:.2f}' for x in step_s)} s, decode "
        f"{dec_s:.2f} s; launches {counts}")
    log("[full] staging: " + "; ".join(
        f"{n} {sizes[n] / 2**30:.2f} GiB in {t:.3f} s ({sizes[n] / t / 1e9:.1f} GB/s)"
        for n, t in staging))
    log(f"[full] max_memory_allocated {peak / 2**30:.2f} GiB (limit: both experts' bf16 "
        f"bytes, {peak_limit / 2**30:.2f} GiB); allocated {mem0 / 2**30:.3f} GiB before, "
        f"{after / 2**30:.3f} GiB after; host rss {rss:.2f} GiB; free -g: {free}")
    _check_result(res, FULL_DEPTH_REQUEST)
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
    del pipe
    stats.update(_full_depth_group(cfg, modules, res, counts, sizes, step_s))
    return stats


def _full_depth_group(cfg, modules, staged, staged_counts, sizes, staged_step_s):
    """Phase 14's request through `offload="group"` (group size 8) on the same
    host masters, its denoise chained as two one-step ranges: bit-equal to
    the staged request with the same launches, the denoise's peak under one
    expert's bf16 bytes; then its first step again with `resident_small`,
    bit-equal to the first range."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.diffusion.streamed import StreamStats, plan_groups

    prompt, negative = "a cat playing the piano in a sunlit room", "blurry, low quality"
    image = np.random.default_rng(14).uniform(
        -1, 1, (REQUEST["height"], REQUEST["width"], 3)).astype("float32")
    expert = sizes["video_dit"]
    groups = plan_groups(cfg.bridge, cfg.video_dit.num_layers, GROUP_SIZE)

    def streaming_pipe(**kw):
        pipe = MOVAPipeline(cfg, modules, tokenizer=ByteTokenizer(),
                            compute_dtype=torch.bfloat16, device="cuda", offload="group",
                            offload_group_size=GROUP_SIZE, **kw)
        pipe.stream_stats = StreamStats()
        steps, last = [], [0.0]

        def on_step(step, total):
            torch.cuda.synchronize()
            now = time.perf_counter()
            nbytes, copy_s = pipe.stream_stats.take()
            steps.append((now - last[0], nbytes, copy_s))
            last[0] = now

        pipe.progress_cb = on_step
        return pipe, steps, last

    pipe, steps, last = streaming_pipe()
    peaks = {}

    def request():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = pipe.prepare_state([prompt], [image], negative_prompts=[negative], seeds=[0],
                                   **FULL_DEPTH_REQUEST)
        torch.cuda.synchronize()
        peaks["prepare"], prep_s = torch.cuda.max_memory_allocated(), time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        last[0] = time.perf_counter()
        first = pipe.denoise_state(state, max_steps=1)
        done = pipe.denoise_state(first)
        torch.cuda.synchronize()
        peaks["denoise"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = pipe.finalize_state(done)[0]
        torch.cuda.synchronize()
        peaks["decode"], dec_s = torch.cuda.max_memory_allocated(), time.perf_counter() - t0
        return res, state, first, prep_s, dec_s

    (res, state, first, prep_s, dec_s), counts = _count_flash(request)
    top = max(peaks, key=peaks.get)
    log(f"[full] group-streamed request (group size {GROUP_SIZE}, {len(groups)} groups, "
        f"denoise as two chained one-step ranges): prepare {prep_s:.2f} s, denoise steps "
        f"{', '.join(f'{t:.2f}' for t, _, _ in steps)} s (staged: "
        f"{', '.join(f'{t:.2f}' for t in staged_step_s)} s), decode {dec_s:.2f} s; "
        f"launches {counts}")
    for i, (t, nbytes, copy_s) in enumerate(steps):
        log(f"[full] group step {i}: {nbytes / 1e9:.3f} GB streamed, copy stream busy "
            f"{copy_s:.3f} s ({nbytes / max(copy_s, 1e-9) / 1e9:.1f} GB/s) of the step's "
            f"{t:.3f} s ({100 * copy_s / t:.1f} %); step minus staged step "
            f"{t - staged_step_s[i]:+.3f} s")
    log(f"[full] group peaks (max_memory_allocated): prepare {peaks['prepare'] / 2**30:.2f} "
        f"GiB, denoise {peaks['denoise'] / 2**30:.2f} GiB (limit: one expert's bf16 bytes, "
        f"{expert / 2**30:.2f} GiB), decode {peaks['decode'] / 2**30:.2f} GiB; the request's "
        f"peak {peaks[top] / 2**30:.2f} GiB, set by the {top}")
    same = np.array_equal(res.video, staged.video) and np.array_equal(res.audio, staged.audio)
    log(f"[full] group video and audio bit-equal to the staged request's: {same}")
    if not same:
        diff = np.abs(res.video.astype(np.int16) - staged.video.astype(np.int16))
        raise AssertionError(f"group-streamed request differs from the staged one: video "
                             f"{int(diff.max())} levels at most, audio rel L2 "
                             f"{np.linalg.norm(res.audio - staged.audio) / np.linalg.norm(staged.audio):.3e}")
    if counts != staged_counts:
        raise AssertionError(f"group launches {counts}, the staged request's {staged_counts}")
    if peaks["denoise"] >= expert:
        raise AssertionError(f"group denoise peak {peaks['denoise'] / 2**30:.2f} GiB, not "
                             f"under one expert's {expert / 2**30:.2f} GiB")
    del pipe

    small, small_steps, small_last = streaming_pipe(offload_resident_small=True)

    def one_step():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        small_last[0] = time.perf_counter()
        out = small.denoise_state(state, max_steps=1)
        torch.cuda.synchronize()
        return out

    out, small_counts = _count_flash(one_step)
    small_peak = torch.cuda.max_memory_allocated()
    t, nbytes, copy_s = small_steps[0]
    equal = all(torch.equal(out[k], first[k]) for k in ("latents", "audio_latents"))
    log(f"[full] resident_small step 0: {t:.2f} s, {nbytes / 1e9:.3f} GB streamed "
        f"({100 * (1 - nbytes / steps[0][1]):.1f} % fewer than without), copy stream busy "
        f"{copy_s:.3f} s ({nbytes / max(copy_s, 1e-9) / 1e9:.1f} GB/s); launches "
        f"{small_counts}; peak {small_peak / 2**30:.2f} GiB; latents bit-equal to the "
        f"group request's first range: {equal}")
    if not equal or small_counts["exact"] != FULL_DEPTH_LAUNCHES // FULL_DEPTH_STEPS:
        raise AssertionError(f"resident_small step: bit-equal {equal}, launches "
                             f"{small_counts}")
    return {"group_launches": counts["exact"], "group_peaks_gib": {
                k: v / 2**30 for k, v in peaks.items()},
            "group_steps": steps, "small_launches": small_counts["exact"],
            "small_bytes": nbytes}


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
        pipe, "a cat playing the piano in a sunlit room", 0, FP8_REQUEST,
        np.random.default_rng(14)))
    peak = torch.cuda.max_memory_allocated()
    log(f"[fp8] resident fp8 request: prepare {prep_s:.2f} s, denoise steps "
        f"{', '.join(f'{x:.2f}' for x in step_s)} s, decode {dec_s:.2f} s; launches {counts}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    _check_result(res, FP8_REQUEST)
    log(f"[fp8] video uint8 {res.video.shape} mean {res.video.mean():.2f}; audio "
        f"{res.audio.shape[0]} finite samples, rms {float(np.sqrt(np.mean(res.audio ** 2))):.4f}")
    want = {"exact": FULL_DEPTH_LAUNCHES // FULL_DEPTH_STEPS, "cap": 0, "sage": 0}
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
            "write_s": write_s, "ckpt": ckpt, "request": request,
            "audio_latents": kept["audio_latents"], "video": base.video, "audio": base.audio}


# phase 22: the group-streamed and disk-backed CLIs on phase 17's checkpoint. Each request
# is phase 5's first (4 steps; 112 launches) and must give its video bit for bit.
GROUP_CLI_RUNS = [
    ("serve_cli_group_disk", ["--offload", "group", "--offload_group_size", "1",
                              "--offload_to_disk_path", "STORE"]),
    ("serve_cli_component_disk", ["--offload", "component", "--offload_to_disk_path", "STORE"]),
    ("serve_cli_group_resident", ["--offload", "group", "--offload_resident_small",
                                  "--offload_resident_groups", "1"]),
]


def phase_group_cli(first, ckpt: dict, root: str):
    """Phase 22: phase 17's checkpoint through `cli.inference_single.run` with
    group streaming and the disk-backed store (the first run exports it, the
    second reads its manifest alone), each video bit-equal to phase 5's first
    request; then, in process on the last run's pipeline, `denoise_state`
    chained one step at a time under `cfg_cache_interval` 2 against one whole
    call."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.cli import inference_single as cli

    store = os.path.join(root, "store")
    want = {"exact": LAUNCHES_PER_REQUEST, "cap": 0, "sage": 0}
    launches, pipe = {}, None
    for name, flags in GROUP_CLI_RUNS:
        flags = [store if f == "STORE" else f for f in flags]
        args = cli.parse_args(["--ckpt_path", ckpt["ckpt"]] + flags + ckpt["request"])
        manifest = os.path.join(store, "manifest.json")
        before = os.path.getmtime(manifest) if os.path.exists(manifest) else None
        pipe = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (res, pipe), counts = _count_flash(lambda: cli.run(
            args, tokenizer=ByteTokenizer(), image=first["image"]))
        seconds = time.perf_counter() - t0
        exported = before is None or os.path.getmtime(manifest) != before
        same = np.array_equal(res.video, first["video"])
        disk = ("" if "--offload_to_disk_path" not in flags else
                f"store exported ({_dir_bytes(store) / 1e9:.3f} GB on disk); " if exported
                else "store read from its manifest, no export; ")
        log(f"[groupcli] {name}: {' '.join(flags)}: load and generate {seconds:.2f} s; "
            f"launches {counts}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{disk}video bit-equal to phase 5's first request: {same}")
        _check_result(res, REQUEST)
        if counts != want or not same:
            raise AssertionError(f"{name}: launches {counts} (expected {want}), video "
                                 f"bit-equal {same}")
        if name == "serve_cli_component_disk" and exported:
            raise AssertionError("the second run exported the store again")
        launches[name] = counts["exact"]

    # partial ranges with the negative cache, in process on the last run's pipeline
    kw = dict(height=REQUEST["height"], width=REQUEST["width"],
              num_frames=REQUEST["num_frames"], video_fps=REQUEST["video_fps"],
              num_inference_steps=REQUEST["num_inference_steps"],
              sigma_shift=REQUEST["sigma_shift"], cfg_scale=REQUEST["cfg_scale"],
              cfg_cache_interval=2)
    state = pipe.prepare_state([first["prompt"]], [first["image"]],
                               negative_prompts=[first["negative"]], seeds=[first["seed"]], **kw)
    t0 = time.perf_counter()
    whole, counts_whole = _count_flash(lambda: pipe.denoise_state(state))
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0

    def chained():
        part = state
        for _ in range(REQUEST["num_inference_steps"]):
            part = pipe.denoise_state(part, max_steps=1)
        return part

    t0 = time.perf_counter()
    part, counts_part = _count_flash(chained)
    torch.cuda.synchronize()
    equal = all(torch.equal(part[k], whole[k]) for k in ("latents", "audio_latents"))
    log(f"[groupcli] denoise_state under cfg_cache_interval 2: one call {whole_s:.2f} s, "
        f"launches {counts_whole}; four chained one-step calls "
        f"{time.perf_counter() - t0:.2f} s, launches {counts_part}; bit-equal: {equal}")
    if not equal or counts_part != counts_whole:
        raise AssertionError(f"chained ranges: bit-equal {equal}, launches {counts_part} "
                             f"against {counts_whole}")
    launches["serve_group_partial_ranges"] = counts_whole["exact"] + counts_part["exact"]
    del pipe
    shutil.rmtree(store, ignore_errors=True)
    return launches


# phase 23: the model code A9 ported. Pooled AdaLN at 360p token geometry in bf16 against
# fp32 on the same inputs; the DAC checks run with cuDNN's TF32 off (fp32 convolutions), so
# a window and the one pass differ only by the convolution algorithms' summation order.
POOL_REL_TOL = 2e-2
# (latent frames, height, width) of the 360p video tokens, the query-side heads, the video
# and audio widths, the audio tokens
POOL_GEOMETRY = dict(grid=(49, 22, 40), heads=40, kv_dim=5120, dim=1536, tokens=403)
DAC_WINDOW_REL_TOL = 1e-4
DAC_CHUNK_FRAMES = 128
RVQ_CODE_SHARE = 0.99


def phase_model_code(audio_latents):
    """Phase 23: pooled AdaLN's pooling and AdaLN at 360p geometry; the DAC's
    `decompress`/`compress` against `decode`/`encode_mode` at MOVA's widths
    with windows forced; an RVQ DAC at the reference's defaults
    (`encode_quantized`, `decode_codes` against `decode(z_q)`, `compress`'s
    codes against the one pass); the Wan VAE's `encode_sample_streaming`
    against its moments and the same noise."""
    import copy

    import numpy as np
    import torch

    from dualforce_tpu_torch.models import dac_vae, wan_vae
    from dualforce_tpu_torch.models.bridge import (_AdaLN, PerFramePooling,
                                                   adaln_from_pooled,
                                                   per_frame_attention_pooling)
    from dualforce_tpu_torch.models.factory import _build, _init_weights

    cfg = main_path_config()
    gen = torch.Generator("cuda").manual_seed(23)
    out = {}

    # 1. pooled AdaLN: y = 49 latent frames x 880 tokens at width 5120, 40 heads; x = the
    # 403 audio tokens at width 1536
    g = POOL_GEOMETRY
    grid, heads = g["grid"], g["heads"]
    pool = PerFramePooling(g["kv_dim"], cfg.bridge.eps, device="cuda", dtype=torch.bfloat16)
    adaln = _AdaLN(g["kv_dim"], g["dim"], device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for m in (pool, adaln):
            _init_weights(m, gen)
        y = torch.randn(1, math.prod(grid), g["kv_dim"], generator=gen,
                        device="cuda").bfloat16()
        x = torch.randn(1, g["tokens"], g["dim"], generator=gen, device="cuda").bfloat16()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pooled = per_frame_attention_pooling(pool, y, grid, heads)
        got = adaln_from_pooled(adaln, x, pooled)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        pool32, adaln32 = copy.deepcopy(pool).float(), copy.deepcopy(adaln).float()
        pooled32 = per_frame_attention_pooling(pool32, y.float(), grid, heads)
        want = adaln_from_pooled(adaln32, x.float(), pooled32)
    pool_err, out_err = rel_err(pooled, pooled32), rel_err(got, want)
    log(f"[model] pooled AdaLN at 360p geometry (y {tuple(y.shape)}, grid {grid}, {heads} "
        f"heads, x {tuple(x.shape)}) in bf16: {ms:.2f} ms (first call); against fp32 on the "
        f"card (TF32 "
        f"matmuls off): pooled rel L2 {pool_err:.3e}, conditioned x {out_err:.3e} (limit "
        f"{POOL_REL_TOL}); finite {bool(torch.isfinite(got).all())}")
    if not (pool_err <= POOL_REL_TOL and out_err <= POOL_REL_TOL
            and bool(torch.isfinite(got).all())):
        raise AssertionError("pooled AdaLN on the card disagrees with its fp32 run")
    out["pool_rel"] = out_err
    del pool, adaln, pool32, adaln32, y

    flags = dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    with torch.no_grad(), torch.backends.cudnn.flags(**flags):
        # 2. the shipped DAC: windows against the one pass on the 360p request's latents
        dac = _build(dac_vae.DACVAE, cfg.audio_vae, torch.device("cuda"), torch.float32, gen)
        z = audio_latents.to("cuda").float()
        t0 = time.perf_counter()
        wav = dac_vae.decode(dac, z)
        wav_w = dac_vae.decompress(dac, z, chunk_frames=DAC_CHUNK_FRAMES)
        mean = dac_vae.encode_mode(dac, wav)
        mean_w = dac_vae.compress(dac, wav, chunk_frames=DAC_CHUNK_FRAMES)
        torch.cuda.synchronize()
        dec_err, enc_err = rel_err(wav_w, wav), rel_err(mean_w, mean)
        log(f"[model] DAC at MOVA's widths, {z.shape[-1]} latent frames in windows of "
            f"{DAC_CHUNK_FRAMES} (+ {dac_vae.decoder_receptive_frames(cfg.audio_vae)} / "
            f"{dac_vae.encoder_receptive_frames(cfg.audio_vae)} frames of overlap): "
            f"decompress against decode rel L2 {dec_err:.3e}, compress against encode_mode "
            f"{enc_err:.3e} (limit {DAC_WINDOW_REL_TOL}); {time.perf_counter() - t0:.2f} s")
        if wav_w.shape != wav.shape or mean_w.shape != mean.shape or not (
                dec_err <= DAC_WINDOW_REL_TOL and enc_err <= DAC_WINDOW_REL_TOL):
            raise AssertionError("the DAC's windows disagree with its one pass")
        del dac

        # 3. an RVQ DAC at the reference's defaults (9 codebooks of 1024 x 8)
        rvq_cfg = dataclasses.replace(cfg.audio_vae, continuous=False)
        rvq = _build(dac_vae.DACVAE, rvq_cfg, torch.device("cuda"), torch.float32, gen)
        t0 = time.perf_counter()
        z_q, codes, _, commit, _ = dac_vae.encode_quantized(rvq, wav)
        from_codes = dac_vae.decode_codes(rvq, codes)
        from_zq = dac_vae.decode(rvq, z_q)
        codes_w = dac_vae.compress(rvq, wav, chunk_frames=DAC_CHUNK_FRAMES)
        torch.cuda.synchronize()
        rvq_err = rel_err(from_codes, from_zq)
        share = float((codes_w == codes).float().mean())
        stage0 = float((codes_w[:, 0] == codes[:, 0]).float().mean())
        log(f"[model] RVQ DAC ({rvq_cfg.n_codebooks} x {rvq_cfg.codebook_size} x "
            f"{rvq_cfg.codebook_dim}): codes {tuple(codes.shape)} {codes.dtype}, commitment "
            f"{float(commit):.4f}; decode_codes against decode(z_q) rel L2 {rvq_err:.3e} "
            f"(limit {DAC_WINDOW_REL_TOL}); compress's codes equal to the one pass's in "
            f"{share:.6f} of them (stage 0 {stage0:.6f}; limit {RVQ_CODE_SHARE}); "
            f"{time.perf_counter() - t0:.2f} s")
        if rvq_err > DAC_WINDOW_REL_TOL or share < RVQ_CODE_SHARE or \
                codes.shape != (1, rvq_cfg.n_codebooks, z.shape[-1]):
            raise AssertionError("the RVQ DAC disagrees with itself")
        del rvq, wav, wav_w

    # 4. the Wan VAE's sampled streaming encode at 360p (193 frames), TF32 convolutions
    # as the pipeline runs them, deterministic algorithms so that two encodes agree
    with torch.no_grad(), torch.backends.cudnn.flags(**dict(flags, allow_tf32=True)):
        vae = _build(wan_vae.WanVAE, cfg.video_vae, torch.device("cuda"), torch.float32, gen)
        video = torch.rand(1, REQUEST["num_frames"], REQUEST["height"], REQUEST["width"], 3,
                           generator=gen, device="cuda") * 2 - 1
        t0 = time.perf_counter()
        mean, logvar = wan_vae.encode_moments_streaming(vae, video)
        noise = torch.randn(mean.shape, generator=gen, device="cuda")
        sample = wan_vae.encode_sample_streaming(vae, video, noise=noise)
        torch.cuda.synchronize()
        by_hand = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        equal = torch.equal(sample, by_hand)
        log(f"[model] Wan VAE encode_sample_streaming at {REQUEST['height']}x"
            f"{REQUEST['width']}x{REQUEST['num_frames']}: latents {tuple(sample.shape)}, "
            f"bit-equal to mean + exp(logvar / 2) * noise: {equal}; two encodes "
            f"{time.perf_counter() - t0:.2f} s")
        if not equal:
            raise AssertionError("encode_sample_streaming is not its moments' draw")
    return out


# phase 18: the low-resource LoRA recipe (configs/training/lora_low_resource.py) at full
# depth. Per micro-step (B 1, 352x640x49: 11,440 video and 103 audio tokens) the 3
# video-side attentions of each of the 30 shared layers (video self, video text cross,
# a2v; the 103-query audio side takes plain attention) and the 2 of each of the 10 tail
# layers take the kernels: 110 calls, each forward twice under remat, each backward fused
# (Sq 11,440 < 98,305) after one delta preprocess
LOW_RESOURCE_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "training", "lora_low_resource.py")
FULL_TRAIN_FLASH_CALLS = 30 * 3 + 10 * 2
# the recipe's cuts: 3 optimizer steps of one micro-batch with the expert switched every
# step (experts 0, 1, 0): the warmup gives lr 0 at the first step, so expert 0 trains at a
# nonzero lr only at the third. (Phase 19 runs the recipe's accumulation of 4 micro-batches
# at the depth cut.)
FULL_TRAIN_CUTS = dict(max_steps=3, grad_accum_steps=1, expert_switch_interval=1)
FULL_TRAIN_EXPERTS = [0, 1, 0]


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
        final = trainer.train(_synthetic_clips(len(FULL_TRAIN_EXPERTS)), on_micro_step=record)
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
    done = _cached_loads()      # the resume reads its state from step-2/, its modules from here
    try:
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
    finally:
        done()
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


# phase 20: the port's server over HTTP, with examples/serve_360p.sh's settings (fp8 weights,
# the CFG negative pass cached every 3 steps, same-geometry requests batched by 2) and a warmup
# of the request's bucket. Per pass at the depth cut, 352x640x193 takes the flash kernel 14
# times (2 shared layers x 6 attentions + 1 tail layer x 2), 352x640x49 8 times (its 103 audio
# tokens take plain attention: 2 x 3 + 1 x 2); a group of B launches each at batch B
SERVE_FLAGS = ["--weight_dtype", "fp8", "--cfg_cache_interval", "3", "--max_batch", "2",
               "--warmup", "640x352x193x4"]
SERVE_CACHE_INTERVAL = 3
SERVE_SHORT_FRAMES = 49
SERVE_CALLS = {193: 2 * 6 + 1 * 2, SERVE_SHORT_FRAMES: 2 * 3 + 1 * 2}
# the workflow's LLM providers read these; unset, the full workflow runs its offline fallbacks
PROVIDER_ENV = ("GEMINI_API_KEY", "DASHSCOPE_API_KEY", "DUALFORCE_LLM_API_BASE",
                "DUALFORCE_LLM_API_KEY", "DUALFORCE_IMAGE_API_BASE", "DUALFORCE_IMAGE_API_KEY")


def cfg_passes(steps: int, boundary: int, interval: int) -> int:
    """Forward passes of a CFG request under `cfg_cache_interval` (the sampler's
    rule in `diffusion/sampler._denoise`): a positive pass every step; a negative
    one at each expert phase's first step (the cache is reset per phase) and at
    every step i with i % interval == 0."""
    neg = sum(i == start or i % interval == 0
              for start, stop in ((0, boundary), (boundary, steps))
              for i in range(start, stop))
    return steps + neg


def phase_serve_http(ckpt: str, root: str):
    """Phase 20: phase 17's checkpoint served by the port's own server
    (`cli.serve.build_server`) over HTTP on 127.0.0.1, with the studio's proxy
    in front of one request, then the eval CLI on a downloaded clip."""
    import dataclasses
    import io
    import threading
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from dualforce_tpu_torch.cli import serve as serve_cli
    from dualforce_tpu_torch.data.transforms import crop_and_resize, image_to_tensor
    from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
    from dualforce_tpu_torch.diffusion.sampler import build_plan
    from dualforce_tpu_torch.ops import sage_attention as sa
    from dualforce_tpu_torch.ops.flash_attention import flash_attention
    from dualforce_tpu_torch.serving.client import VideoClient
    from dualforce_tpu_torch.serving.server import serve_in_thread
    from dualforce_tpu_torch.utils.av_io import (ffmpeg_available, read_mjpeg_avi,
                                                 save_video_with_audio)
    from dualforce_tpu_torch.workflow.studio import Studio, parse_servers

    t_phase = time.perf_counter()
    for name in PROVIDER_ENV:
        os.environ.pop(name, None)
    out_dir = os.path.join(root, "serve_out")
    args = serve_cli.parse_args(["--ckpt_path", ckpt, "--host", "127.0.0.1",
                                 "--out_dir", out_dir] + SERVE_FLAGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = serve_cli.build_server(args, tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pipe = server.pipe
    sched = FlowMatchPairScheduler(pipe.cfg.scheduler)
    sched.set_timesteps(REQUEST["num_inference_steps"], shift=REQUEST["sigma_shift"])
    boundary = build_plan(sched, pipe.cfg.boundary_ratio).boundary_step
    passes = cfg_passes(REQUEST["num_inference_steps"], boundary, SERVE_CACHE_INTERVAL)
    want_launches = {f: calls * passes for f, calls in SERVE_CALLS.items()}
    log(f"[serve] build_server (checkpoint load in fp8, pipeline, warmup, server, UI) "
        f"{load_s:.2f} s; boundary_step={boundary}: {passes} passes per request under "
        f"cfg_cache_interval={SERVE_CACHE_INTERVAL}, so {want_launches[193]} flash launches "
        f"per 193-frame group and {want_launches[SERVE_SHORT_FRAMES]} per "
        f"{SERVE_SHORT_FRAMES}-frame one, whatever the group's size")

    # the backend, watched: each group's tasks, launches, prepare / step / decode seconds
    groups, started = [], threading.Event()
    real = server.batch_backend

    def spy(tasks, out, progress=None):
        rec = {"ids": [t.task_id for t in tasks], "start": time.time(), "steps": []}
        groups.append(rec)
        started.set()
        mark = [time.perf_counter()]
        prepare = pipe.prepare_state

        def timed_prepare(*a, **kw):
            state = prepare(*a, **kw)
            torch.cuda.synchronize(pipe.device)
            now = time.perf_counter()
            rec["prepare_s"], mark[0] = now - mark[0], now
            return state

        def on_progress(frac):
            torch.cuda.synchronize(pipe.device)
            now = time.perf_counter()
            rec["steps"].append(now - mark[0])
            mark[0] = now
            progress(frac)

        before = (flash_attention.launches, flash_attention.cap_launches,
                  sa.sage_attention.launches)
        pipe.prepare_state = timed_prepare
        try:
            return real(tasks, out, progress=on_progress)
        finally:
            del pipe.prepare_state
            rec["rest_s"] = time.perf_counter() - mark[0]
            rec["launches"] = flash_attention.launches - before[0]
            rec["other"] = (flash_attention.cap_launches - before[1],
                            sa.sage_attention.launches - before[2])
            rec["peak_mb"] = torch.cuda.max_memory_allocated(pipe.device) / 1e6

    server.batch_backend = spy
    rng = np.random.default_rng(0)
    h, w = REQUEST["height"], REQUEST["width"]

    def png():
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
        return buf.getvalue()

    negative = "blurry, low quality, distorted audio"
    common = dict(size=f"{w}x{h}", fps=REQUEST["video_fps"],
                  guidance_scale=REQUEST["cfg_scale"],
                  num_inference_steps=REQUEST["num_inference_steps"], negative_prompt=negative)
    requests = {}

    def submit(client, name, prompt, seed, image, frames):
        requests[name] = dict(prompt=prompt, seed=seed, image=image, frames=frames,
                              t0=time.perf_counter(), negative=negative)
        task = client.submit_video_task(prompt, image, num_frames=frames, seed=seed, **common)
        requests[name]["id"] = task.task_id
        return task

    def download(client, name, task):
        if task.status != "completed":
            raise AssertionError(f"request {name} ended {task.status}: {task.error}")
        ext = os.path.splitext(task.file_path)[1]
        dest = os.path.join(root, "serve_downloads", f"{name}{ext}")
        t0 = time.perf_counter()
        client.download(dataclasses.replace(task, file_path=None), dest)     # over HTTP
        requests[name].update(clip=dest, download_s=time.perf_counter() - t0,
                              done_s=time.perf_counter() - requests[name]["t0"], task=task)

    base, stop_server = serve_in_thread(server.app)
    studio_base, stop_studio = serve_in_thread(
        Studio(parse_servers(f"mova-360p={base}")).app)
    client = VideoClient(base, timeout=120)
    via_studio = VideoClient(studio_base, timeout=120)
    try:
        flash_attention.launches = flash_attention.cap_launches = 0   # the count starts here
        sa.sage_attention.launches = 0
        # 1. two requests of one geometry, submitted together: one group of 2 (the batching
        # window is widened while they arrive; it closes as soon as the second is in)
        window, server.batch_window_s = server.batch_window_s, 30.0
        a = submit(client, "a", "a cat playing the piano in a sunlit room", 0, png(), 193)
        b = submit(client, "b", "ocean waves at dusk, gulls calling over the surf", 1, png(),
                   193)
        if not started.wait(120):
            raise AssertionError("the worker never started the first group")
        server.batch_window_s = window
        # 3. a request cancelled while the group runs: still queued, so cancelled outright
        c = submit(client, "c", "a request cancelled in the queue", 2, png(), 193)
        cancel = client.cancel(c.task_id)
        log(f"[serve] cancel of a queued request answered {cancel.status!r}")
        for name, task in (("a", a), ("b", b)):
            download(client, name, client.wait_for_completion(task.task_id, 0.1, 900))
        # 4. reference bytes that are no image: failed with PIL's error
        d = submit(client, "d", "a request whose reference is not an image", 3,
                   b"these bytes are not an image", 193)
        d = client.wait_for_completion(d.task_id, 0.1, 300)
        # 2. a 49-frame request through the studio's proxy, its progress polled there
        e = submit(via_studio, "e", "a violinist on a quiet street at night", 4, png(),
                   SERVE_SHORT_FRAMES)
        seen = []
        deadline = time.time() + 600
        while time.time() < deadline:
            st = via_studio.get_task(e.task_id)
            seen.append(st.progress)
            if st.status in ("completed", "failed", "cancelled"):
                break
            time.sleep(0.05)
        download(via_studio, "e", st)
        # 5. the full workflow with no provider: the offline first frame, the idea as prompt
        body = json.dumps({"idea": "a drummer on a rooftop at sunset", "size": f"{w}x{h}",
                           "num_frames": SERVE_SHORT_FRAMES,
                           "num_inference_steps": REQUEST["num_inference_steps"],
                           "seed": 5}).encode()
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/workflow/full", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            full = json.load(r)
        with urllib.request.urlopen(f"{base}/workflow/tasks/{full['task_id']}/first_frame.png",
                                    timeout=60) as r:
            frame_png = r.read()
        requests["f"] = dict(prompt=full["rewritten_prompt"], seed=5, image=frame_png,
                             frames=SERVE_SHORT_FRAMES, t0=t0, negative="",
                             id=full["task_id"])
        download(client, "f", client.wait_for_completion(full["task_id"], 0.1, 600))
        with urllib.request.urlopen(f"{base}/workflow/tasks/{full['task_id']}",
                                    timeout=60) as r:
            artifacts = json.load(r)
        launches = flash_attention.launches                   # ... and is read here
        other = (flash_attention.cap_launches, sa.sage_attention.launches)
        final = {n: client.get_task(r["id"]) for n, r in requests.items()}
    finally:
        stop_studio()
        stop_server()
    serve_wall = time.perf_counter() - t_phase

    # statuses, groups, launches, memory
    statuses = {n: t.status for n, t in final.items()}
    want_status = dict(a="completed", b="completed", c="cancelled", d="failed", e="completed",
                       f="completed")
    log(f"[serve] statuses {statuses}; d's error: {final['d'].error!r}")
    if statuses != want_status or cancel.status != "cancelled":
        raise AssertionError(f"statuses {statuses} (cancel answered {cancel.status!r}), "
                             f"expected {want_status}: " + "; ".join(
                                 f"{n}: {t.error}" for n, t in final.items() if t.error))
    if "cannot identify image file" not in (final["d"].error or ""):
        raise AssertionError(f"the failed request's error is not PIL's: {final['d'].error!r}")
    ids = {r["id"]: n for n, r in requests.items()}
    by_group = [[ids[i] for i in g["ids"]] for g in groups]
    want_groups = [["a", "b"], ["d"], ["e"], ["f"]]
    want_group_launches = [want_launches[193], 0, want_launches[SERVE_SHORT_FRAMES],
                           want_launches[SERVE_SHORT_FRAMES]]
    log(f"[serve] backend calls {by_group}; flash launches per call "
        f"{[g['launches'] for g in groups]} (predicted {want_group_launches}); phase total "
        f"{launches}; cap and sage launches {other}")
    if by_group != want_groups:
        raise AssertionError(f"backend calls {by_group}, expected {want_groups}")
    if [g["launches"] for g in groups] != want_group_launches or \
            launches != sum(want_group_launches) or other != (0, 0) or \
            any(g["other"] != (0, 0) for g in groups):
        raise AssertionError("serve launches differ from the prediction")
    for n, t in final.items():
        if t.status != "completed":
            continue
        g = next(g for g in groups if t.task_id in g["ids"])
        if t.peak_memory_mb != g["peak_mb"]:
            raise AssertionError(f"{n}: peak_memory_mb {t.peak_memory_mb}, "
                                 f"max_memory_allocated / 1e6 {g['peak_mb']}")
        if t.progress != 1.0 or t.file_path.endswith(".avi") == ffmpeg_available():
            raise AssertionError(f"{n}: progress {t.progress}, file {t.file_path}")
    if seen != sorted(seen) or seen[-1] != 1.0:
        raise AssertionError(f"the studio-polled progress {seen} is not monotonic to 1.0")
    if {"first_frame.png", "idea.txt", "elements.txt", "prompt.txt"} - set(
            artifacts["artifacts"]) or artifacts.get("status") != "completed":
        raise AssertionError(f"full-workflow artifacts {artifacts}")
    for n in ("a", "b", "e", "f"):
        r, t = requests[n], final[n]
        g = next(g for g in groups if t.task_id in g["ids"])
        log(f"[serve] request {n} ({r['frames']} frames): queue wait "
            f"{g['start'] - t.raw['created_at']:.3f} s, inference_time_s {t.inference_time_s:.3f}, "
            f"submit to download {r['done_s']:.3f} s; download "
            f"{os.path.getsize(r['clip']) / 1e6:.2f} MB in {r['download_s']:.3f} s; "
            f"peak_memory_mb {t.peak_memory_mb:.1f}")
    for g, names in zip(groups, by_group):
        if g["steps"]:
            log(f"[serve] group {names}: prepare {g['prepare_s']:.3f} s, steps "
                f"{', '.join(f'{s:.3f}' for s in g['steps'])} s, decode and write "
                f"{g['rest_s']:.3f} s")
    log(f"[serve] studio-polled progress of e: {len(seen)} polls, values "
        f"{sorted(set(seen))}; full workflow's prompt {full['rewritten_prompt']!r}, "
        f"artifacts {sorted(artifacts['artifacts'])}")

    # every downloaded clip against its group run again in process, saved the same way
    for names in (["a", "b"], ["e"], ["f"]):
        rs = [requests[n] for n in names]
        images = [image_to_tensor(crop_and_resize(Image.open(io.BytesIO(r["image"]))
                                                  .convert("RGB"), h, w)) for r in rs]
        t0 = time.perf_counter()
        with torch.no_grad():
            results = pipe.generate(
                [r["prompt"] for r in rs], images, negative_prompts=[r["negative"] for r in rs],
                seeds=[r["seed"] for r in rs], height=h, width=w, num_frames=rs[0]["frames"],
                video_fps=REQUEST["video_fps"],
                num_inference_steps=REQUEST["num_inference_steps"],
                cfg_scale=REQUEST["cfg_scale"], cfg_scale_bridge=0.0,
                cfg_cache_interval=SERVE_CACHE_INTERVAL)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        for n, r, res in zip(names, rs, results):
            _check_result(res, dict(REQUEST, num_frames=r["frames"]))
            path = save_video_with_audio(os.path.join(root, "serve_in_process", f"{n}.mp4"),
                                         res.video, res.audio, fps=res.fps,
                                         sample_rate=res.sample_rate)
            got, want = read_mjpeg_avi(r["clip"]), read_mjpeg_avi(path)
            with open(r["clip"], "rb") as f, open(path, "rb") as g:
                same_bytes = f.read() == g.read()
            same = (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
                    and got[2:] == want[2:])
            log(f"[serve] {n}: the downloaded clip decodes to the in-process group's "
                f"({gen_s:.2f} s): {same}; files byte-equal: {same_bytes}")
            if not (same and same_bytes):
                raise AssertionError(f"{n}: the served clip differs from the in-process one")

    # the eval CLI on a downloaded clip (e's, 49 frames), against its reference frame
    ref = os.path.join(root, "serve_downloads", "e_ref.png")
    with open(ref, "wb") as f:
        f.write(requests["e"]["image"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dualforce_tpu_torch.cli.eval",
                           requests["e"]["clip"], "--first_frame", ref],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the eval CLI failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    numbers = {f"{k}.{m}": v for k in ("first_frame", "temporal", "audio")
               for m, v in report[k].items()}
    log(f"[serve] eval CLI on e's clip in {time.perf_counter() - t0:.2f} s: {numbers}")
    if not all(math.isfinite(v) for v in numbers.values()):
        raise AssertionError(f"the eval CLI's numbers are not finite: {numbers}")
    log(f"[serve] from build_server to the last download {serve_wall:.1f} s")
    # the server's worker thread (a daemon, as the JAX package's) keeps the server and
    # its pipeline alive after the phase: its modules leave the card here
    pipe.modules.clear()
    return {"launches": launches}


# phase 21: full fine-tuning through the training CLI (configs/training/lora_360p.py on one
# card, `trainer.mode=full`: video_dit, video_dit_2, audio_dit and the bridge train, AdamW),
# the per-module export served back through the inference CLI, remat_save_attention, and the
# optimizer registry on the card. Per micro-step (352x640x49) the 8 flash calls of phase 8;
# full remat runs each forward twice, remat_save_attention once
FULL_FT_STEPS = 4
FULL_FT_SAVE_STEPS = 2
FULL_FT_SETS = ["mesh={}", "trainer.mode=full", "trainer.warmup_steps=1",
                "trainer.lr_schedule=constant", "trainer.logger=jsonl",
                "trainer.log_interval=1", "trainer.save_interval=1000", "data.num_workers=1"]
FULL_FT_LAUNCHES = {False: (2 * TRAIN_FLASH_CALLS, TRAIN_FLASH_CALLS, TRAIN_FLASH_CALLS),
                    True: (TRAIN_FLASH_CALLS, TRAIN_FLASH_CALLS, TRAIN_FLASH_CALLS)}
# B2's dQ sums over key tiles in an order that varies between runs, so two runs' grads
# differ in their last bits: the global grad norms within the first relative gap, each
# parameter's gradient norm within the second (the largest gaps read on an H100: global
# 2.3e-6, per parameter 3.1e-4)
FULL_FT_NORM_REL_TOL = 1e-5
FULL_FT_LEAF_REL_TOL = 1e-3
# one AdamW step from fresh moments on a repeated batch (timestep and noise pinned) of
# the expert step 4 trained, at the run's lr and below it: the loss must fall at each lr
# below the run's (at the run's lr, Adam's first step moves every bf16 weight by ~lr at
# once and overshoots)
FULL_FT_PROBE_LRS = (1e-4, 1e-5, 1e-6)
LORA_360P_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                "training", "lora_360p.py")
# the registry on the card against CPU copies: the relative L2 gap between the two
# updates (parameter after two steps minus before), fp32 and bf16 parameters. The
# gradients (1e-2 a value, clipped to global norm 1 at both steps) and each family's lr
# make every family's bf16 update span at least REGISTRY_MIN_ULPS bf16 steps of the
# parameter (median; 8-60), so the bf16 gap measures arithmetic, not rounding. The
# largest gaps read on an H100: fp32 3.9e-7; bf16 1.05e-2 (Adadelta: PyTorch's CPU
# kernels round the scalar of `bf16 tensor + eps` to bf16 before adding, its CUDA
# kernels add it in fp32), 3.0e-3 (Adafactor, RMSprop, likewise), the rest <= 5.1e-4
REGISTRY_REL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
REGISTRY_PARAMS = [("float32", (1024, 1024)), ("bfloat16", (2048, 1024)),
                   ("float32", (4096,)), ("bfloat16", (136, 130))]
REGISTRY_LR = {"SGD": 1.0, "RAdam": 1.0, "Adagrad": 0.3, "Adadelta": 1.0, "Novograd": 1.0,
               "LAMB": 3e-2, "Adafactor": 3e-2}
REGISTRY_DEFAULT_LR = 1e-3
REGISTRY_MIN_ULPS = 4


def _patch(obj, name: str, make):
    """Replace obj.name by make(original); returns the restore function."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    return lambda: setattr(obj, name, real)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def _train_full_ft(argv, held=None):
    """`cli.train.run(argv)` with each micro-step's record kept (the trainer's
    `on_micro_step`) with `leaf_norms`, each parameter's gradient norm, the
    save timed and, with `held`, the expert each step holds checked bit-equal
    across it, its AdamW moments too (the checks' seconds are taken out of
    `optimizer_s`). Returns (trainer, records, {"export_s", "state_s"}, peak
    GiB, the last micro-step's encoded batch)."""
    import torch

    from dualforce_tpu_torch.cli import train as train_cli
    from dualforce_tpu_torch.engine import trainer as trainer_mod

    records, saves, checks, encoded = [], {}, [], [None]
    Trainer = trainer_mod.LoRATrainer

    def train(real):
        return lambda self, data, on_micro_step=None: real(self, data, records.append)

    def encode(real):
        def run(self, batch):
            encoded[0] = real(self, batch)
            return encoded[0]
        return run

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def apply(real):
        def run(self, grads, frozen=None):
            t0 = synced()
            norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                 for g in grads]).cpu()
            if held is not None:
                params = [p for p, f in zip(self.optimizer.params, frozen or []) if f]
                state = self.optimizer.opt.state
                before = [p.clone() for p in params]
                moments = [{k: v.clone() for k, v in state[p].items() if k != "step"}
                           for p in params]
            t1 = synced()
            out = real(self, grads, frozen)
            t2 = synced()
            if held is not None:
                same = all(torch.equal(p, b) for p, b in zip(params, before))
                kept = all(torch.equal(state[p][k], v)
                           for p, m in zip(params, moments) for k, v in m.items())
                # a parameter held before it ever trained gets optax's zero moments
                zero = all(not state[p]["exp_avg"].any() and not state[p]["exp_avg_sq"].any()
                           for p, m in zip(params, moments) if not m)
                held.append({"params": len(params), "equal": same and kept and zero})
            checks.append((norms, t1 - t0 + synced() - t2))
            return out
        return run

    def timed(key, real):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            saves[key] = time.perf_counter() - t0
            return out
        return run

    restores = [_patch(Trainer, "train", train), _patch(Trainer, "_apply", apply),
                _patch(Trainer, "_encode", encode),
                _patch(trainer_mod.lc, "export_trained_modules",
                       lambda real: timed("export_s", real)),
                _patch(trainer_mod, "save_checkpoint", lambda real: timed("state_s", real))]
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = train_cli.run(argv, tokenizer=ByteTokenizer())
    finally:
        for restore in restores:
            restore()
    for record, (norms, check_s) in zip(records, checks):
        record["leaf_norms"] = norms
        record["optimizer_s"] -= check_s
    return trainer, records, saves, torch.cuda.max_memory_allocated() / 2**30, encoded[0]


def _leaf_gap(a, b) -> float:
    """The largest relative gap between two runs' per-parameter gradient norms
    (a parameter whose gradient is zero in both counts 0)."""
    import torch

    top = torch.maximum(a, b)
    return float(torch.where(top > 0, (a - b).abs() / top.clamp_min(1e-30), 0.0).max())


def _repeat_batch_losses(trainer, encoded, expert: int):
    """[(lr, loss before, loss after)]: one AdamW step from fresh moments (the
    trainer's weight decay and clipping, constant lr) on `encoded` with its
    timestep and noise pinned, for each of FULL_FT_PROBE_LRS; the step trains
    the expert, audio_dit and the bridge, whose weights are put back after
    each lr."""
    import torch

    from dualforce_tpu_torch.diffusion import training as ttr
    from dualforce_tpu_torch.engine.optim import AdamW

    t = trainer.tcfg
    tower = "video_dit" if expert == 0 else "video_dit_2"
    trainable = {m: trainer.trainable[m] for m in (tower, "audio_dit", "bridge")}
    params = ttr.trainable_parameters(trainable)
    saved = [p.detach().clone() for p in params]
    gen = torch.Generator().manual_seed(21)
    tid = ttr.sample_timestep_id(gen, trainer.tables, expert, trainer.timestep_config)
    noise = tuple(torch.randn(encoded[k].shape, generator=gen)
                  for k in ("video_latents", "audio_latents"))
    kwargs = dict(video_fps=t.video_fps, compute_dtype=t.compute_dtype, remat=t.remat,
                  attn_impl=t.attn_impl, rope_pack=trainer._rope_pack(encoded),
                  timestep_config=trainer.timestep_config, noise_override=noise,
                  timestep_id=tid, device=trainer.device)
    out = []
    for lr in FULL_FT_PROBE_LRS:
        opt = AdamW(params, lr=lr, betas=t.betas, weight_decay=t.weight_decay,
                    max_grad_norm=t.max_grad_norm)
        before = ttr.full_ft_step(trainable, opt, trainer.modules, trainer.cfg,
                                  trainer.tables, encoded, None, expert, **kwargs)["loss"]
        del opt
        with torch.no_grad():
            after, _ = ttr.training_loss(None, trainer.modules, trainer.cfg, trainer.tables,
                                         encoded, None, expert,
                                         full_finetune_params=trainable, **kwargs)
            for p, x in zip(params, saved):
                p.copy_(x)
        out.append((lr, float(before), float(after)))
    return out


def _request_args(cli, ckpt: str, first, frames: int):
    return cli.parse_args(
        ["--ckpt_path", ckpt, "--prompt", first["prompt"], "--negative_prompt",
         first["negative"], "--seed", str(first["seed"]), "--ref_path",
         "unused (first frame given)", "--height", str(REQUEST["height"]), "--width",
         str(REQUEST["width"]), "--num_frames", str(frames), "--fps",
         str(REQUEST["video_fps"]), "--num_inference_steps",
         str(REQUEST["num_inference_steps"]), "--cfg_scale", str(REQUEST["cfg_scale"]),
         "--sigma_shift", str(REQUEST["sigma_shift"])])


def _registry_on_card(tag: str):
    """Each registry optimizer, two steps on the card and on CPU copies of the
    same parameters and gradients; returns {name: {dtype: worst relative gap}}."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.engine import optim

    rng = np.random.default_rng(21)
    init = [(dt, rng.standard_normal(shape).astype(np.float32) * 0.02)
            for dt, shape in REGISTRY_PARAMS]
    grads = [[rng.standard_normal(x.shape).astype(np.float32) * 1e-2 for _, x in init]
             for _ in range(2)]
    n_bytes = sum(x.size * (4 if dt == "float32" else 2) for dt, x in init)
    worst, spans = {}, {}
    for name in sorted(optim.OPTIMIZERS):
        ends = {}
        for device in ("cuda", "cpu"):
            params = [torch.tensor(x, device=device, dtype=getattr(torch, dt))
                      for dt, x in init]
            kwargs = dict(lr=REGISTRY_LR.get(name, REGISTRY_DEFAULT_LR), betas=(0.9, 0.999),
                          weight_decay=1e-2, max_grad_norm=1.0)
            try:
                opt = optim.build_optimizer(name, params, **kwargs)
            except TypeError:
                kwargs.pop("betas")
                opt = optim.build_optimizer(name, params, **kwargs)
            for step in grads:
                opt.step([torch.from_numpy(g).to(device=device, dtype=p.dtype)
                          for g, p in zip(step, params)])
            ends[device] = [p.float().cpu() for p in opt.params]
        gaps = {}
        for (dt, x), got, want in zip(init, ends["cuda"], ends["cpu"]):
            base = torch.from_numpy(x).to(getattr(torch, dt)).float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite parameters on the card")
            if dt == "bfloat16":
                # the update in bf16 steps of the parameter (2^(exponent - 7))
                step = torch.exp2(torch.floor(torch.log2(base.abs().clamp_min(1e-30))) - 7)
                span = float(((want - base).abs() / step).median())
                spans[name] = min(span, spans.get(name, span))
                if span < REGISTRY_MIN_ULPS:
                    raise AssertionError(f"{name} {tuple(x.shape)}: the bf16 update spans "
                                         f"{span} steps, fewer than {REGISTRY_MIN_ULPS}")
            gap = rel_err(got - base, want - base)
            gaps[dt] = max(gap, gaps.get(dt, 0.0))
            if gap > REGISTRY_REL_TOL[dt]:
                raise AssertionError(f"{name} {dt} {tuple(x.shape)}: the card's update is "
                                     f"{gap:.3e} from the CPU's (limit {REGISTRY_REL_TOL[dt]})")
        worst[name] = gaps
    log(f"[fullft] the sixteen registry optimizers, two steps each on {n_bytes / 1e6:.1f} MB "
        f"of fp32 and bf16 parameters on the card against CPU copies: relative L2 gap of "
        f"the updates, fp32 / bf16 (lr; median bf16 steps the update spans): " + ", ".join(
            f"{k} {v['float32']:.2e} / {v['bfloat16']:.2e} "
            f"({REGISTRY_LR.get(k, REGISTRY_DEFAULT_LR):g}; {spans[k]:g})"
            for k, v in worst.items())
        + f" (limits {REGISTRY_REL_TOL}); {tag}")
    return worst


def phase_full_ft(first, ckpt: str, root: str, smi: str):
    """Phase 21: full fine-tuning of the four diffusion modules through the
    training CLI from phase 17's checkpoint, the export served back, the
    remat_save_attention run, and the registry on the card."""
    import gc
    import shutil

    import numpy as np
    import torch

    from dualforce_tpu_torch.cli import inference_single as cli
    from dualforce_tpu_torch.convert import load_checkpoint as lc
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline

    tag = f"card: {smi}"
    meta = _write_clips(os.path.join(root, "clips"))
    base = [LORA_360P_RECIPE, "--set", f"pipeline.ckpt_path={ckpt}",
            f"data.metadata_path={meta}"] + FULL_FT_SETS

    # (a) four steps, experts 0, 1, 0, 1; the held expert checked at each
    save_dir = os.path.join(root, "full_ft")
    held = []
    trainer, steps, saves, peak, last_batch = _train_full_ft(
        base + [f"trainer.save_dir={save_dir}", f"trainer.max_steps={FULL_FT_STEPS}"], held)
    cfg = trainer.cfg
    n_train = sum(p.numel() for m in trainer.trainable.values() for p in m.parameters())
    for i, st in enumerate(steps):
        log(f"[fullft] step {i + 1}: expert {st['expert']} loss {st['loss']:.5f} grad_norm "
            f"{st['grad_norm']:.5f}; encode {st['encode_s']:.3f} s, loss+backward "
            f"{st['loss_backward_s']:.3f} s, optimizer {st['optimizer_s']:.3f} s; launches "
            f"fwd {st['flash_fwd']} bwd {st['flash_bwd']} preprocess "
            f"{st['flash_bwd_preprocess']}; {tag}")
    step_dir = os.path.join(save_dir, f"step-{FULL_FT_STEPS}")
    export_gb = sum(_dir_bytes(os.path.join(step_dir, lc.MODULES[n][0]))
                    for n in trainer.trainable) / 1e9
    state_gb = os.path.getsize(os.path.join(step_dir, "state.pt")) / 1e9
    log(f"[fullft] full fine-tuning of {sorted(trainer.trainable)} ({n_train / 1e9:.3f} B "
        f"parameters, bf16, AdamW): peak {peak:.2f} GiB without remat_save_attention; "
        f"export {export_gb:.3f} GB in {saves['export_s']:.2f} s; resume state (state.pt: "
        f"optimizer and generator; the weights are the export) {state_gb:.3f} GB in "
        f"{saves['state_s']:.2f} s; {tag}")
    if trainer.global_step != FULL_FT_STEPS or [s["expert"] for s in steps] != [0, 1, 0, 1]:
        raise AssertionError(f"step {trainer.global_step}, experts "
                             f"{[s['expert'] for s in steps]}")
    for st in steps:
        if not all(math.isfinite(st[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"non-finite metrics {st}")
        got = (st["flash_fwd"], st["flash_bwd"], st["flash_bwd_preprocess"])
        if got != FULL_FT_LAUNCHES[False] or st["flash_bwd_split"]:
            raise AssertionError(f"launches per micro-step {got}, split "
                                 f"{st['flash_bwd_split']}; expected {FULL_FT_LAUNCHES[False]}")
    if len(held) != FULL_FT_STEPS or not all(h["equal"] and h["params"] for h in held):
        raise AssertionError(f"the held expert moved: {held}")
    changed = {}
    for name in list(trainer.trainable) + list(trainer._ENCODERS):
        ref = lc.load_module(ckpt, name, cfg, dtype=torch.bfloat16, device="cuda")
        changed[name] = any(not torch.equal(p, q) for p, q in
                            zip(trainer.modules[name].parameters(), ref.parameters()))
        del ref
    log(f"[fullft] held expert bit-equal across each step, AdamW moments too: "
        f"{[h['params'] for h in held]} tensors; differs from the checkpoint: {changed}")
    if not all(changed[n] for n in trainer.trainable) or any(
            changed[n] for n in trainer._ENCODERS):
        raise AssertionError(f"trained modules must differ and encoders not: {changed}")

    # (b) the export loads back bit-equal and serves as a checkpoint
    for name, module in trainer.trainable.items():
        back = lc.load_module(step_dir, name, cfg, dtype=torch.bfloat16, device="cuda")
        if not all(torch.equal(p, q) for p, q in zip(back.parameters(), module.parameters())):
            raise AssertionError(f"the exported {name} differs from the trainer's")
        del back
    served = os.path.join(root, "full_ft_served")
    os.makedirs(served)
    for name in lc.module_names(ckpt):
        sub = lc.MODULES[name][0]
        src = step_dir if name in trainer.trainable else ckpt
        os.symlink(os.path.join(src, sub), os.path.join(served, sub))
    shutil.copy(os.path.join(ckpt, "model_index.json"), served)
    args = _request_args(cli, served, first, SERVE_SHORT_FRAMES)
    t0 = time.perf_counter()
    (res, pipe), counts = _count_flash(lambda: cli.run(args, tokenizer=ByteTokenizer(),
                                                       image=first["image"]))
    serve_s = time.perf_counter() - t0
    del pipe
    torch.cuda.empty_cache()
    pipe = MOVAPipeline(cfg, trainer.modules, tokenizer=ByteTokenizer(),
                        compute_dtype=torch.bfloat16, device="cuda", attn_impl=args.attn_type,
                        quantize=args.quantize, offload="none", mask_ctx_pad=args.mask_ctx_pad)
    with torch.no_grad():
        again = pipe(prompt=args.prompt, image=cli.first_frame(args, first["image"]),
                     negative_prompt=args.negative_prompt, seed=args.seed,
                     height=args.height, width=args.width, num_frames=args.num_frames,
                     video_fps=args.fps, num_inference_steps=args.num_inference_steps,
                     sigma_shift=args.sigma_shift, visual_shift=args.visual_shift,
                     audio_shift=args.audio_shift, cfg_scale=args.cfg_scale,
                     cfg_batch=args.cfg_batch, cfg_cache_interval=args.cfg_cache_interval,
                     cfg_scale_bridge=args.cfg_scale_bridge)
    request = {**REQUEST, "num_frames": SERVE_SHORT_FRAMES}
    _check_result(res, request)
    want = SERVE_CALLS[SERVE_SHORT_FRAMES] * 2 * REQUEST["num_inference_steps"]
    same = np.array_equal(res.video, again.video) and np.array_equal(res.audio, again.audio)
    log(f"[fullft] the export with phase 17's encoders linked in, through "
        f"`cli.inference_single` (load, generate) {serve_s:.2f} s: launches {counts}; video "
        f"{res.video.shape} and audio bit-equal to the same request in process on the "
        f"trainer's modules: {same}; {tag}")
    if counts != {"exact": want, "cap": 0, "sage": 0} or not same:
        raise AssertionError(f"served from the export: launches {counts} (want {want}), "
                             f"bit-equal {same}")
    del pipe
    trainer.optimizer = None                # its moments leave the card for the probe
    gc.collect()
    torch.cuda.empty_cache()

    # the update's direction: a repeated batch's loss after one step, at the run's lr
    # and below it
    expert = steps[-1]["expert"]
    probe = _repeat_batch_losses(trainer, last_batch, expert)
    log(f"[fullft] step {FULL_FT_STEPS}'s batch again (expert {expert}, timestep and noise "
        f"pinned), one AdamW step from fresh moments: " + ", ".join(
            f"lr {lr:g}: loss {b:.5f} -> {a:.5f}" for lr, b, a in probe) + f"; {tag}")
    if len({b for _, b, _ in probe}) != 1 or not all(
            math.isfinite(a) for _, _, a in probe) or not all(a < b for _, b, a in probe[1:]):
        raise AssertionError(f"the repeated batch's loss must fall at each lr below "
                             f"{FULL_FT_PROBE_LRS[0]:g}, from one start: {probe}")
    del trainer, last_batch
    shutil.rmtree(save_dir)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the first two steps again with remat_save_attention
    trainer, kept, _, peak_kept, _ = _train_full_ft(
        base + [f"trainer.save_dir={os.path.join(root, 'full_ft_remat_save')}",
                f"trainer.max_steps={FULL_FT_SAVE_STEPS}",
                "trainer.remat_save_attention=true"])
    for i, (a, b) in enumerate(zip(steps, kept)):
        log(f"[fullft] remat_save_attention step {i + 1}: loss {b['loss']:.6f} (full remat "
            f"{a['loss']:.6f}), grad_norm {b['grad_norm']:.6f} ({a['grad_norm']:.6f}), "
            f"relative gap {abs(b['grad_norm'] - a['grad_norm']) / a['grad_norm']:.2e}, "
            f"worst per-parameter gradient norm gap "
            f"{_leaf_gap(a['leaf_norms'], b['leaf_norms']):.2e} over "
            f"{len(a['leaf_norms'])} tensors; loss+backward {b['loss_backward_s']:.3f} s "
            f"({a['loss_backward_s']:.3f}); launches fwd {b['flash_fwd']} bwd "
            f"{b['flash_bwd']} preprocess {b['flash_bwd_preprocess']}; {tag}")
    log(f"[fullft] peak {peak_kept:.2f} GiB with remat_save_attention, {peak:.2f} without; "
        f"{tag}")
    if not trainer.tcfg.remat_save_attention or len(kept) != FULL_FT_SAVE_STEPS:
        raise AssertionError(f"remat_save_attention {trainer.tcfg.remat_save_attention}, "
                             f"{len(kept)} steps")
    for a, b in zip(steps, kept):
        got = (b["flash_fwd"], b["flash_bwd"], b["flash_bwd_preprocess"])
        gap = abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
        leaf = _leaf_gap(a["leaf_norms"], b["leaf_norms"])
        if got != FULL_FT_LAUNCHES[True] or b["loss"] != a["loss"] \
                or gap > FULL_FT_NORM_REL_TOL or leaf > FULL_FT_LEAF_REL_TOL:
            raise AssertionError(f"remat_save_attention: launches {got} (want "
                                 f"{FULL_FT_LAUNCHES[True]}), loss {b['loss']} vs "
                                 f"{a['loss']}, grad_norm gap {gap:.3e} (limit "
                                 f"{FULL_FT_NORM_REL_TOL}), per-parameter {leaf:.3e} "
                                 f"(limit {FULL_FT_LEAF_REL_TOL})")
    del trainer
    shutil.rmtree(os.path.join(root, "full_ft_remat_save"))
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the registry on the card
    registry = _registry_on_card(tag)

    def total(records):
        return {k: sum(st[f"flash_{k}"] for st in records)
                for k in ("fwd", "bwd", "bwd_split", "bwd_preprocess")}

    return {"launches": total(steps), "launches_save": total(kept), "peak_gib": peak,
            "peak_save_gib": peak_kept, "registry": registry}


# phase 24: serving over a (1, fsdp, cp) mesh, each rank a process on the one card. cp 2 at
# MOVA-360p: 43,120 video tokens split 21,560 / 21,560, 403 audio tokens padded to 404 and
# split 202 / 202. Per pass and rank at the depth cut (2 shared layers, 1 tail layer), B1
# with its LSE: the video self ring's 2 steps in each of the 3 video layers and the v2a
# combine in each shared layer; without: a2v and the video text cross in each shared layer,
# the text cross in the tail layer. The audio side's 202 local queries take plain attention
# (the dispatcher's Sq >= 256 gate). Under fsdp 2 x cp 1 each rank runs phase 17's request
# whole: 112 launches without the LSE.
SP_CP = 2
SP_PASSES = 2 * REQUEST["num_inference_steps"]
SP_LAUNCHES = {"cp2": {"lse": (3 * SP_CP + 2) * SP_PASSES, "nolse": (2 * 2 + 1) * SP_PASSES},
               "fsdp2": {"lse": 0, "nolse": LAUNCHES_PER_REQUEST}}
SP_PRIM_REL_TOL = 1e-2          # bf16 outputs, fp32 accumulation and combine
SP_BLOCKS_REL_TOL = 1e-2
SP_CLI_REL_TOL = 2e-2           # phase 16's bound for cfg_batch
SP_SHARE_MAX = 0.55             # a rank's share of the block weights under fsdp 2
SP_VIDEO = (1, 43120, 40)       # (B, tokens, heads) of the video self ring
SP_V2A = (1, 404, 12)           # the v2a combine's queries (403 audio tokens padded)
SP_TIMEOUT_S = 900


def _sp_inputs(b, s, n, seed, device="cuda"):
    """q, k, v [b, s, n, 128] bf16 from a CUDA generator: every process that
    draws them with the same seed gets the same values."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((b, s, n, HEAD_DIM), generator=g, device=device,
                        dtype=torch.bfloat16) for _ in range(3)]


SP_RUNS = (("cp2", ["--cp_size", str(SP_CP)]), ("fsdp2", ["--fsdp_size", "2"]))


def _sp_count_launches(fa):
    """Wrap the forward's launcher to count B1 launches with and without the
    LSE while counting["on"]; returns (counts, counting)."""
    counts, counting = {"lse": 0, "nolse": 0}, {"on": True}
    launch = fa._launch_fwd

    def counted(q, k, v, kv_valid_len, with_lse, softmax_cap):
        out = launch(q, k, v, kv_valid_len, with_lse, softmax_cap)
        if counting["on"] and k.shape[1] > 0:
            counts["lse" if with_lse else "nolse"] += 1
        return out

    fa._launch_fwd = counted
    return counts, counting


def _sp_primitives(out: str) -> dict:
    """(a) in one rank: the video self ring and the v2a combine at the
    path's shapes, each ring step's kernel and transfer timed apart."""
    import torch

    from dualforce_tpu_torch.ops import flash_attention as fa
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel import ring_attention as ra

    mesh = pm.create_mesh(1, 1, SP_CP)
    axis = pm.MeshAxis(mesh, "cp")
    r, n = pm.axis_index(axis), pm.axis_size(axis)
    steps = []

    def inner(q, k, v, kv_valid=None):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o = ra._inner_auto(q, k, v, kv_valid)
        end.record()
        end.synchronize()
        steps.append({"kernel_ms": start.elapsed_time(end)})
        return o

    permute = pm.ppermute_next

    def timed_permute(tensors, ax):
        torch.cuda.synchronize()
        t0, b0 = time.perf_counter(), pm.TRANSFER["bytes"]
        got = permute(tensors, ax)
        torch.cuda.synchronize()
        steps[-1].update(transfer_ms=1e3 * (time.perf_counter() - t0),
                         transfer_mb=(pm.TRANSFER["bytes"] - b0) / 1e6)
        return got

    pm.ppermute_next = timed_permute
    report = {}
    try:
        with torch.no_grad():
            b, s, heads = SP_VIDEO
            q, k, v = (t[:, r * s // n:(r + 1) * s // n] for t in _sp_inputs(b, s, heads, 0))
            for _ in range(2):         # the first call loads the kernel
                steps.clear()
                fa.flash_attention.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = ra.ring_attention(q, k, v, axis, inner)
                torch.cuda.synchronize()
                report["ring_s"] = time.perf_counter() - t0
            report["ring_steps"] = list(steps)
            report["ring_launches"] = fa.flash_attention.launches
            torch.save(o.cpu(), os.path.join(out, f"ring.rank{r}.pt"))
            b, sq, heads = SP_V2A
            qa = _sp_inputs(b, sq, heads, 1)[0]
            ka, va = (t[:, r * s // n:(r + 1) * s // n] for t in _sp_inputs(b, s, heads, 2)[1:])
            steps.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            oa = ra.lse_combine_cross_attention(qa, ka, va, axis, inner)
            torch.cuda.synchronize()
            report["v2a_s"], report["v2a_kernel_ms"] = (time.perf_counter() - t0,
                                                        steps[0]["kernel_ms"])
            torch.save(oa.cpu(), os.path.join(out, f"v2a.rank{r}.pt"))
    finally:
        pm.ppermute_next = permute
    report["transfer"] = dict(pm.TRANSFER)
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return report


def _sp_serve(out: str, argv, runs) -> dict:
    """Phase 24's requests in one rank of the world: phase 17's base request
    through the CLI's `run` at each of `runs` (names of `SP_RUNS`; rank 0
    writes each clip, as the CLI's `finish` does), launches counted, each
    step's seconds, bytes and peak read, and at cp > 1 the first step's
    block stack held against `forward_dual_tower` on the same inputs. The
    spies it installs are removed before it returns."""
    import gc

    import numpy as np
    import torch

    from dualforce_tpu_torch.cli import inference_single as cli
    from dualforce_tpu_torch.diffusion import step as step_mod
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.models.dual_tower import forward_dual_tower
    from dualforce_tpu_torch.ops import flash_attention as fa
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel import sharding

    launch = fa._launch_fwd
    counts, counting = _sp_count_launches(fa)
    reports, report = {}, {}
    sp_blocks = step_mod.sp_forward_blocks

    def spy(mesh, *args, **kwargs):
        got = sp_blocks(mesh, *args, **kwargs)
        if report["blocks_rel"] is None and pm.mesh_shape(mesh)["cp"] > 1:
            report["blocks_rel"] = []
            if pm.rank() == 0:          # the plain stack, not counted; no collective
                counting["on"] = False
                before = fa.flash_attention.launches
                want = forward_dual_tower(*args, **kwargs)
                report["extra"] = fa.flash_attention.launches - before
                counting["on"] = True
                report["blocks_rel"] = [rel_err(g, w.float()) for g, w in zip(got, want)]
        return got

    denoise_state = MOVAPipeline.denoise_state
    last = [0.0, 0]

    def on_step(step, total):
        torch.cuda.synchronize()
        now = time.perf_counter()
        report["steps"].append({"s": now - last[0], "mb": (pm.TRANSFER["bytes"] - last[1]) / 1e6,
                                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        last[:] = [now, pm.TRANSFER["bytes"]]

    def denoise(self, state, max_steps=None):
        self.progress_cb = on_step
        torch.cuda.synchronize()
        last[:] = [time.perf_counter(), pm.TRANSFER["bytes"]]
        return denoise_state(self, state, max_steps)

    step_mod.sp_forward_blocks = spy
    MOVAPipeline.denoise_state = denoise
    image = np.load(os.path.join(out, "first_frame.npy"))
    try:
        for name, flags in SP_RUNS:
            if name not in runs:
                continue
            report = reports[name] = {"steps": [], "blocks_rel": None, "extra": 0}
            counts.update(lse=0, nolse=0)
            fa.flash_attention.launches = 0
            pm.TRANSFER.update(bytes=0, seconds=0.0, calls=0)
            torch.cuda.reset_peak_memory_stats()
            args = cli.parse_args(argv + ["--output", os.path.join(out, f"{name}.mp4")] + flags)
            t0 = time.perf_counter()
            res, pipe = cli.run(args, tokenizer=ByteTokenizer(), image=image)
            report.update(run_s=time.perf_counter() - t0, launches=dict(counts),
                          counter=fa.flash_attention.launches, transfer=dict(pm.TRANSFER),
                          block_bytes=sharding.block_bytes(pipe.modules),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            if pm.rank() == 0:
                np.savez(os.path.join(out, f"{name}_result.npz"), video=res.video,
                         audio=res.audio)
                cli.save(args, res)
            del res, pipe
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        step_mod.sp_forward_blocks = sp_blocks
        MOVAPipeline.denoise_state = denoise_state
        fa._launch_fwd = launch
        counting["on"] = False
    return reports


def _check_sp(reps, ckpt: dict, out: str) -> dict:
    """Phase 24's checks on the world's reports (`mesh_worker`): (a) the SP
    primitives at the path's shapes against B1 over the whole sequence, then
    phase 17's base request through the CLI at `--cp_size 2` and
    `--fsdp_size 2` against phase 17's clip. Returns each request's B1
    launches, summed over both ranks."""
    import numpy as np
    import torch

    from dualforce_tpu_torch.ops.flash_attention import flash_attention

    log(f"[sp] backend {reps[0]['backend']} in both ranks (two ranks on one card: NCCL "
        f"refuses it)")

    # (a) the primitives at the path's shapes against B1 over the whole sequence
    b, s, heads = SP_VIDEO
    with torch.no_grad():
        q, k, v = _sp_inputs(b, s, heads, 0)
        want = flash_attention(q, k, v).float()
        got = torch.cat([torch.load(os.path.join(out, f"ring.rank{r}.pt")) for r in range(2)],
                        dim=1).cuda()
        ring_rel = rel_err(got, want)
        del q, k, v, want, got
        qa = _sp_inputs(1, SP_V2A[1], SP_V2A[2], 1)[0]
        _, ka, va = _sp_inputs(b, s, SP_V2A[2], 2)
        want = flash_attention(qa, ka, va).float()
        v2a_rel = [rel_err(torch.load(os.path.join(out, f"v2a.rank{r}.pt")).cuda(), want)
                   for r in range(2)]
        del qa, ka, va, want
    torch.cuda.empty_cache()
    for r, rep in enumerate(x["primitives"] for x in reps):
        log(f"[sp] (a) rank {r}: video self ring (40 heads, {s // SP_CP} local queries) "
            f"{rep['ring_s']:.3f} s, {rep['ring_launches']} B1 launches; per step " + "; ".join(
                f"kernel {st['kernel_ms']:.2f} ms" + (f", transfer {st['transfer_ms']:.1f} ms "
                                                      f"({st['transfer_mb']:.1f} MB)"
                                                      if "transfer_ms" in st else "")
                for st in rep["ring_steps"])
            + f"; v2a combine {rep['v2a_s'] * 1e3:.1f} ms (kernel {rep['v2a_kernel_ms']:.2f} "
            f"ms); sent {rep['transfer']['bytes'] / 1e6:.1f} MB in "
            f"{rep['transfer']['seconds']:.3f} s over {rep['transfer']['calls']} calls; peak "
            f"{rep['peak_gib']:.2f} GiB")
    log(f"[sp] (a) ring against B1 on the whole sequence: rel L2 {ring_rel:.3e}; v2a "
        f"combine: {v2a_rel[0]:.3e} / {v2a_rel[1]:.3e} (limit {SP_PRIM_REL_TOL})")
    if max([ring_rel] + v2a_rel) > SP_PRIM_REL_TOL:
        raise AssertionError(f"SP primitives off B1: ring {ring_rel:.3e}, v2a {v2a_rel}")
    if any(x["primitives"]["ring_launches"] != SP_CP for x in reps):
        raise AssertionError("a ring step did not launch B1 once")

    # (b), (c): phase 17's base request through the CLI
    launches = {}
    for name, _ in SP_RUNS:
        res = np.load(os.path.join(out, f"{name}_result.npz"))
        for r, rep in enumerate(x[name] for x in reps):
            log(f"[sp] ({name}) rank {r}: run (load, generate) {rep['run_s']:.2f} s; steps "
                + ", ".join(f"{st['s']:.2f} s / {st['mb']:.0f} MB / peak {st['peak_gib']:.2f} "
                            "GiB" for st in rep["steps"])
                + f"; sent {rep['transfer']['bytes'] / 1e9:.3f} GB in "
                f"{rep['transfer']['seconds']:.2f} s over {rep['transfer']['calls']} calls; "
                f"B1 launches {rep['launches']} (counter {rep['counter'] - rep['extra']}); "
                f"block weights {rep['block_bytes'] / 1e9:.3f} GB; peak {rep['peak_gib']:.2f} "
                "GiB")
            if (rep["launches"] != SP_LAUNCHES[name]
                    or rep["counter"] - rep["extra"] != sum(SP_LAUNCHES[name].values())):
                raise AssertionError(f"{name} rank {r}: launches {rep['launches']} (counter "
                                     f"{rep['counter'] - rep['extra']}), expected "
                                     f"{SP_LAUNCHES[name]}")
        launches[name] = sum(x[name]["counter"] - x[name]["extra"] for x in reps)
        _check_result(types.SimpleNamespace(video=res["video"], audio=res["audio"]), REQUEST)
        v_rel = rel_err(torch.from_numpy(res["video"].astype(np.float32)),
                        torch.from_numpy(ckpt["video"].astype(np.float32)))
        a_rel = rel_err(torch.from_numpy(res["audio"]), torch.from_numpy(ckpt["audio"]))
        same = (np.array_equal(res["video"], ckpt["video"])
                and np.array_equal(res["audio"], ckpt["audio"]))
        log(f"[sp] ({name}) against phase 17's base request: video rel L2 {v_rel:.3e}, audio "
            f"{a_rel:.3e}, bit-equal {same}")
        written = [f for f in os.listdir(out) if f.startswith(f"{name}.")]
        if len(written) != 1:
            raise AssertionError(f"{name}: files written {written}, expected rank 0's alone")
    blocks = reps[0]["cp2"]["blocks_rel"]
    log(f"[sp] (cp2) the first step's block stack against forward_dual_tower on the same "
        f"inputs: video rel L2 {blocks[0]:.3e}, audio {blocks[1]:.3e} (limit "
        f"{SP_BLOCKS_REL_TOL}); the clip against phase 17's within {SP_CLI_REL_TOL}")
    res = np.load(os.path.join(out, "cp2_result.npz"))
    v_rel = rel_err(torch.from_numpy(res["video"].astype(np.float32)),
                    torch.from_numpy(ckpt["video"].astype(np.float32)))
    a_rel = rel_err(torch.from_numpy(res["audio"]), torch.from_numpy(ckpt["audio"]))
    if max(blocks) > SP_BLOCKS_REL_TOL or max(v_rel, a_rel) > SP_CLI_REL_TOL:
        raise AssertionError(f"cp 2 off cp 1: blocks {blocks}, video {v_rel:.3e}, audio "
                             f"{a_rel:.3e}")
    res = np.load(os.path.join(out, "fsdp2_result.npz"))
    shares = [x["fsdp2"]["block_bytes"] / x["cp2"]["block_bytes"] for x in reps]
    log("[sp] (fsdp2) each rank's share of the block weights: "
        + ", ".join(f"{x:.4f}" for x in shares))
    if not (np.array_equal(res["video"], ckpt["video"])
            and np.array_equal(res["audio"], ckpt["audio"])) or max(shares) > SP_SHARE_MAX:
        raise AssertionError(f"fsdp 2: not bit-equal to phase 17's request, or shares {shares}")
    return launches


# phase 25: training under a mesh, two processes on the one card (gloo), from phase 17's
# checkpoint on phase 19's clips: the 360p recipe (`configs/training/lora_360p.py`,
# 352x640x49: 11,440 video and 103 audio tokens) at the depth cut, 2 steps (experts 0, 1;
# lr 1e-3 after the warmup's 0), against the same run in one process. Per micro-step and
# rank, under autograd every B1 launch computes its LSE (the autograd op saves it for the
# backward), and each forward launch has one backward (B2, fused at these lengths) and one
# delta preprocess; remat runs the forward twice. One process, and each rank at fsdp 2 (the
# whole sequence): 2 shared layers x 3 (video self, video text cross, a2v) + 1 tail layer x 2
# = 8 calls; the audio side's 103 queries take plain attention. At cp 2 (5,720 video and 52
# audio tokens a rank): the video self ring's 2 steps in each of the 3 video layers, the text
# cross in each, a2v (5,720 x 104) in each shared layer = 11 calls, the ring's with a nonzero
# LSE cotangent; the v2a combine's 104 whole-audio queries fall under the ring inner's
# Sq >= 128 gate and take the plain inner, as JAX's do.
MESH_STEPS = 2
MESH_CALLS = {"one": 2 * 3 + 1 * 2, "cp2": 3 * 2 + 3 + 2, "fsdp2": 2 * 3 + 1 * 2,
              "fullft": 2 * 3 + 1 * 2}
MESH_SETS = ["data.num_workers=1", f"trainer.max_steps={MESH_STEPS}", "trainer.lr=1e-3",
             "trainer.warmup_steps=1", "trainer.logger=jsonl", "trainer.log_interval=1",
             "trainer.save_interval=1000"]
# full fine-tuning of one video expert and the bridge (the sharded video blocks and
# conditioners train), AdamW at lr 1e-4: both ranks' peaks fit the card together
MESH_FT_SETS = ["trainer.mode=full", "trainer.trainable_modules=['video_dit','bridge']",
                "trainer.lr=1e-4", "trainer.lr_schedule=constant"]
MESH_RUNS = (("cp2", ["mesh.fsdp=1", "mesh.cp=2"]), ("fsdp2", ["mesh.fsdp=2", "mesh.cp=1"]),
             ("fullft", ["mesh.fsdp=2", "mesh.cp=1"] + MESH_FT_SETS))
MESH_LOSS_REL_TOL = 1e-2            # cp 2 against one process: bf16 compute, other sums
MESH_NORM_REL_TOL = 2e-2
MESH_LORA_REL_TOL = 2e-2
MESH_FT_REL_TOL = 1e-4              # full FT's trained weights, relative L2
MESH_TIMEOUT_S = 600


def _mesh_argv(ckpt: str, meta: str, save_dir: str, sets, extra) -> list:
    return [LORA_360P_RECIPE, "--set", f"pipeline.ckpt_path={ckpt}",
            f"data.metadata_path={meta}", f"trainer.save_dir={save_dir}"] + sets + extra


def _mesh_train(argv, snapshot):
    """`cli.train.run(argv)` with each micro-step's record kept (the trainer's
    `on_micro_step`), B1's launches with and without the LSE counted, the
    peak read, and `snapshot(trainer, step)` called after each optimizer
    step (its seconds taken out of `optimizer_s`). Returns (trainer,
    records)."""
    import torch

    from dualforce_tpu_torch.cli import train as train_cli
    from dualforce_tpu_torch.engine import trainer as trainer_mod
    from dualforce_tpu_torch.ops import flash_attention as fa

    records, snap_s = [], [0.0]
    launch = fa._launch_fwd
    counts, counting = _sp_count_launches(fa)

    def train(real):
        def run(self, data, on_micro_step=None):
            def record(r):
                torch.cuda.synchronize()
                r.update(lse=counts["lse"], nolse=counts["nolse"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         optimizer_s=r["optimizer_s"] - snap_s[0])
                counts.update(lse=0, nolse=0)
                records.append(r)
            counts.update(lse=0, nolse=0)
            return real(self, data, record)
        return run

    def apply(real):
        def run(self, grads, frozen=None):
            out = real(self, grads, frozen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snapshot(self, self.global_step + 1)    # its seconds leave optimizer_s
            torch.cuda.synchronize()
            snap_s[0] = time.perf_counter() - t0
            return out
        return run

    restores = [_patch(trainer_mod.LoRATrainer, "train", train),
                _patch(trainer_mod.LoRATrainer, "_apply", apply)]
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = train_cli.run(argv, tokenizer=ByteTokenizer())
    finally:
        for restore in restores:
            restore()
        fa._launch_fwd = launch
        counting["on"] = False
    return trainer, records


def _lora_snapshot(store):
    def snap(trainer, step):
        store[step] = {f"{m}.{n}.{p}": t.detach().float().cpu().clone()
                       for m in trainer.lora for n in trainer.lora[m]
                       for p, t in trainer.lora[m][n].items()}
    return snap


def _cached_loads():
    """`load_pipeline_params` served from this process's first load for the
    runs after it (the checkpoint is read once); returns the restore."""
    from dualforce_tpu_torch.convert import load_checkpoint as lc

    cache = {}

    def load(real):
        def run(*args, **kwargs):
            if "modules" not in cache:
                cache["modules"] = real(*args, **kwargs)
            return cache["modules"]
        return run

    restore = _patch(lc, "load_pipeline_params", load)

    def done():
        restore()
        cache.clear()
    return done


def _cached_encodes():
    """`LoRATrainer._encode` served from this process's first encode of the
    same batch (the runs read the same clips in the same order; the key
    holds the caption ids and the clip's sum); returns the restore."""
    from dualforce_tpu_torch.engine import trainer as trainer_mod

    cache = {}

    def encode(real):
        def run(self, batch):
            key = (batch["text_ids"].tobytes(), float(batch["video"].sum()))
            if key not in cache:
                cache[key] = real(self, batch)
            return cache[key]
        return run

    restore = _patch(trainer_mod.LoRATrainer, "_encode", encode)

    def done():
        restore()
        cache.clear()
    return done


def _force_split(on: bool):
    """Route every backward to the split pair (B3: a deterministic dq pass)
    while `on`; returns the restore."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    real = fa.bwd_takes_split
    if on:
        fa.bwd_takes_split = lambda sq, d=HEAD_DIM: True
    return lambda: setattr(fa, "bwd_takes_split", real)


def _mesh_rel(a: dict, b: dict) -> float:
    """Relative L2 of the concatenated tensors of a against b (same keys)."""
    import torch

    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return math.sqrt(num / max(den, 1e-300))


def _ft_snapshot(out: str, store=None):
    """After each step: the trained modules' weights to the host, saved
    (one process) or held against the one-process run's (a rank: its
    shard's squared gaps and norms, summed over the world; an unsharded
    tensor counted by rank 0 alone)."""
    import torch

    def snap(trainer, step):
        import torch.distributed as dist

        from dualforce_tpu_torch.convert import load_checkpoint as lc
        from dualforce_tpu_torch.parallel import mesh as pm

        named = [(f"{m}.{n}", p, s) for (m, n, p), s in zip(
            [(m, n, p) for m in sorted(trainer.trainable)
             for n, p in trainer.trainable[m].named_parameters()], trainer.shards)]
        path = os.path.join(out, f"ref_ft_step{step}.safetensors")
        if store is None:
            lc.save_state_dict({k: p.detach() for k, p, _ in named}, path)
            return
        ref = lc.read_safetensors(path)[0]
        sums = torch.zeros(4, dtype=torch.float64)
        for k, p, shard in named:
            want = ref[k]
            if shard is not None:
                n = want.shape[shard.dim] // pm.axis_size(shard.axis)
                want = want.narrow(shard.dim, pm.axis_index(shard.axis) * n, n)
            elif pm.rank():
                continue
            got, want = p.detach().float(), want.to(p.device).float()
            module = 0 if k.startswith("video_dit.") else 2
            sums[module] += float((got - want).double().square().sum())
            sums[module + 1] += float(want.double().square().sum())
        dist.all_reduce(sums)
        store[step] = {"video_dit": math.sqrt(sums[0] / sums[1]),
                       "bridge": math.sqrt(sums[2] / sums[3])}
    return snap


def _mesh_train_runs(out: str, ckpt: str, meta: str, sets, runs, rank: int) -> dict:
    """Phase 25's `MESH_RUNS` of `runs` in one rank of the world, through
    `cli.train.run` (fsdp 2 with every backward routed to the deterministic
    split pair, as its one-process references run): each micro-step's
    record and launches, the LoRA after each step (each rank writes its
    own), full fine-tuning's weights held against the one-process run's
    after each step, its shards' share, and rank 0's export read back: each
    rank holds its shards against the export's slices of them."""
    import gc

    import torch
    import torch.distributed as dist

    from dualforce_tpu_torch.convert import load_checkpoint as lc
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel import sharding

    reports = {}
    for name, extra in MESH_RUNS:
        if name not in runs:
            continue
        save_dir = os.path.join(out, f"{name}_ckpt")
        loras, ft = {}, {}
        snap = _ft_snapshot(out, ft) if name == "fullft" else _lora_snapshot(loras)
        restore = _force_split(name != "cp2")
        pm.TRANSFER.update(bytes=0, seconds=0.0, calls=0)
        t0 = time.perf_counter()
        try:
            trainer, records = _mesh_train(_mesh_argv(ckpt, meta, save_dir, sets, extra), snap)
        finally:
            restore()
        rep = reports[f"train_{name}"] = {
            "run_s": time.perf_counter() - t0, "steps": records,
            "transfer": dict(pm.TRANSFER), "ft_rel": ft,
            "block_bytes": sharding.block_bytes(trainer.modules)}
        if loras:
            torch.save(loras, os.path.join(out, f"{name}_lora.rank{rank}.pt"))
        if name == "fullft":
            step_dir = os.path.join(save_dir, f"step-{MESH_STEPS}")
            equal, halves = True, []
            for mod in sorted(trainer.trainable):
                module = trainer.trainable[mod]
                holder = getattr(module, "blocks", module)
                prefix = "blocks." if holder is not module else ""
                dims = getattr(holder, "fsdp_dims", {})
                back = lc.load_state_dict(os.path.join(step_dir, lc.MODULES[mod][0]))
                for n, p in module.named_parameters():
                    d = dims.get(n[len(prefix):]) if n.startswith(prefix) else None
                    want = back[n]
                    if d is not None:
                        size = want.shape[d] // 2
                        halves.append(p.shape[d] == size)
                        want = want.narrow(d, pm.axis_index(holder.fsdp_axis) * size, size)
                    elif rank:
                        continue
                    equal &= torch.equal(p, want.to(p.device))
            flag = torch.tensor([float(equal)])
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            rep.update(export_equal=bool(flag.item()), halves=[all(halves), len(halves)],
                       files=sorted(os.listdir(step_dir)))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return reports


def mesh_worker(argv) -> int:
    """`chip_smoke.py --mesh-worker OUT CKPT META SETS... -- CLI-ARGS...`,
    one rank under torchrun, the world of phases 24 and 25: the SP
    primitives, then with the checkpoint read once (and each training
    batch encoded once) phase 24's request at cp 2, phase 25's LoRA at cp 2,
    phase 24's request at fsdp 2 (which shards the modules in place), phase
    25's LoRA and full fine-tuning at fsdp 2 (last: it trains the weights).
    SETS: `MESH_SETS` as the caller has them; CLI-ARGS: phase 17's request."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch

    from dualforce_tpu_torch.parallel import mesh as pm

    out, ckpt, meta = argv[:3]
    cut = argv.index("--")
    sets, cli_args = argv[3:cut], argv[cut + 1:]
    pm.initialize_distributed("cuda")
    rank = pm.rank()
    reports = {"backend": torch.distributed.get_backend(), "primitives": _sp_primitives(out)}
    torch.cuda.empty_cache()
    restores = [_cached_loads(), _cached_encodes()]
    try:
        reports.update(_sp_serve(out, cli_args, ["cp2"]))
        reports.update(_mesh_train_runs(out, ckpt, meta, sets, ["cp2"], rank))
        reports.update(_sp_serve(out, cli_args, ["fsdp2"]))
        reports.update(_mesh_train_runs(out, ckpt, meta, sets, ["fsdp2", "fullft"], rank))
    finally:
        for restore in restores:
            restore()
        pm.leave()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(reports, f)
    return 0


def _mesh_world(out: str, ckpt: dict, meta: str):
    """Run `chip_smoke.py --mesh-worker ...` under torchrun in a world of two
    processes on the card; returns each rank's report."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = os.path.abspath(__file__)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(port), script,
           "--mesh-worker", out, ckpt["ckpt"], meta] + MESH_SETS + [
               "--", "--ckpt_path", ckpt["ckpt"]] + ckpt["request"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MESH_TIMEOUT_S,
                          cwd=os.path.dirname(script))
    for line in proc.stdout.splitlines():
        if line.startswith(("[dist]", "[info]", "[timer]", "[trainer]", "[done]")):
            log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the two-process world failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    reports = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    log(f"[mesh] the world of two (phases 24 and 25): {time.perf_counter() - t0:.1f} s with "
        "start-up")
    return reports


def _mesh_step_line(tag: str, st: dict) -> str:
    return (f"expert {st['expert']} loss {st['loss']:.6f} grad_norm {st['grad_norm']:.6f}; "
            f"encode {st['encode_s']:.3f} s, loss+backward {st['loss_backward_s']:.3f} s, "
            f"optimizer {st['optimizer_s']:.3f} s; collectives forward "
            f"{st.get('collective_fwd_bytes', 0) / 1e6:.1f} MB in "
            f"{st.get('collective_fwd_s', 0):.3f} s, backward and reduction "
            f"{st.get('collective_bwd_bytes', 0) / 1e6:.1f} MB in "
            f"{st.get('collective_bwd_s', 0):.3f} s; B1 launches {st['lse']} with the LSE, "
            f"{st['nolse']} without, B2 {st['flash_bwd']} fused / {st['flash_bwd_split']} "
            f"split, preprocess {st['flash_bwd_preprocess']}; peak {st['peak_gib']:.2f} GiB; "
            f"{tag}")


def _mesh_totals(records) -> dict:
    return {k: sum(st[k] for st in records)
            for k in ("flash_fwd", "flash_bwd", "flash_bwd_split", "flash_bwd_preprocess")}


def _check_mesh_launches(name: str, records, split: bool = False) -> None:
    calls = MESH_CALLS[name]
    want = {"lse": 2 * calls, "nolse": 0, "flash_bwd": 0 if split else calls,
            "flash_bwd_split": calls if split else 0, "flash_bwd_preprocess": calls}
    for i, st in enumerate(records):
        got = {k: st[k] for k in want}
        if got != want or st["flash_fwd"] != 2 * calls:
            raise AssertionError(f"{name} micro-step {i + 1}: launches {got} (counter "
                                 f"{st['flash_fwd']}), expected {want}")


def phase_mesh(first, ckpt: dict, root: str, smi: str):
    """Phases 24 and 25 in one world of two processes on the card (gloo:
    NCCL refuses two ranks on one card; its collectives take the CUDA
    tensors, its send/recv page-locked host copies), started once, the
    checkpoint read once in each rank: phase 24, serving under a mesh (the
    SP primitives at the path's shapes, phase 17's base request through the
    CLI at `--cp_size 2` and `--fsdp_size 2`); phase 25, training under a
    mesh (`cli.train` under torchrun with the 360p recipe from phase 17's
    checkpoint on phase 19's clips: LoRA at cp 2 and at fsdp 2, full
    fine-tuning at fsdp 2), each against the same run in one process here,
    run first. Returns (phase 24's launches, phase 25's)."""
    import gc
    import shutil

    import numpy as np
    import torch

    tag = f"card: {smi}"
    out = os.path.join(root, "mesh")
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "first_frame.npy"), first["image"])
    meta = os.path.join(root, "clips", "metadata.json")
    if not os.path.isfile(meta):
        meta = _write_clips(os.path.join(root, "clips"))

    # (0) the one-process references, the checkpoint read and each batch encoded once,
    # every backward on the split pair (B3: its dq pass is deterministic, where B2 adds
    # dQ's tiles in an order that varies between runs), no checkpoint written
    ref, ref_records, ref_launches = {}, {}, {}
    restores = [_cached_loads(), _cached_encodes(), _force_split(True),
                _patch(__import__("dualforce_tpu_torch.engine.trainer",
                                  fromlist=["LoRATrainer"]).LoRATrainer, "save",
                       lambda real: lambda self: None)]
    try:
        for name, extra in (("one", ["mesh={}"]), ("one_ft", ["mesh={}"] + MESH_FT_SETS)):
            store = {}
            snap = _ft_snapshot(out) if name == "one_ft" else _lora_snapshot(store)
            t0 = time.perf_counter()
            trainer, records = _mesh_train(
                _mesh_argv(ckpt["ckpt"], meta, os.path.join(out, f"{name}_ckpt"), MESH_SETS,
                           extra), snap)
            wall = time.perf_counter() - t0
            for i, st in enumerate(records):
                log(f"[mesh] ({name}) one process, step {i + 1}: " + _mesh_step_line(tag, st))
            _check_mesh_launches("one", records, split=True)
            log(f"[mesh] ({name}) one process: {wall:.2f} s (load once, clips, 2 steps)")
            ref[name], ref_records[name] = store, records
            ref_launches[name] = _mesh_totals(records)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for restore in reversed(restores):
            restore()
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[mesh] this process before the world: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    reps = _mesh_world(out, ckpt, meta)
    sp = _check_sp(reps, ckpt, out)
    launches = {}
    for name, _ in MESH_RUNS:
        for r, rep in enumerate(x[f"train_{name}"] for x in reps):
            for i, st in enumerate(rep["steps"]):
                log(f"[mesh] ({name}) rank {r}, step {i + 1}: " + _mesh_step_line(tag, st))
            log(f"[mesh] ({name}) rank {r}: run (clips, 2 steps, save) "
                f"{rep['run_s']:.2f} s; sent {rep['transfer']['bytes'] / 1e9:.3f} GB in "
                f"{rep['transfer']['seconds']:.2f} s over {rep['transfer']['calls']} calls; "
                f"block weights {rep['block_bytes'] / 1e9:.3f} GB; {tag}")
            _check_mesh_launches(name, rep["steps"], split=name != "cp2")
        launches[name] = _mesh_totals([st for x in reps for st in x[f"train_{name}"]["steps"]])
    loras = {name: [torch.load(os.path.join(out, f"{name}_lora.rank{r}.pt"))
                    for r in range(2)] for name in ("cp2", "fsdp2")}
    for name in loras:
        if any(not torch.equal(a[k], b[k]) for a, b in zip(*[
                [lo[s] for s in sorted(lo)] for lo in loras[name]]) for k in a):
            raise AssertionError(f"{name}: the two ranks' LoRAs differ")

    # (a) cp 2 LoRA (B2 with the ring's LSE cotangent) against one process (the split pair)
    one, cp = ref_records["one"], reps[0]["train_cp2"]["steps"]
    for i, (a, b) in enumerate(zip(one, cp)):
        loss_rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
        norm_rel = abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
        got, want = loras["cp2"][0][i + 1], ref["one"][i + 1]
        per_module = {m: _mesh_rel({k: v for k, v in got.items() if k.startswith(m + ".")},
                                   {k: v for k, v in want.items() if k.startswith(m + ".")})
                      for m in ("video_dit", "video_dit_2", "audio_dit", "bridge")}
        b_rel = _mesh_rel({k: v for k, v in got.items() if k.endswith(".b")},
                          {k: v for k, v in want.items() if k.endswith(".b")})
        log(f"[mesh] (a) cp 2 against one process, step {i + 1}: loss rel {loss_rel:.3e} "
            f"(limit {MESH_LOSS_REL_TOL}), grad norm rel {norm_rel:.3e} (limit "
            f"{MESH_NORM_REL_TOL}), LoRA factors rel L2 per module " + ", ".join(
                f"{m} {v:.3e}" for m, v in per_module.items())
            + f" (limit {MESH_LORA_REL_TOL}; the b factors alone {b_rel:.3e}); {tag}")
        finite = all(torch.isfinite(t).all() for t in got.values())
        if (loss_rel > MESH_LOSS_REL_TOL or norm_rel > MESH_NORM_REL_TOL
                or max(per_module.values()) > MESH_LORA_REL_TOL or not finite):
            raise AssertionError(f"cp 2 step {i + 1} off one process: loss {loss_rel:.3e}, "
                                 f"norm {norm_rel:.3e}, LoRA {per_module}, finite {finite}")
    last = loras["cp2"][0][MESH_STEPS]
    # step 1 (expert 0) ran at the warmup's lr 0; step 2 moves every factor, expert 0's
    # by the first moment step 1 left
    moved = {m: all(bool(t.any()) for k, t in last.items()
                    if k.startswith(m + ".") and k.endswith(".b"))
             for m in ("video_dit", "video_dit_2", "audio_dit", "bridge")}
    if not all(moved.values()):
        raise AssertionError(f"cp 2: a LoRA b is still zero after step 2: {moved}")

    # (b) fsdp 2 LoRA, every backward on the split pair, bit-equal to the same in one process
    for i, (a, b) in enumerate(zip(ref_records["one"], reps[0]["train_fsdp2"]["steps"])):
        same = all(torch.equal(loras["fsdp2"][0][i + 1][k], v)
                   for k, v in ref["one"][i + 1].items())
        log(f"[mesh] (b) fsdp 2 against one process (both on the split backward), step "
            f"{i + 1}: loss {b['loss']:.9g} / {a['loss']:.9g}, grad norm {b['grad_norm']:.9g} "
            f"/ {a['grad_norm']:.9g}, LoRA bit-equal {same}; {tag}")
        if b["loss"] != a["loss"] or not same:
            raise AssertionError(f"fsdp 2 step {i + 1}: not bit-equal to one process")
    shares = [x["train_fsdp2"]["block_bytes"] / x["train_cp2"]["block_bytes"] for x in reps]
    log("[mesh] (b) each rank's share of the block weights under fsdp 2: "
        + ", ".join(f"{x:.4f}" for x in shares))
    if max(shares) > SP_SHARE_MAX:
        raise AssertionError(f"fsdp 2 shares {shares}")

    # (c) fsdp 2 full fine-tuning
    ft = [x["train_fullft"] for x in reps]
    first = (ft[0]["steps"][0]["loss"], ref_records["one_ft"][0]["loss"])
    log(f"[mesh] (c) fsdp 2 full fine-tuning of video_dit and the bridge: step 1 loss "
        f"{first[0]:.9g} / one process {first[1]:.9g}; trained weights rel L2 per step "
        + "; ".join(f"{k}: " + ", ".join(f"{m} {v:.3e}" for m, v in rel.items())
                    for k, rel in sorted(ft[0]["ft_rel"].items()))
        + f" (limit {MESH_FT_REL_TOL}); sharded tensors halved on each rank "
        f"{[x['halves'] for x in ft]}; rank 0's step-{MESH_STEPS}/ export read back equal "
        f"{ft[0]['export_equal']}: {ft[0]['files']}; {tag}")
    worst = max(v for rel in ft[0]["ft_rel"].values() for v in rel.values())
    if (first[0] != first[1] or worst > MESH_FT_REL_TOL or not ft[0]["export_equal"]
            or not all(x["halves"][0] and x["halves"][1] > 0 for x in ft)
            or "state.rank1.pt" not in ft[0]["files"]):
        raise AssertionError(f"full FT under fsdp 2: loss {first}, weights {worst:.3e}, "
                             f"export {ft[0]['export_equal']}, halves "
                             f"{[x['halves'] for x in ft]}, files {ft[0]['files']}")
    shutil.rmtree(out, ignore_errors=True)
    return sp, {**{f"reference_{k}": v for k, v in ref_launches.items()}, **launches}


START = time.perf_counter()


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
        group_cli = timed_phase("groupcli", phase_group_cli, first, ckpt, ckpt_root)
        gc.collect()
        torch.cuda.empty_cache()
        timed_phase("model", phase_model_code, ckpt["audio_latents"])
        gc.collect()
        torch.cuda.empty_cache()
        lowres = timed_phase("lowres", phase_train_low_resource, root)
        gc.collect()
        torch.cuda.empty_cache()
        train_cli = timed_phase("traincli", phase_train_cli, first, ckpt["ckpt"], ckpt_root)
        gc.collect()
        torch.cuda.empty_cache()
        serve_http = timed_phase("serve", phase_serve_http, ckpt["ckpt"], ckpt_root)
        gc.collect()
        torch.cuda.empty_cache()
        full_ft = timed_phase("fullft", phase_full_ft, first, ckpt["ckpt"], ckpt_root, smi)
        gc.collect()
        torch.cuda.empty_cache()
        sp, mesh = timed_phase("mesh", phase_mesh, first, ckpt, ckpt_root, smi)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    lr_l, cli_l = lowres["launches"], train_cli["launches"]
    ft_l, ft_save_l = full_ft["launches"], full_ft["launches_save"]

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
                     + full["group_launches"] + full["small_launches"]
                     + fp8["launches"] + options["cfg_batch"] + options["unbatched"]
                     + options["cfg_cache_interval_2"] + ckpt["launches"]
                     + sum(group_cli.values()) + lr_l["fwd"]
                     + cli_l["fwd"] + train_cli["serve"] + serve_http["launches"]
                     + ft_l["fwd"] + ft_save_l["fwd"] + sp["cp2"] + sp["fsdp2"]
                     + sum(m["flash_fwd"] for m in mesh.values())),
        "launches_by_path": {"serve": serve_launches, "train": train["fwd"],
                             "serve_sage_int8": prec["sage"]["exact"],
                             "serve_fast_int4": prec["fast"]["exact"],
                             "train_720p": train720["fwd"],
                             "serve_full_depth_staged": full["launches"],
                             "serve_full_depth_group": full["group_launches"],
                             "serve_full_depth_group_resident_small":
                             full["small_launches"],
                             "serve_full_depth_fp8": fp8["launches"],
                             "serve_cfg_batch_mask_ctx_pad": options["cfg_batch"],
                             "serve_mask_ctx_pad": options["unbatched"],
                             "serve_cfg_cache_interval_2": options["cfg_cache_interval_2"],
                             "serve_cli_checkpoint": ckpt["launches"], **group_cli,
                             "train_low_resource_full_depth": lr_l["fwd"],
                             "train_cli": cli_l["fwd"], "serve_cli_trained_lora":
                             train_cli["serve"], "serve_http": serve_http["launches"],
                             "train_full_ft": ft_l["fwd"],
                             "train_full_ft_remat_save": ft_save_l["fwd"],
                             "serve_cp2": sp["cp2"], "serve_fsdp2": sp["fsdp2"],
                             **{f"train_mesh_{k}": m["flash_fwd"] for k, m in mesh.items()}},
        "full_depth_staged_peak_gib": full["peak_gib"],
        "full_depth_group_peaks_gib": full["group_peaks_gib"],
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
        "launches": (train["bwd"] + train720["bwd"] + lr_l["bwd"] + cli_l["bwd"]
                     + ft_l["bwd"] + ft_save_l["bwd"]
                     + sum(m["flash_bwd"] for m in mesh.values())),
        "launches_by_path": {"serve": 0, "train": train["bwd"], "train_720p": train720["bwd"],
                             "train_low_resource_full_depth": lr_l["bwd"],
                             "train_cli": cli_l["bwd"], "train_full_ft": ft_l["bwd"],
                             "train_full_ft_remat_save": ft_save_l["bwd"],
                             **{f"train_mesh_{k}": m["flash_bwd"] for k, m in mesh.items()}},
        "train_low_resource_peak_gib": lowres["peak_gib"],
        "train_full_ft_peak_gib": full_ft["peak_gib"],
        "train_full_ft_remat_save_peak_gib": full_ft["peak_save_gib"],
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
        "launches": (train720["split"] + lr_l["split"] + cli_l["split"]
                     + ft_l["bwd_split"] + ft_save_l["bwd_split"]
                     + sum(m["flash_bwd_split"] for m in mesh.values())),
        "launches_by_path": {"serve": 0, "train": train["split"],
                             "train_720p": train720["split"],
                             "train_low_resource_full_depth": lr_l["split"],
                             "train_cli": cli_l["split"],
                             "train_full_ft": ft_l["bwd_split"],
                             "train_full_ft_remat_save": ft_save_l["bwd_split"],
                             **{f"train_mesh_{k}": m["flash_bwd_split"]
                                for k, m in mesh.items()}},
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
        "launches": (train["prep"] + train720["prep"] + lr_l["prep"] + cli_l["prep"]
                     + ft_l["bwd_preprocess"] + ft_save_l["bwd_preprocess"]
                     + sum(m["flash_bwd_preprocess"] for m in mesh.values())),
        "launches_by_path": {"serve": 0, "train": train["prep"],
                             "train_720p": train720["prep"],
                             "train_low_resource_full_depth": lr_l["prep"],
                             "train_cli": cli_l["prep"],
                             "train_full_ft": ft_l["bwd_preprocess"],
                             "train_full_ft_remat_save": ft_save_l["bwd_preprocess"],
                             **{f"train_mesh_{k}": m["flash_bwd_preprocess"]
                                for k, m in mesh.items()}},
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
    log("[summary] phase seconds: " + ", ".join(f"{n} {t:.1f}"
                                                for n, t in PHASE_SECONDS.items())
        + f"; phases {sum(PHASE_SECONDS.values()):.1f} s, script "
        f"{time.perf_counter() - START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2:]))
    sys.exit(main())
