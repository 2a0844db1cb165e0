#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dualforce_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: every CUDA kernel of the port, from the sources in the checkout.
3. kernels: each kernel's wrapper at the main path's shapes, held against
   its plain PyTorch version on the same inputs (two heads per shape, bf16
   output against the fp32 plain version, relative L2 error <= 1e-2), plus
   a per-batch kv-length case whose length-0 row must be exactly 0; times of
   the kernel, its plain version, its bound on an H100 SXM and the one
   PyTorch call that computes the same function (a yardstick only: the port
   never calls it).
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

The line before the last is the card's name and power limit; the one
before that lists each kernel as JSON. The last line of standard output is
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
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
KERNEL_REL_TOL = 1e-2
STEP_REL_TOL = 2e-2
# per request: (2 shared layers x 6 attentions + 1 tail layer x 2) x 2 CFG passes x 4 steps
LAUNCHES_PER_REQUEST = (2 * 6 + 1 * 2) * 2 * 4


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


def attention_bound_ms(b: int, n: int, sq: int, sk_valid: int, sk: int):
    """Least time on an H100 SXM: bf16 q, k, v read once and o written once,
    against 4*Sq*Sk*D flops over the keys this input leaves valid."""
    flops = 4 * b * n * sq * sk_valid * HEAD_DIM
    nbytes = 2 * b * n * HEAD_DIM * (2 * sq + 2 * sk)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def phase_build():
    from dualforce_tpu_torch.ops import _build

    built = _build.build("flash_fwd")
    log(f"[build] flash_fwd: {built.path.name} nvcc {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from dualforce_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_plain)

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
        row = dict(shape=name, heads=n, sq=sq, sk=sk, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, rel_err=err, max_abs_err=mae)
        rows.append(row)
        log(f"[kernel] flash_fwd {name} N={n} Sq={sq} Sk={sk}: kernel_ms={kernel_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={library_ms:.4f} "
            f"plain_ms={plain_ms:.4f} (not a yardstick) rel_err={err:.3e} "
            f"max_abs_err={mae:.3e} host_us={host_us:.1f} "
            f"library_host_us={library_host_us:.1f}")
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


def phase_main_path():
    import dataclasses

    import numpy as np
    import torch

    from dualforce_tpu_torch.config import mova_360p
    from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
    from dualforce_tpu_torch.diffusion.pipeline import MOVAPipeline
    from dualforce_tpu_torch.diffusion.sampler import build_plan
    from dualforce_tpu_torch.models.factory import init_pipeline_params
    from dualforce_tpu_torch.ops.flash_attention import flash_attention

    base = mova_360p()
    cfg = dataclasses.replace(
        base,
        video_dit=dataclasses.replace(base.video_dit, num_layers=3),
        audio_dit=dataclasses.replace(base.audio_dit, num_layers=2),
        bridge=dataclasses.replace(base.bridge, visual_layers=3, audio_layers=2),
        text_encoder=dataclasses.replace(base.text_encoder, num_layers=2))
    request = dict(height=352, width=640, num_frames=193, video_fps=24.0,
                   num_inference_steps=4, sigma_shift=5.0, cfg_scale=5.0)
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
    expected_samples = int(48000 * request["num_frames"] / request["video_fps"])

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0            # the main path's count starts here
    per_request = []
    for prompt, seed in requests:
        image = rng.uniform(-1, 1, (352, 640, 3)).astype(np.float32)
        before = flash_attention.launches
        step_s.clear()
        res = pipe(prompt, image, negative_prompt=negative, seed=seed, **request)
        launched = flash_attention.launches - before
        per_request.append(launched)
        log(f"[main] request seed={seed}: prepare {marks['prepare']:.2f} s, denoise steps "
            f"{', '.join(f'{s:.2f}' for s in step_s)} s, decode {marks['decode']:.2f} s; "
            f"flash launches {launched}")
        if res.video.dtype != np.uint8 or res.video.shape != (193, 352, 640, 3):
            raise AssertionError(f"video {res.video.dtype} {res.video.shape}")
        if res.audio.shape != (expected_samples,) or not np.isfinite(res.audio).all():
            raise AssertionError(f"audio {res.audio.shape}, finite="
                                 f"{bool(np.isfinite(res.audio).all())}")
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
    return launches


def main() -> int:
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

    smi = phase_device()
    phase_build()
    rows, max_abs = phase_kernels()
    phase_small_step()
    launches = phase_main_path()

    video_self = rows[0]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dualforce_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dualforce_tpu/ops/flash_attention.py:132",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": video_self["kernel_ms"],
        "plain_ms": video_self["plain_ms"],
        "bound_ms": video_self["bound_ms"],
        "bound_by": video_self["bound_by"],
        "library_ms": video_self["library_ms"],
        "held_against_plain": True,
        "shape": "video_self: 40 heads, Sq = Sk = 43120, D 128; the other shapes are on the [kernel] lines",
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
