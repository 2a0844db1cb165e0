"""Evaluate a generated clip (mp4 / .avi / .npz shard / frame dir) — objective
metrics JSON to stdout (counterpart of `scripts/eval.py`, flag for flag).

Counterpart of the reference's out-of-repo eval suite (SURVEY.md §4 item 4 /
the audited scripts/eval directory): fidelity vs a reference clip or first
frame, temporal profile, audio stats, and a DeSync-style AV-sync proxy.

Usage:
  python -m dualforce_tpu_torch.cli.eval out.avi [--reference ref.mp4]
      [--first_frame f.png] [--prompt "..."] [--clip_model /path/to/clip]

The metrics are numpy on the host; each model-based hook runs its local
checkpoint on the CPU, and only when that checkpoint is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def _ffprobe_fps(path: str) -> float:
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=r_frame_rate", "-of", "csv=p=0", path],
            capture_output=True, text=True, check=True).stdout.strip()
        num, den = out.split("/")
        return float(num) / float(den)
    except Exception:
        return 24.0


def load_clip(path: str, sample_rate: int = 48000):
    """Returns (video [T,H,W,3] uint8, audio [S] float32 or None, sr, fps)."""
    if path.endswith(".npz"):
        d = np.load(path)
        return (d["video"], d["audio"].astype(np.float32) if "audio" in d else None,
                int(d["sr"]) if "sr" in d else sample_rate,
                float(d["fps"]) if "fps" in d else 24.0)
    if path.endswith(".avi"):
        from dualforce_tpu_torch.utils.av_io import read_mjpeg_avi

        return read_mjpeg_avi(path)
    if os.path.isdir(path):
        from PIL import Image

        from dualforce_tpu_torch.data.dataset import load_wav

        frames = [np.asarray(Image.open(os.path.join(path, f)).convert("RGB"))
                  for f in sorted(os.listdir(path))
                  if f.lower().endswith((".jpg", ".jpeg", ".png"))]
        wav = os.path.join(path, "audio.wav")
        audio = load_wav(wav, sample_rate) if os.path.exists(wav) else None
        return np.stack(frames), audio, sample_rate, 24.0
    # mp4 via ffmpeg rawvideo/f32le pipes
    fps = _ffprobe_fps(path)
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True).stdout.strip()
    w, h = (int(x) for x in probe.split(","))
    raw = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-"], capture_output=True, check=True).stdout
    video = np.frombuffer(raw, np.uint8).reshape(-1, h, w, 3)
    try:
        araw = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le", "-ac", "1",
             "-ar", str(sample_rate), "-"], capture_output=True, check=True).stdout
        audio = np.frombuffer(araw, np.float32)
    except subprocess.CalledProcessError:
        audio = None
    return video, audio, sample_rate, fps


_CLIP_EXTS = (".mp4", ".avi", ".npz")


def _find_clips(directory: str):
    out = []
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if name.lower().endswith(_CLIP_EXTS):
            if name.lower().endswith(".npz"):
                # state checkpoints / caches are also .npz — only shards
                # with a `video` array are clips
                try:
                    with np.load(p) as z:
                        if "video" not in z.files:
                            continue
                except Exception:  # noqa: BLE001 — unreadable: not a clip
                    continue
            out.append(p)
        elif os.path.isdir(p) and any(
                f.lower().endswith((".jpg", ".jpeg", ".png"))
                for f in os.listdir(p)):
            out.append(p)
    return out


def _fmt(x, arrow=""):
    return "N/A" if x is None else f"{x:.3f}"


def batch_table(rows):
    """Verse-Bench-shaped markdown table (BASELINE.md quality schema):
    | Model | IS^ | DNSMOS^ | DeSync_v | IB-Score^ | LSE-D_v | LSE-C^ | cpCER_v |
    Model-based columns are N/A without their local checkpoints (the
    reference runs these out-of-repo; desync here is the onset-correlation
    proxy lag in seconds when SyncNet is absent)."""
    hdr = ("| Model | IS↑ | DNSMOS↑ | DeSync↓ | IB-Score↑ | LSE-D↓ | "
           "LSE-C↑ | cpCER↓ |")
    sep = "|---|---|---|---|---|---|---|---|"
    lines = [hdr, sep]
    for name, agg in rows:
        lines.append(
            f"| {name} | {_fmt(agg.get('inception_score'))} | "
            f"{_fmt(agg.get('dnsmos_ovrl'))} | {_fmt(agg.get('desync'))} | "
            f"{_fmt(agg.get('ib_score'))} | {_fmt(agg.get('lse_d'))} | "
            f"{_fmt(agg.get('lse_c'))} | {_fmt(agg.get('cpcer'))} |")
    return "\n".join(lines)


def aggregate_reports(reports):
    """Mean of the Verse-Bench-class scalars over per-clip reports; DeSync =
    SyncNet |offset| when available, else the AV-sync proxy |lag| seconds."""
    agg = {}
    for key in ("inception_score", "dnsmos_ovrl", "ib_score", "lse_d",
                "lse_c", "cpcer"):
        vals = [r[key] for r in reports if key in r]
        if vals:
            agg[key] = float(np.mean(vals))
    lags = [abs(r["av_sync"]["best_lag_ms"]) / 1000.0 for r in reports
            if "av_sync" in r]
    if lags:
        agg["desync"] = float(np.mean(lags))
    return agg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dualforce_tpu_torch.cli.eval",
                                 description="Objective metrics of generated clips.")
    ap.add_argument("clip", help="generated clip (.mp4/.avi/.npz/frame dir) "
                                 "or, with --batch, a directory of clips")
    ap.add_argument("--batch", action="store_true",
                    help="evaluate every clip in the directory and emit the "
                         "Verse-Bench-shaped table + aggregate JSON")
    ap.add_argument("--model_name", default=None,
                    help="row label for the batch table (default: dir name)")
    ap.add_argument("--reference", default=None,
                    help="ground-truth clip for PSNR/SSIM")
    ap.add_argument("--first_frame", default=None,
                    help="conditioning image: first-frame faithfulness")
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--prompts_json", default=None,
                    help="batch mode: JSON {clip_filename: prompt} for "
                         "CLIP/cpCER scoring")
    ap.add_argument("--clip_model", default=None,
                    help="local CLIP checkpoint dir for text-video similarity")
    ap.add_argument("--syncnet_model", default=None,
                    help="local TorchScript SyncNet for LSE-D/LSE-C "
                         "(contract: eval/metrics.py:lse_scores)")
    ap.add_argument("--dnsmos_model", default=None,
                    help="local TorchScript DNSMOS P.835 (SIG/BAK/OVRL)")
    ap.add_argument("--is_model", default=None,
                    help="local TorchScript classifier for Inception Score")
    ap.add_argument("--ib_model", default=None,
                    help="local TorchScript image+audio embedder for IB-Score")
    ap.add_argument("--asr_model", default=None,
                    help="local ASR checkpoint dir for cpCER vs the prompt")
    ap.add_argument("--out_json", default=None,
                    help="also write the (per-clip + aggregate) report here")
    ap.add_argument("--sample_rate", type=int, default=48000)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from dualforce_tpu_torch.eval.metrics import evaluate_clip

    hooks = dict(clip_model=args.clip_model, syncnet_model=args.syncnet_model,
                 dnsmos_model=args.dnsmos_model, is_model=args.is_model,
                 ib_model=args.ib_model, asr_model=args.asr_model)

    def eval_one(path, prompt, ref=None, ff=None):
        video, audio, sr, fps = load_clip(path, args.sample_rate)
        if audio is None:
            audio = np.zeros(int(sr * len(video) / fps), np.float32)
        return evaluate_clip(video, audio, sr, fps, reference_video=ref,
                             first_frame=ff, prompt=prompt, **hooks)

    if args.batch:
        prompts = {}
        if args.prompts_json:
            with open(args.prompts_json) as f:
                prompts = json.load(f)
        clips = _find_clips(args.clip)
        if not clips:
            raise SystemExit(f"no clips ({'/'.join(_CLIP_EXTS)} or frame "
                             f"dirs) found under {args.clip}")
        reports = {}
        for path in clips:
            name = os.path.basename(path)
            reports[name] = eval_one(path, prompts.get(name, args.prompt))
            print(f"[eval] {name}: done", file=sys.stderr)
        agg = aggregate_reports(list(reports.values()))
        label = args.model_name or os.path.basename(os.path.normpath(args.clip))
        print(batch_table([(label, agg)]))
        payload = {"aggregate": agg, "clips": reports, "model": label}
        if args.out_json:
            with open(args.out_json, "w") as f:
                json.dump(payload, f, indent=2)
        else:
            print(json.dumps(payload["aggregate"], indent=2))
        return

    ref = None
    if args.reference:
        ref = load_clip(args.reference, args.sample_rate)[0]
    ff = None
    if args.first_frame:
        from PIL import Image

        ff = np.asarray(Image.open(args.first_frame).convert("RGB"))
    report = eval_one(args.clip, args.prompt, ref=ref, ff=ff)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
