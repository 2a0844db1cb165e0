"""Objective evaluation metrics for generated video+audio clips (the port's
copy of `dualforce_tpu/eval/metrics.py`; tests hold the two equal).

The reference evaluates on Verse-Bench (IS/DNSMOS/DeSync/IB-Score/LSE-D/
LSE-C/cpCER, README.md §Evaluation) via an out-of-repo suite; its in-repo
`scripts/eval/` directory (FVD/FID/identity/sync/pose per the fork's audit,
cc_todo/20260223-review/01-code_research_review.md:24-27) is absent from the
snapshot. This module provides the dependency-free core that runs anywhere:

- fidelity: PSNR, SSIM (vs a reference clip or the conditioning first frame)
- temporal: inter-frame PSNR (flicker), motion energy profile
- audio: RMS/peak/silence/clipping stats
- AV sync: a DeSync-style proxy — normalized cross-correlation between the
  video motion-energy profile and the audio onset envelope, with the best
  alignment lag in milliseconds (0 = in sync).

Model-based scores (IS via a classifier, IB-Score via an image-audio
embedder, LSE via SyncNet) need external checkpoints; `clip_scores` hooks
them in when a local model path is supplied.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# fidelity
# ---------------------------------------------------------------------------

def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Separable 'valid' filtering along H and W of [H, W] float64."""
    pad = len(w) // 2
    out = np.apply_along_axis(lambda r: np.convolve(r, w, mode="valid"), 1, img)
    out = np.apply_along_axis(lambda c: np.convolve(c, w, mode="valid"), 0, out)
    del pad
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Single-scale SSIM (Wang et al. 2004), 11x11 gaussian window, on
    [H, W] or [H, W, C] images (channel-averaged)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[-1])]))
    w = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d_sep(a, w)
    mu_b = _filter2d_sep(b, w)
    aa = _filter2d_sep(a * a, w) - mu_a ** 2
    bb = _filter2d_sep(b * b, w) - mu_b ** 2
    ab = _filter2d_sep(a * b, w) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * ab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (aa + bb + c2))
    return float(np.mean(s))


def video_fidelity(video: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """Frame-wise mean PSNR/SSIM of two [T, H, W, 3] uint8 videos."""
    t = min(len(video), len(reference))
    return {
        "psnr": float(np.mean([psnr(video[i], reference[i]) for i in range(t)])),
        "ssim": float(np.mean([ssim(video[i], reference[i]) for i in range(t)])),
        "frames_compared": t,
    }


# ---------------------------------------------------------------------------
# temporal
# ---------------------------------------------------------------------------

def temporal_profile(video: np.ndarray) -> Dict[str, float]:
    """Inter-frame statistics of a [T, H, W, 3] uint8 video: adjacent-frame
    PSNR (very high = frozen, very low = flicker) and motion energy stats."""
    if len(video) < 2:
        return {"interframe_psnr": float("inf"), "motion_mean": 0.0,
                "motion_std": 0.0}
    diffs = video[1:].astype(np.float32) - video[:-1].astype(np.float32)
    energy = np.sqrt(np.mean(diffs ** 2, axis=(1, 2, 3)))  # [T-1]
    ifp = [psnr(video[i], video[i + 1]) for i in range(len(video) - 1)]
    finite = [p for p in ifp if np.isfinite(p)]
    return {
        "interframe_psnr": float(np.mean(finite)) if finite else float("inf"),
        "motion_mean": float(energy.mean()),
        "motion_std": float(energy.std()),
    }


def motion_energy(video: np.ndarray) -> np.ndarray:
    """Per-transition RMS frame difference, [T-1] float."""
    diffs = video[1:].astype(np.float32) - video[:-1].astype(np.float32)
    return np.sqrt(np.mean(diffs ** 2, axis=(1, 2, 3)))


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def audio_stats(audio: np.ndarray, silence_db: float = -60.0,
                frame: int = 1024) -> Dict[str, float]:
    """audio: [S] float in [-1, 1]."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    n = (len(audio) // frame) * frame
    if n == 0:
        return {"rms_db": -120.0, "peak": 0.0, "silence_fraction": 1.0,
                "clipping_fraction": 0.0}
    frames = audio[:n].reshape(-1, frame)
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    rms_db = 20 * np.log10(np.maximum(rms, 1e-9))
    return {
        "rms_db": float(20 * np.log10(max(np.sqrt(np.mean(audio ** 2)), 1e-9))),
        "peak": float(np.max(np.abs(audio))),
        "silence_fraction": float(np.mean(rms_db < silence_db)),
        "clipping_fraction": float(np.mean(np.abs(audio) > 0.999)),
    }


def audio_onset_envelope(audio: np.ndarray, sr: int, fps: float,
                         num_frames: int) -> np.ndarray:
    """Frame-aligned onset strength: positive first difference of per-frame
    RMS energy, [num_frames-1] float (aligned with motion_energy)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    hop = sr / fps
    rms = np.empty(num_frames, np.float32)
    for i in range(num_frames):
        lo, hi = int(i * hop), min(int((i + 1) * hop), len(audio))
        seg = audio[lo:hi]
        rms[i] = np.sqrt(np.mean(seg ** 2)) if len(seg) else 0.0
    onset = np.diff(rms)
    return np.maximum(onset, 0.0)


def av_sync(video: np.ndarray, audio: np.ndarray, sr: int, fps: float,
            max_lag_frames: int = 12) -> Dict[str, float]:
    """DeSync-style proxy: normalized cross-correlation between video motion
    energy and audio onset strength over alignment lags. Returns the
    correlation at zero lag, the best-correlation lag in frames and ms
    (positive = audio leads), and the best correlation."""
    me = motion_energy(video)
    oe = audio_onset_envelope(audio, sr, fps, len(video))
    t = min(len(me), len(oe))
    me, oe = me[:t], oe[:t]

    def ncc(x, y):
        x = x - x.mean()
        y = y - y.mean()
        d = np.linalg.norm(x) * np.linalg.norm(y)
        return float(np.dot(x, y) / d) if d > 0 else 0.0

    lags = range(-max_lag_frames, max_lag_frames + 1)
    corrs = {}
    for lag in lags:
        if lag >= 0:
            x, y = me[lag:], oe[:t - lag]
        else:
            x, y = me[:t + lag], oe[-lag:]
        if len(x) >= 4:
            corrs[lag] = ncc(x, y)
    if not corrs:
        return {"corr_zero_lag": 0.0, "best_lag_frames": 0,
                "best_lag_ms": 0.0, "best_corr": 0.0}
    best = max(corrs, key=lambda k: corrs[k])
    return {
        "corr_zero_lag": corrs.get(0, 0.0),
        "best_lag_frames": int(best),
        "best_lag_ms": float(best * 1000.0 / fps),
        "best_corr": corrs[best],
    }


# ---------------------------------------------------------------------------
# model-based hooks (optional external checkpoints)
# ---------------------------------------------------------------------------

def clip_scores(video: np.ndarray, prompt: str,
                model_path: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Text-video alignment via a LOCAL CLIP checkpoint (transformers).
    Returns None when no model is available (zero-egress images)."""
    if not model_path:
        return None
    try:
        import torch
        from transformers import CLIPModel, CLIPProcessor
    except ImportError:
        return None
    model = CLIPModel.from_pretrained(model_path)
    proc = CLIPProcessor.from_pretrained(model_path)
    idx = np.linspace(0, len(video) - 1, min(8, len(video))).astype(int)
    inputs = proc(text=[prompt], images=[video[i] for i in idx],
                  return_tensors="pt", padding=True)
    with torch.no_grad():
        out = model(**inputs)
        sims = torch.cosine_similarity(
            out.image_embeds, out.text_embeds.expand_as(out.image_embeds))
    return {"clip_text_sim": float(sims.mean())}


def _resample_linear(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear-interp resample (hook preprocessing; not mastering-grade)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if sr == target_sr or len(audio) == 0:
        return audio
    n_out = int(round(len(audio) * target_sr / sr))
    x_out = np.linspace(0.0, len(audio) - 1, n_out)
    return np.interp(x_out, np.arange(len(audio)), audio).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _load_torchscript(model_path: str):
    """Cached per path: a batch eval calls each model-based metric once per
    clip — reloading a GB-scale checkpoint N times would dominate the sweep."""
    try:
        import torch
    except ImportError:
        return None
    try:
        return torch.jit.load(model_path, map_location="cpu").eval()
    except Exception:
        return None


def lse_from_embeddings(vid_emb: np.ndarray, aud_emb: np.ndarray,
                        vshift: int = 15) -> Dict[str, float]:
    """LSE-D / LSE-C from aligned per-window embeddings [N, D] (the SyncNet
    scoring rule, Chung & Zisserman "Out of time"): for each video window,
    L2 distance to the audio windows within ±vshift; LSE-D = mean over
    windows of the minimum distance, LSE-C = mean of (mean - min) distance
    (confidence). Lower D / higher C = better sync."""
    n = min(len(vid_emb), len(aud_emb))
    vid, aud = np.asarray(vid_emb, np.float64)[:n], np.asarray(aud_emb, np.float64)[:n]
    mins, confs = [], []
    for i in range(n):
        lo, hi = max(0, i - vshift), min(n, i + vshift + 1)
        d = np.linalg.norm(aud[lo:hi] - vid[i][None, :], axis=1)
        mins.append(float(d.min()))
        confs.append(float(d.mean() - d.min()))
    return {"lse_d": float(np.mean(mins)), "lse_c": float(np.mean(confs))}


def lse_scores(video: np.ndarray, audio: np.ndarray, sr: int, fps: float,
               model_path: Optional[str] = None,
               vshift: int = 15) -> Optional[Dict[str, float]]:
    """SyncNet LSE-D/LSE-C via a LOCAL TorchScript checkpoint (zero-egress:
    returns None without one). Contract: `forward(video, audio) ->
    (vid_emb [N, D], aud_emb [N, D])` with video [T, 3, H, W] float in
    [0, 1] at the clip fps and audio [S] float32 at 16 kHz; the model owns
    face cropping / mel extraction and window alignment."""
    model = _load_torchscript(model_path) if model_path else None
    if model is None:
        return None
    import torch

    v = torch.from_numpy(
        np.ascontiguousarray(video.transpose(0, 3, 1, 2), np.float32) / 255.0)
    a = torch.from_numpy(_resample_linear(audio, sr, 16000))
    with torch.no_grad():
        vid_emb, aud_emb = model(v, a)
    return lse_from_embeddings(vid_emb.numpy(), aud_emb.numpy(), vshift)


def dnsmos_score(audio: np.ndarray, sr: int,
                 model_path: Optional[str] = None,
                 segment_s: float = 9.0) -> Optional[Dict[str, float]]:
    """DNSMOS P.835 via a LOCAL TorchScript checkpoint. Contract:
    `forward(audio [1, S] float32 @16 kHz) -> [..., 3]` = (SIG, BAK, OVRL).
    Scored over `segment_s` windows and averaged; OVRL is the headline
    (BASELINE.md quality table's DNSMOS column)."""
    model = _load_torchscript(model_path) if model_path else None
    if model is None:
        return None
    import torch

    a16 = _resample_linear(audio, sr, 16000)
    seg = int(16000 * segment_s)
    if len(a16) <= seg:
        segments = [a16]  # short audio: score the whole clip as one window
    else:
        segments = [a16[i:i + seg] for i in range(0, len(a16) - seg + 1, seg)]
    scores = []
    with torch.no_grad():
        for s in segments:
            out = model(torch.from_numpy(s[None, :]))
            scores.append(np.asarray(out).reshape(-1)[-3:])
    m = np.mean(scores, axis=0)
    return {"dnsmos_sig": float(m[0]), "dnsmos_bak": float(m[1]),
            "dnsmos_ovrl": float(m[2])}


def inception_score(video: np.ndarray, model_path: Optional[str] = None,
                    max_frames: int = 16) -> Optional[Dict[str, float]]:
    """IS over sampled frames via a LOCAL TorchScript classifier. Contract:
    `forward(frames [N, 3, H, W] float in [0, 1]) -> logits [N, C]`.
    IS = exp(E_x KL(p(y|x) || p(y))), single split."""
    model = _load_torchscript(model_path) if model_path else None
    if model is None:
        return None
    import torch

    idx = np.linspace(0, len(video) - 1, min(max_frames, len(video))).astype(int)
    frames = torch.from_numpy(np.ascontiguousarray(
        video[idx].transpose(0, 3, 1, 2), np.float32) / 255.0)
    with torch.no_grad():
        logits = model(frames).numpy().astype(np.float64)
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(axis=1, keepdims=True)
    marginal = p.mean(axis=0, keepdims=True)
    kl = np.sum(p * (np.log(p + 1e-12) - np.log(marginal + 1e-12)), axis=1)
    return {"inception_score": float(np.exp(kl.mean()))}


def ib_score(video: np.ndarray, audio: np.ndarray, sr: int,
             model_path: Optional[str] = None,
             max_frames: int = 8) -> Optional[Dict[str, float]]:
    """ImageBind-style image-audio agreement via a LOCAL TorchScript
    embedder. Contract: `forward(frames [N, 3, H, W] float in [0, 1],
    audio [S] float32 @16 kHz) -> (img_emb [N, D], aud_emb [M, D])`;
    score = mean pairwise cosine similarity."""
    model = _load_torchscript(model_path) if model_path else None
    if model is None:
        return None
    import torch

    idx = np.linspace(0, len(video) - 1, min(max_frames, len(video))).astype(int)
    frames = torch.from_numpy(np.ascontiguousarray(
        video[idx].transpose(0, 3, 1, 2), np.float32) / 255.0)
    a = torch.from_numpy(_resample_linear(audio, sr, 16000))
    with torch.no_grad():
        img, aud = model(frames, a)
    img = img.numpy() / (np.linalg.norm(img.numpy(), axis=1, keepdims=True) + 1e-9)
    aud = aud.numpy() / (np.linalg.norm(aud.numpy(), axis=1, keepdims=True) + 1e-9)
    return {"ib_score": float(np.mean(img @ aud.T))}


def _cer(hyp: str, ref: str) -> float:
    """Character error rate (Levenshtein / len(ref))."""
    hyp, ref = list(hyp), list(ref)
    if not ref:
        return 0.0 if not hyp else 1.0
    prev = list(range(len(ref) + 1))
    for i, hc in enumerate(hyp, 1):
        cur = [i] + [0] * len(ref)
        for j, rc in enumerate(ref, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (hc != rc))
        prev = cur
    return prev[-1] / len(ref)


@functools.lru_cache(maxsize=2)
def _load_asr(asr_model_path: str):
    """Cached per path (see _load_torchscript)."""
    try:
        from transformers import pipeline as hf_pipeline
    except ImportError:
        return None
    try:
        return hf_pipeline("automatic-speech-recognition",
                           model=asr_model_path)
    except Exception:
        return None


def cpcer(audio: np.ndarray, sr: int, text: str,
          asr_model_path: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Character error rate of the generated speech against the prompt text
    via a LOCAL ASR checkpoint (transformers pipeline dir; zero-egress:
    returns None without one)."""
    if not asr_model_path or not text:
        return None
    asr = _load_asr(asr_model_path)
    if asr is None:
        return None
    a16 = _resample_linear(audio, sr, 16000)
    out = asr({"raw": a16, "sampling_rate": 16000})
    hyp = (out.get("text") or "").strip().lower()
    return {"cpcer": _cer(hyp, text.strip().lower()),
            "transcript": hyp}


def evaluate_clip(video: np.ndarray, audio: np.ndarray, sr: int, fps: float,
                  reference_video: Optional[np.ndarray] = None,
                  first_frame: Optional[np.ndarray] = None,
                  prompt: Optional[str] = None,
                  clip_model: Optional[str] = None,
                  syncnet_model: Optional[str] = None,
                  dnsmos_model: Optional[str] = None,
                  is_model: Optional[str] = None,
                  ib_model: Optional[str] = None,
                  asr_model: Optional[str] = None) -> Dict:
    """One-call report over a generated [T,H,W,3] uint8 + [S] float clip.
    The *_model paths enable the Verse-Bench-class model-based rows
    (BASELINE.md quality table); each is skipped (absent from the report)
    without its local checkpoint."""
    report: Dict = {
        "num_frames": int(len(video)),
        "resolution": [int(video.shape[1]), int(video.shape[2])],
        "audio_seconds": float(len(np.asarray(audio).reshape(-1)) / sr),
        "temporal": temporal_profile(video),
        "audio": audio_stats(audio),
        "av_sync": av_sync(video, audio, sr, fps),
    }
    if reference_video is not None:
        report["fidelity_vs_reference"] = video_fidelity(video, reference_video)
    if first_frame is not None:
        report["first_frame"] = {
            "psnr": psnr(video[0], first_frame),
            "ssim": ssim(video[0], first_frame),
        }
    if prompt and clip_model:
        cs = clip_scores(video, prompt, clip_model)
        if cs:
            report["clip"] = cs
    for res in (lse_scores(video, audio, sr, fps, syncnet_model),
                dnsmos_score(audio, sr, dnsmos_model),
                inception_score(video, is_model),
                ib_score(video, audio, sr, ib_model),
                cpcer(audio, sr, prompt or "", asr_model)):
        if res:
            report.update(res)
    return report
