"""Rotary position embeddings (counterpart of `dualforce_tpu/ops/rope.py`).

1. DiT self-attention RoPE: interleaved pairs (2i, 2i+1) rotate as complex
   numbers, with factorised 3D (frame, height, width) tables for video and
   1D tables for audio.
2. Bridge cross-attention RoPE: rotate-half, with time-aligned positions
   that map video latent frames onto audio-step units.

The tables are built on the host in float64 with numpy (copied from the JAX
package) and stored as fp32; callers move them to the device. The appliers
rotate in fp32 and cast back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# table precompute (host, float64)
# ---------------------------------------------------------------------------

def _freqs_cis(dim: int, end: int, theta: float = 10000.0, s: float = 1.0):
    """Angles [end, dim//2] in float64 (precompute_freqs_cis, wan_video_dit.py:114-120)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    pos = np.arange(end, dtype=np.float64) * s
    return np.outer(pos, inv)  # angles; cos/sin derived by caller


def precompute_freqs_3d(head_dim: int, end: int = 1024, theta: float = 10000.0):
    """3D (frame, height, width) factorized tables.

    Returns (cos, sin) tuples per axis, each [end, d_axis//2] fp32, where
    d_f = head_dim - 2*(head_dim//3), d_h = d_w = head_dim//3
    (wan_video_dit.py:106-111).
    """
    d_h = d_w = head_dim // 3
    d_f = head_dim - 2 * d_h
    out = []
    for d in (d_f, d_h, d_w):
        ang = _freqs_cis(d, end, theta)
        out.append((np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)))
    return tuple(out)


def precompute_freqs_1d(head_dim: int, end: int = 16384, theta: float = 10000.0,
                        variant: str = "dac", base_tps: float = 4.0,
                        target_tps: float = 44100 / 2048):
    """Audio 1D tables, [end, head_dim//2] fp32 cos/sin.

    variant="dac": full-dim 1D RoPE (precompute_freqs_cis_1d, wan_audio_dit.py:48-50 —
      the table is chunked in 3 and re-concatenated, i.e. identity).
    variant="oobleck": legacy — only the first (head_dim - 2*(head_dim//3)) dims
      rotate, positions rescaled by base_tps/target_tps; remaining dims identity
      (wan_audio_dit.py:38-45).
    """
    if variant == "dac":
        ang = _freqs_cis(head_dim, end, theta)
        return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    if variant == "oobleck":
        s = float(base_tps) / float(target_tps)
        d_rest = head_dim // 3
        d_f = head_dim - 2 * d_rest
        ang_f = _freqs_cis(d_f, end, theta, s)
        cos = np.concatenate(
            [np.cos(ang_f), np.ones((end, d_rest // 2)), np.ones((end, d_rest // 2))], axis=1
        )
        sin = np.concatenate(
            [np.sin(ang_f), np.zeros((end, d_rest // 2)), np.zeros((end, d_rest // 2))], axis=1
        )
        return cos.astype(np.float32), sin.astype(np.float32)
    raise ValueError(f"unknown 1d rope variant: {variant}")


def build_video_freqs(tables, grid: Tuple[int, int, int]):
    """Expand factorized 3D tables to per-token (cos, sin), each [f*h*w, head_dim//2].

    Mirrors the concat/expand in wan_video_dit.py:440-444 — frame angles for
    the first d_f/2 complex lanes, then height, then width.
    """
    (cf, sf), (ch, sh), (cw, sw) = tables
    f, h, w = grid
    cos = np.concatenate([
        np.broadcast_to(cf[:f, None, None, :], (f, h, w, cf.shape[1])),
        np.broadcast_to(ch[None, :h, None, :], (f, h, w, ch.shape[1])),
        np.broadcast_to(cw[None, None, :w, :], (f, h, w, cw.shape[1])),
    ], axis=-1).reshape(f * h * w, -1)
    sin = np.concatenate([
        np.broadcast_to(sf[:f, None, None, :], (f, h, w, sf.shape[1])),
        np.broadcast_to(sh[None, :h, None, :], (f, h, w, sh.shape[1])),
        np.broadcast_to(sw[None, None, :w, :], (f, h, w, sw.shape[1])),
    ], axis=-1).reshape(f * h * w, -1)
    return cos, sin


def build_audio_freqs(tables, length: int):
    """Slice 1D tables to the token count: (cos, sin) each [length, head_dim//2]."""
    cos, sin = tables
    return cos[:length], sin[:length]


# ---------------------------------------------------------------------------
# application (fp32 rotation unless asked otherwise, cast back)
# ---------------------------------------------------------------------------

def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: [B, S, N, D], adjacent channel pairs (2i, 2i+1) as complex numbers;
    cos/sin: [S, D//2], broadcast over batch and heads. The rotation runs in
    `compute_dtype`, x and the tables cast to it first; bf16 is the int8
    (sage) attention path's, as in the JAX package."""
    b, s, n, d = x.shape
    xf = x.to(compute_dtype).reshape(b, s, n, d // 2, 2)
    even, odd = xf[..., 0], xf[..., 1]
    c = cos.to(compute_dtype)[None, :, None, :]
    si = sin.to(compute_dtype)[None, :, None, :]
    out = torch.stack([even * c - odd * si, even * si + odd * c], dim=-1)
    return out.reshape(b, s, n, d).to(x.dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half application. x: [B, S, N, D]; cos/sin: [B or 1, S, D]."""
    xf = x.float()
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def build_aligned_cross_rope(
    *,
    video_fps: float,
    grid: Tuple[int, int, int],
    audio_steps: int,
    audio_fps: float,
    head_dim: int,
    theta: float = 10000.0,
    first_frame_bias: bool = False,
    vae_temporal_stride: int = 4,
):
    """Time-aligned cross-modal RoPE tables (bridge.build_aligned_freqs,
    interactionv2.py:420-475).

    Audio steps are the reference clock (positions 0..L_a-1); video latent
    frames are mapped onto audio-step units via
    `audio_fps / (video_fps / vae_temporal_stride)`, every token in a frame
    sharing the frame's time position.

    Returns ((cos_v, sin_v), (cos_a, sin_a)), shapes [1, L, head_dim] fp32.
    """
    f_v, h, w = grid
    if first_frame_bias:
        eff_fps = float(video_fps) / vae_temporal_stride
        t_starts = np.zeros((f_v,), dtype=np.float64)
        if f_v > 1:
            t_starts[1:] = (1.0 / float(video_fps)) + np.arange(f_v - 1, dtype=np.float64) / eff_fps
        video_pos_frame = t_starts * float(audio_fps)
    else:
        scale = float(audio_fps) / (float(video_fps) / vae_temporal_stride)
        video_pos_frame = np.arange(f_v, dtype=np.float64) * scale
    video_pos = np.repeat(video_pos_frame, h * w)
    audio_pos = np.arange(audio_steps, dtype=np.float64)

    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))

    def _cs(pos):
        ang = np.outer(pos, inv)
        emb = np.concatenate([ang, ang], axis=-1)
        return (np.cos(emb).astype(np.float32)[None],
                np.sin(emb).astype(np.float32)[None])

    return _cs(video_pos), _cs(audio_pos)
