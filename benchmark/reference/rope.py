"""RoPE tables and the bridge's interaction layers for the reference, from
the published formulas (Wan 2.x's factorised 3D video RoPE, a full-width 1D
audio RoPE, MOVA's time-aligned rotate-half RoPE for the bridge), computed
in float64 on the host and handed to the device as float32."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def interaction_layers(strategy: str, shared: int) -> List[int]:
    """The shared layers at which the bridge's a2v and v2a run (MOVA's
    `CrossModalInteractionController`)."""
    if strategy == "full":
        return list(range(shared))
    if strategy == "distributed":
        return list(range(0, shared, 3))
    if strategy == "shallow_focus":
        return list(range(min(10, shared // 3)))
    if strategy == "progressive":
        return list(range(min(8, shared))) + (list(range(8, shared, 3)) if shared > 8 else [])
    if strategy == "custom":
        return [i for i in (0, 2, 4, 6, 8, 12, 16, 20) if i < shared]
    raise ValueError(f"unknown interaction strategy {strategy!r}")


def _angles(dim: int, positions: np.ndarray, theta: float = 10000.0) -> np.ndarray:
    inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
    return np.outer(positions.astype(np.float64), inv)


def tables(cfg: dict, latent_fhw, audio_tokens: int, device) -> dict:
    """{"v": video self-attention (cos, sin) [f*h*w, D/2], "a": audio
    [T, D/2], "cross_v": the bridge's video side [f*h*w, D], "cross_a":
    its audio side [T, D]} for latents of frames/height/width `latent_fhw`."""
    vc, ac, bc = cfg["video_dit"], cfg["audio_dit"], cfg["bridge"]
    pt, ph, pw = vc["patch_size"]
    f, h, w = latent_fhw[0] // pt, latent_fhw[1] // ph, latent_fhw[2] // pw
    d = vc["dim"] // vc["num_heads"]
    d_h = d // 3
    d_f = d - 2 * d_h
    parts = [_angles(d_f, np.arange(f))[:, None, None, :],
             _angles(d_h, np.arange(h))[None, :, None, :],
             _angles(d_h, np.arange(w))[None, None, :, :]]
    video = np.concatenate([np.broadcast_to(p, (f, h, w, p.shape[-1])) for p in parts],
                           axis=-1).reshape(f * h * w, -1)
    if ac.get("vae_type", "dac") != "dac":
        raise ValueError("the reference has the DAC audio RoPE only")
    audio = _angles(ac["dim"] // ac["num_heads"], np.arange(audio_tokens))
    # video latent frames placed on the audio-step clock: one latent frame is
    # vae_temporal_stride video frames at video_fps
    scale = bc["audio_fps"] / (cfg["video_fps"] / cfg["video_vae"]["scale_factor_temporal"])
    video_t = np.repeat(np.arange(f, dtype=np.float64) * scale, h * w)

    def half(pos):
        ang = _angles(bc["head_dim"], pos, bc["rope_theta"])
        return np.concatenate([ang, ang], axis=-1)

    def cs(ang):
        return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
                torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))

    if not bc["apply_cross_rope"] or bc["apply_first_frame_bias_in_rope"]:
        raise ValueError("the reference has the bridge's plain aligned RoPE only")
    return {"v": cs(video), "a": cs(audio), "cross_v": cs(half(video_t)),
            "cross_a": cs(half(np.arange(audio_tokens, dtype=np.float64)))}
