"""AV output: mux generated frames and waveform to disk (the port's copy of
`dualforce_tpu/utils/av_io.py`; a test holds the two byte-equal).

Behavioural reference: mova/utils/data.py:88-125 `save_video_with_audio`
(imageio mp4 + stdlib WAV -> ffmpeg `-c:v copy -c:a aac` mux, with video-only
fallback). The fallback chain:
  1. ffmpeg on PATH -> H.264 mp4 with AAC audio (reference-equivalent);
  2. pure-Python MJPEG AVI (PIL JPEG frames in a standard AVI container,
     playable everywhere) + side-by-side WAV.
PIL is imported only where a frame is encoded or decoded; `write_wav` needs
nothing beyond the standard library.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
import tempfile
import wave
from typing import Optional

import numpy as np


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """audio: float [-1, 1] (any shape squeezing to 1-D) -> 16-bit PCM WAV."""
    data = np.asarray(audio).squeeze()
    pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def _jpeg_frames(video: np.ndarray, quality: int = 92):
    from PIL import Image

    for frame in video:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
        yield buf.getvalue()


def write_mjpeg_avi(path: str, video: np.ndarray, fps: float,
                    audio: Optional[np.ndarray] = None,
                    sample_rate: int = 48000, quality: int = 92) -> None:
    """Minimal AVI writer: MJPEG video stream + optional PCM16 audio stream."""
    T, H, W, _ = video.shape
    frames = list(_jpeg_frames(video, quality))
    pcm = None
    if audio is not None:
        pcm = (np.clip(np.asarray(audio).squeeze(), -1, 1) * 32767).astype("<i2").tobytes()

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        pad = b"\x00" if len(data) % 2 else b""
        return fourcc + struct.pack("<I", len(data)) + data + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    n_streams = 2 if pcm is not None else 1
    usec_per_frame = int(1_000_000 / fps)
    max_bytes = max(len(f) for f in frames)

    avih = struct.pack("<14I", usec_per_frame, max_bytes * int(fps), 0, 0x10,
                       T, 0, n_streams, max_bytes, W, H, 0, 0, 0, 0)
    # dwScale/dwRate as a 1000-denominator rational (23.976 fps must not
    # truncate to 24 — PCM would drift on long clips); dwSampleSize MUST be 0
    # for 'vids' streams (non-zero means fixed-size samples per the AVI spec)
    strh_v = (b"vids" + b"MJPG" + struct.pack("<I", 0) + struct.pack("<HH", 0, 0)
              + struct.pack("<8I", 0, 1000, int(round(fps * 1000)), 0, T,
                            max_bytes, 0, 0)
              + struct.pack("<4H", 0, 0, W, H))
    strf_v = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG",
                         W * H * 3, 0, 0, 0, 0)
    strl_v = lst(b"strl", chunk(b"strh", strh_v) + chunk(b"strf", strf_v))

    strl_a = b""
    if pcm is not None:
        block_align = 2
        strh_a = (b"auds" + b"\x00" * 4 + struct.pack("<I", 0)
                  + struct.pack("<HH", 0, 0)
                  + struct.pack("<8I", 0, 1, sample_rate, 0,
                                len(pcm) // block_align, block_align, 0,
                                len(pcm) // block_align)
                  + struct.pack("<4H", 0, 0, 0, 0))
        strf_a = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2, 2, 16)
        strl_a = lst(b"strl", chunk(b"strh", strh_a) + chunk(b"strf", strf_a))

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl_v + strl_a)

    # the chunks joined once at the end: appending each to one bytes object copies the
    # stream so far every time (quadratic in the clip's size)
    movi_parts = [b"movi"]
    index = []
    offset = 4
    for i, f in enumerate(frames):
        c = chunk(b"00dc", f)
        index.append((b"00dc", offset, len(f)))
        movi_parts.append(c)
        offset += len(c)
        if pcm is not None:
            # interleave audio in per-frame slices
            spf = len(pcm) // T
            spf -= spf % 2
            a = pcm[i * spf:(i + 1) * spf] if i < T - 1 else pcm[i * spf:]
            ac = chunk(b"01wb", a)
            index.append((b"01wb", offset, len(a)))
            movi_parts.append(ac)
            offset += len(ac)
    movi = chunk(b"LIST", b"".join(movi_parts))

    idx = b"".join(
        cc + struct.pack("<3I", 0x10, off, size) for cc, off, size in index)
    idx1 = chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def save_video_with_audio(path: str, video: np.ndarray, audio: Optional[np.ndarray],
                          fps: float = 24.0, sample_rate: int = 48000) -> str:
    """video: [T, H, W, 3] uint8; audio: float waveform or None.

    Returns the actual output path (extension may change for the AVI fallback).
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ffmpeg_available():
        with tempfile.TemporaryDirectory() as td:
            wav = os.path.join(td, "a.wav")
            raw = os.path.join(td, "v.avi")
            write_mjpeg_avi(raw, video, fps)
            cmd = ["ffmpeg", "-y", "-i", raw]
            if audio is not None:
                write_wav(wav, audio, sample_rate)
                cmd += ["-i", wav, "-c:a", "aac", "-shortest"]
            cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", path]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
                return path
            except (subprocess.CalledProcessError, FileNotFoundError):
                pass  # fall through to pure-python container
    out = os.path.splitext(path)[0] + ".avi"
    write_mjpeg_avi(out, video, fps, audio, sample_rate)
    return out


def read_mjpeg_avi(path: str):
    """Read back an AVI written by `write_mjpeg_avi` (and standard
    MJPEG+PCM16 AVIs generally): returns (video [T,H,W,3] uint8,
    audio [S] float32 or None, sample_rate, fps). The read counterpart makes
    the no-ffmpeg fallback container a round-trippable interchange format
    (scripts/eval.py consumes generated clips through it)."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path!r} is not an AVI file")

    fps, sample_rate = 24.0, 48000
    frames, pcm_parts = [], []

    def walk(buf: bytes):
        nonlocal fps, sample_rate
        pos = 0
        stream_types = []
        while pos + 8 <= len(buf):
            fourcc = buf[pos:pos + 4]
            (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
            payload = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(payload[4:])
            elif fourcc == b"strh":
                stream_types.append(payload[:4])
                if payload[:4] == b"vids":
                    scale, rate = struct.unpack("<II", payload[20:28])
                    if scale:
                        fps = rate / scale
            elif fourcc == b"strf" and stream_types and stream_types[-1] == b"auds":
                sample_rate = struct.unpack("<I", payload[4:8])[0]
            elif fourcc == b"00dc" and size:
                frames.append(np.asarray(
                    Image.open(io.BytesIO(payload)).convert("RGB")))
            elif fourcc == b"01wb" and size:
                pcm_parts.append(payload)
            pos += 8 + size + (size % 2)

    walk(data[12:])
    if not frames:
        raise ValueError(f"no video frames found in {path!r}")
    audio = None
    if pcm_parts:
        pcm = np.frombuffer(b"".join(pcm_parts), "<i2")
        audio = pcm.astype(np.float32) / 32767.0
    return np.stack(frames), audio, sample_rate, fps
