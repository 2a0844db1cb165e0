"""The port's copies of the JAX package's jax-free AV writer
(`utils/av_io.py`) and first-frame transforms (`data/transforms.py`): the
same bytes on disk and the same arrays for the same inputs."""

import os

import numpy as np
import pytest
from PIL import Image

from dualforce_tpu.data import transforms as jax_transforms
from dualforce_tpu.utils import av_io as jax_av_io

from dualforce_tpu_torch.data import transforms
from dualforce_tpu_torch.utils import av_io
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


@pytest.fixture
def clip():
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (5, 24, 40, 3), np.uint8)
    audio = np.clip(rng.normal(0, 0.5, 10000), -1.5, 1.5).astype(np.float32)
    return video, audio


def _same_file(tmp_path, name, write_port, write_jax):
    a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    write_port(a)
    write_jax(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), name
    return a


def test_wav_and_avi_bytes_match_jax(tmp_path, clip):
    video, audio = clip
    _same_file(tmp_path, "a.wav", lambda p: av_io.write_wav(p, audio, 48000),
               lambda p: jax_av_io.write_wav(p, audio, 48000))
    _same_file(tmp_path, "v.avi", lambda p: av_io.write_mjpeg_avi(p, video, 23.976),
               lambda p: jax_av_io.write_mjpeg_avi(p, video, 23.976))
    path = _same_file(tmp_path, "av.avi",
                      lambda p: av_io.write_mjpeg_avi(p, video, 24.0, audio, 48000),
                      lambda p: jax_av_io.write_mjpeg_avi(p, video, 24.0, audio, 48000))
    got, want = av_io.read_mjpeg_avi(path), jax_av_io.read_mjpeg_avi(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == video.shape and got[1].shape == audio.shape


def test_save_video_with_audio_matches_jax(tmp_path, clip, monkeypatch):
    """Without ffmpeg both fall back to the same AVI, renamed alike."""
    video, audio = clip
    monkeypatch.setattr(av_io, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(jax_av_io, "ffmpeg_available", lambda: False)
    a = av_io.save_video_with_audio(str(tmp_path / "p" / "out.mp4"), video, audio, 24.0)
    b = jax_av_io.save_video_with_audio(str(tmp_path / "j" / "out.mp4"), video, audio, 24.0)
    assert os.path.basename(a) == os.path.basename(b) == "out.avi"
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("src,dst", [((48, 40), (32, 32)), ((640, 352), (352, 640)),
                                     ((100, 37), (24, 56)), ((32, 32), (32, 32))])
def test_first_frame_transforms_match_jax(src, dst):
    w, h = src
    image = Image.fromarray(np.random.default_rng(w * h).integers(0, 256, (h, w, 3),
                                                                   np.uint8))
    got = transforms.image_to_tensor(transforms.crop_and_resize(image, *dst))
    want = jax_transforms.image_to_tensor(jax_transforms.crop_and_resize(image, *dst))
    assert got.shape == dst + (3,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
