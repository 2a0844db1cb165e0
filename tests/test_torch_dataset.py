"""The port's clip dataset (`data/dataset.py`) and C++ data kernels
(`data/native.py`) against the JAX package's, on the CPU.

Clips are synthetic, from a numpy seed: npz shards, frame directories with
8-, 16- and 32-bit PCM wav (stereo among them) and an MJPEG AVI with audio,
at sizes that take both the pad and the trim paths. Both datasets run the
C++ kernel of `native/dfdata.cpp` (each package builds its own library from
it), so their items must be bit-equal; each native function is held
against its plain version (the C++ resize is bilinear and PIL's LANCZOS:
0.06 mean absolute, as `tests/test_native_data.py` bounds it; the rest
within fp32 round-off or exactly).
"""

import json
import threading
import time
import wave

import numpy as np
import pytest

from dualforce_tpu.data import dataset as jds
from dualforce_tpu.data import native as jnative

from dualforce_tpu_torch.data import dataset as tds
from dualforce_tpu_torch.data import native
from dualforce_tpu_torch.utils.av_io import write_mjpeg_avi

H, W, T, FPS, SR = 40, 72, 6, 24.0, 16000


class Tok:
    """Byte-level captions, so that batches show which clip they hold."""

    def __call__(self, caps, max_length=16, **kw):
        ids = np.zeros((len(caps), max_length), np.int64)
        for i, c in enumerate(caps):
            b = list(c.encode())[:max_length]
            ids[i, :len(b)] = b
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def _frames(rng, n, h=54, w=80):
    base = rng.integers(0, 256, (n, h // 6, w // 8, 3)).astype(np.uint8)
    return np.repeat(np.repeat(base, 6, axis=1), 8, axis=2)


def _wav(path, rng, width, channels=1, sr=22050, n=4000):
    kinds = {1: (np.uint8, 0, 255), 2: ("<i2", -32768, 32767), 4: ("<i4", -2**31, 2**31 - 1)}
    dt, lo, hi = kinds[width]
    data = rng.integers(lo, hi, (n * channels,), dtype=np.int64).astype(dt)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    items = []
    for i, n in enumerate((T + 3, T - 2)):            # trimmed and padded
        np.savez(root / f"shard{i}.npz", video=_frames(rng, n),
                 audio=rng.uniform(-0.5, 0.5, 9000).astype(np.float32), fps=FPS,
                 sr=48000 if i == 0 else SR)
        items.append({"video_path": f"shard{i}.npz", "caption": f"npz {i}"})
    for width, channels in ((1, 1), (2, 2), (4, 1)):
        d = root / f"frames{width}"
        d.mkdir()
        for j, frame in enumerate(_frames(rng, T - 1, 60, 64)):
            Image.fromarray(frame).save(d / f"frame_{j:05d}.png")
        _wav(d / "audio.wav", rng, width, channels)
        items.append({"video_path": f"frames{width}", "caption": f"wav {width}"})
    d = root / "silent"
    d.mkdir()
    for j, frame in enumerate(_frames(rng, T)):
        Image.fromarray(frame).save(d / f"frame_{j:05d}.jpg", quality=95)
    items.append({"video_path": str(d), "caption": "no audio"})      # an absolute path
    write_mjpeg_avi(str(root / "clip.avi"), _frames(rng, T + 1),
                    FPS, rng.uniform(-0.5, 0.5, 5000).astype(np.float32), sample_rate=SR)
    items.append({"video_path": "clip.avi", "caption": "avi"})
    with open(root / "metadata.json", "w") as f:
        json.dump(items, f)
    return root


def _pair(root, **kw):
    args = dict(height=H, width=W, num_frames=T, fps=FPS, sample_rate=SR, **kw)
    meta = str(root / "metadata.json")
    return tds.VideoAudioDataset(meta, **args), jds.VideoAudioDataset(meta, **args)


def test_items_bit_equal_to_jax(clips):
    assert jnative.available()        # JAX's dataset takes the C++ path too
    ours, theirs = _pair(clips)
    assert len(ours) == len(theirs) == 7
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert set(got) == set(want)
        assert got["caption"] == want["caption"]
        for key in ("video", "audio", "first_frame"):
            assert got[key].dtype == want[key].dtype == np.float32
            assert got[key].shape == want[key].shape, (i, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"item {i} {key}")
        assert got["video"].shape == (T, H, W, 3)
        assert got["audio"].shape == (1, int(SR * T / FPS))
    silent = ours[5]["audio"]
    assert not silent.any()


def test_fps_mismatch_raises(tmp_path):
    np.savez(tmp_path / "c.npz", video=np.zeros((4, 8, 8, 3), np.uint8),
             audio=np.zeros(100, np.float32), fps=16.0, sr=SR)
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump([{"video_path": "c.npz", "caption": "x"}], f)
    for ds in _pair(tmp_path):
        with pytest.raises(ValueError, match="fps"):
            ds[0]


def test_unsupported_media_and_wav_width_raise(tmp_path):
    (tmp_path / "c.mp4").write_bytes(b"")
    d = tmp_path / "frames"
    d.mkdir()
    np.save(d / "x.npy", np.zeros(1))
    _wav(d / "audio.wav", np.random.default_rng(1), 2)
    with open(d / "audio.wav", "r+b") as f:            # claim 24-bit samples
        f.seek(34)
        f.write((24).to_bytes(2, "little"))
        f.seek(32)
        f.write((3).to_bytes(2, "little"))
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump([{"video_path": "c.mp4"}], f)
    for ds in _pair(tmp_path):
        with pytest.raises(ValueError, match="unsupported media"):
            ds[0]
    with pytest.raises(ValueError, match="sample width 3"):
        tds.load_wav(str(d / "audio.wav"), SR)


def _batches(make, ds, **kw):
    return [{k: v for k, v in b.items()}
            for b in make(ds, Tok(), batch_size=2, num_workers=1, max_text_len=16, **kw)]


def test_data_iter_one_worker_matches_jax(clips):
    """One worker: the same batches in the same order (seeded shuffle, two
    epochs, the trailing partial batch dropped), tokenized captions beside."""
    ours, theirs = _pair(clips)
    got = _batches(tds.make_data_iter, ours, epochs=2, seed=3)
    want = _batches(jds.make_data_iter, theirs, epochs=2, seed=3)
    assert len(got) == len(want) == 7                  # 14 clips in batches of 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"video", "audio", "first_frame", "text_ids", "text_mask"}
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    kept = list(tds.make_data_iter(ours, Tok(), batch_size=2, num_workers=3, epochs=1,
                                   drop_last=False, max_text_len=16))
    assert sorted(b["video"].shape[0] for b in kept) == [1, 2, 2, 2]


def test_data_iter_raises_a_workers_error(tmp_path):
    (tmp_path / "broken.npz").write_bytes(b"not a zip")
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump([{"video_path": "broken.npz", "caption": "x"}], f)
    ds, _ = _pair(tmp_path)
    with pytest.raises(Exception):
        next(tds.make_data_iter(ds, Tok(), num_workers=2, epochs=1))


def test_early_stop_does_not_hang(clips):
    """A consumer that stops after one batch of an endless iterator: the
    workers, blocked on the full queue, exit once it is closed."""
    ours, _ = _pair(clips)
    before = set(threading.enumerate())
    it = tds.make_data_iter(ours, Tok(), batch_size=1, num_workers=3, max_text_len=16)
    next(it)
    time.sleep(0.5)                                    # the queue fills, workers block
    workers = set(threading.enumerate()) - before
    assert len(workers) == 3
    it.close()
    for t in workers:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in workers)


def test_resize_crop_normalize_against_plain():
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (3, 12, 16, 3))
    video = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2).astype(np.uint8)
    for out_h, out_w in ((48, 48), (40, 72), (96, 128)):
        got = native.resize_crop_normalize(video, out_h, out_w)
        want = native.resize_crop_normalize_plain(video, out_h, out_w)
        assert got.shape == want.shape == (3, out_h, out_w, 3)
        assert np.mean(np.abs(got - want)) < 0.06
        np.testing.assert_array_equal(got, jnative.resize_crop_normalize(video, out_h, out_w))
    same = native.resize_crop_normalize(video, 96, 128)    # no resize: exact
    np.testing.assert_array_equal(same, video.astype(np.float32) / np.float32(127.5) - 1)
    with pytest.raises(ValueError):
        native.resize_crop_normalize(video[..., :2], 8, 8)


def test_pcm_resample_against_plain():
    pcm = (np.sin(np.arange(9600) * 0.01) * 30000).astype(np.int16)
    same = native.pcm_resample(pcm, 48000, 48000)
    np.testing.assert_array_equal(same, native.pcm_resample_plain(pcm, 48000, 48000))
    for sr_out in (16000, 44100, 96000):
        got = native.pcm_resample(pcm, 48000, sr_out)
        want = native.pcm_resample_plain(pcm, 48000, sr_out)
        assert abs(len(got) - len(want)) <= 1
        n = min(len(got), len(want))
        np.testing.assert_allclose(got[:n], want[:n], atol=1e-6)
        np.testing.assert_array_equal(got, jnative.pcm_resample(pcm, 48000, sr_out))


def test_float_to_uint8_against_plain():
    rng = np.random.default_rng(3)
    f = rng.uniform(-1.2, 1.2, (2, 16, 16, 3)).astype(np.float32)
    got = native.float_to_uint8(f)
    want = native.float_to_uint8_plain(f)
    # half-up (C++) against half-to-even (numpy): at most one level, on ties only
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.mean(got != want) < 1e-3
    np.testing.assert_array_equal(got, jnative.float_to_uint8(f))


def test_native_library_is_built_outside_the_source_tree():
    path = native.build()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path == native.library_path() and "native" not in path.parent.parts


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to numpy."""
    broken = tmp_path / "dfdata.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed for dfdata.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
