"""The training clips and their batches (counterpart of
`dualforce_tpu/data/dataset.py`).

A dataset is a `metadata.json` list of {"video_path", "caption"}, paths
relative to its directory. Media:
  - `.npz` clip shards: {video [T, H, W, 3] uint8, audio [S] float32, fps,
    sr};
  - frame directories (`*.jpg`, `*.jpeg`, `*.png` in name order) with an
    optional `audio.wav` (8-, 16- or 32-bit PCM, channels averaged);
  - MJPEG `.avi` files (`utils.av_io.read_mjpeg_avi`).
Frames are padded by repeating the last one or trimmed to `num_frames`,
scaled to cover and center-cropped by the C++ kernel (`data.native`) to
[-1, 1]; the audio is resampled to the codec's rate and padded with zeros
or trimmed to sr * num_frames / fps samples. A shard whose fps is not the
dataset's raises: the batches' shapes are fixed and the audio would drift
from the video. `make_data_iter` tokenizes the captions and prefetches
batches in background threads.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import wave
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from dualforce_tpu_torch.data import native
from dualforce_tpu_torch.registry import DATASETS


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear resampling onto the new rate's sample times (float32)."""
    if sr == target_sr:
        return audio.astype(np.float32, copy=False)
    t_old = np.arange(len(audio)) / sr
    t_new = np.arange(int(len(audio) * target_sr / sr)) / target_sr
    return np.interp(t_new, t_old, audio).astype(np.float32)


# PCM sample width -> (dtype, offset, scale)
_PCM = {1: (np.uint8, 128.0, 128.0), 2: ("<i2", 0.0, 32768.0), 4: ("<i4", 0.0, 2147483648.0)}


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """A PCM WAV as mono float32 at `target_sr`."""
    with wave.open(path, "rb") as f:
        sr, n, width = f.getframerate(), f.getnframes(), f.getsampwidth()
        if width not in _PCM:
            raise ValueError(f"{path}: unsupported PCM sample width {width} "
                             "(supported: 8/16/32-bit)")
        dt, offset, scale = _PCM[width]
        raw = (np.frombuffer(f.readframes(n), dtype=dt).astype(np.float32) - offset) / scale
        if f.getnchannels() > 1:
            raw = raw.reshape(-1, f.getnchannels()).mean(axis=1)
    return resample(raw, sr, target_sr)


@DATASETS.register_module(name="VideoAudioDataset")
class VideoAudioDataset:
    def __init__(self, metadata_path: str, height: int = 352, width: int = 640,
                 num_frames: int = 49, fps: float = 24.0, sample_rate: int = 48000):
        with open(metadata_path) as f:
            self.items: List[Dict[str, Any]] = json.load(f)
        self.root = os.path.dirname(os.path.abspath(metadata_path))
        self.height, self.width = height, width
        self.num_frames, self.fps = num_frames, fps
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return len(self.items)

    def _resolve(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def _load_media(self, path: str):
        """(frames [T][H, W, 3] uint8, audio [S] or None, its rate, fps)."""
        if path.endswith(".npz"):
            with np.load(path) as data:
                video = data["video"]
                audio = data["audio"].astype(np.float32)
                sr = int(data["sr"]) if "sr" in data else self.sample_rate
                clip_fps = float(data["fps"]) if "fps" in data else self.fps
            return list(video), audio, sr, clip_fps
        if os.path.isdir(path):
            from PIL import Image

            names = sorted(f for f in os.listdir(path)
                           if f.lower().endswith((".jpg", ".jpeg", ".png")))
            frames = [np.asarray(Image.open(os.path.join(path, f)).convert("RGB"))
                      for f in names]
            wav = os.path.join(path, "audio.wav")
            audio = load_wav(wav, self.sample_rate) if os.path.exists(wav) else None
            return frames, audio, self.sample_rate, self.fps
        if path.lower().endswith(".avi"):
            from dualforce_tpu_torch.utils.av_io import read_mjpeg_avi

            video, audio, sr, clip_fps = read_mjpeg_avi(path)
            return list(video), audio, sr, clip_fps
        raise ValueError(f"unsupported media {path!r}: use .npz clip shards, MJPEG .avi "
                         "or frame directories")

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.items[idx]
        frames, audio, sr, clip_fps = self._load_media(self._resolve(item["video_path"]))
        if len(frames) < self.num_frames:
            frames = frames + [frames[-1]] * (self.num_frames - len(frames))
        frames = frames[: self.num_frames]
        video = native.resize_crop_normalize(
            np.stack([np.asarray(f, np.uint8) for f in frames]), self.height, self.width)
        if abs(clip_fps - self.fps) > 1e-3:
            raise ValueError(f"{item['video_path']}: shard fps {clip_fps} != dataset fps "
                             f"{self.fps}; re-encode the clip at {self.fps} fps")
        target = int(self.sample_rate * self.num_frames / self.fps)
        if audio is None:
            audio = np.zeros((target,), np.float32)
        audio = resample(audio, sr, self.sample_rate)
        if len(audio) < target:
            audio = np.pad(audio, (0, target - len(audio)))
        audio = audio[:target]
        return {"video": video, "audio": audio[None, :], "first_frame": video[0],
                "caption": item.get("caption", "")}


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {"video": np.stack([s["video"] for s in samples]),
            "audio": np.stack([s["audio"] for s in samples]),
            "first_frame": np.stack([s["first_frame"] for s in samples]),
            "caption": [s["caption"] for s in samples]}


def make_data_iter(dataset, tokenizer, batch_size: int = 1, shuffle: bool = True,
                   seed: int = 0, num_workers: int = 2, max_text_len: int = 512,
                   epochs: Optional[int] = None,
                   drop_last: bool = True) -> Iterator[Dict[str, Any]]:
    """Batches of `batch_size` clips (order from a numpy generator seeded
    with `seed`, reshuffled each epoch; `epochs` None: forever), captions
    tokenized into `text_ids` / `text_mask`, prefetched by `num_workers`
    threads into a queue of 4. A trailing partial batch is dropped unless
    `drop_last` is False. A worker's exception is raised to the consumer;
    when the consumer stops early, the workers stop too."""
    rng = np.random.default_rng(seed)
    q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        """q.put that keeps honouring `stop`, so a consumer that exits early
        never leaves a worker blocked on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def order():
        epoch = 0
        while epochs is None or epoch < epochs:
            idx = np.arange(len(dataset))
            if shuffle:
                rng.shuffle(idx)
            yield from idx.tolist()
            epoch += 1

    idx_iter = order()
    lock = threading.Lock()
    alive = [max(num_workers, 1)]      # the last worker to exit sends the end

    def worker():
        try:
            while not stop.is_set():
                with lock:
                    batch_idx = []
                    try:
                        for _ in range(batch_size):
                            batch_idx.append(next(idx_iter))
                    except StopIteration:
                        if not batch_idx or (drop_last and len(batch_idx) < batch_size):
                            return
                batch = collate([dataset[i] for i in batch_idx])
                tok = tokenizer(batch.pop("caption"), padding="max_length",
                                max_length=max_text_len, truncation=True,
                                add_special_tokens=True, return_attention_mask=True,
                                return_tensors="np")
                batch["text_ids"] = tok["input_ids"]
                batch["text_mask"] = tok["attention_mask"]
                if not put_or_stop(batch):
                    return
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer, which raises it
            put_or_stop(e)
        finally:
            with lock:
                alive[0] -= 1
                if alive[0] == 0:
                    put_or_stop(None)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(alive[0])]
    for t in threads:
        t.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                break
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
