"""The port's evaluation (`dualforce_tpu_torch/eval/metrics.py`,
`cli/eval.py`) against the JAX package's, on the CPU. Every comparison is
exact (the port's module is a copy of the numpy code):

- every public function of `eval/metrics.py` on seeded numpy clips, the
  model-free `evaluate_clip` included, and the hooks without a model;
- the TorchScript hooks on tiny scripted modules saved in `tmp_path`,
  loaded by both packages;
- the eval CLI's JSON against `scripts/eval.py`'s on an npz clip (with a
  reference clip and a first frame), an MJPEG AVI clip, a frame directory
  with its WAV, and `--batch` over a directory (table and aggregate JSON);
  its flags are the JAX script's.
"""

import argparse
import importlib.util
import json
import math
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dualforce_tpu.eval import metrics as jax_metrics

from dualforce_tpu_torch.cli import eval as eval_cli
from dualforce_tpu_torch.eval import metrics
from dualforce_tpu_torch.utils.av_io import write_mjpeg_avi
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]


def _clip(t=12, h=24, w=32, seed=0, sr=8000, fps=24.0):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (t, h, w, 3), np.uint8)
    video[4:6] = video[3]                        # a frozen stretch
    audio = (0.3 * np.sin(np.arange(int(sr * t / fps)) * 0.05)
             + 0.05 * rng.standard_normal(int(sr * t / fps))).astype(np.float32)
    audio[: sr // 10] = 0.0
    return video, audio, sr, fps


def _same(a, b):
    """Exact equality, inf and nan included, through dicts, lists and arrays."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k])
                                                                      for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def _calls(m):
    video, audio, sr, fps = _clip()
    other = _clip(seed=1)[0]
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((20, 6))
    return [
        m.psnr(video[0], other[0]), m.psnr(video[0], video[0]),
        m.psnr(video[0].astype(np.float32) / 255, other[0].astype(np.float32) / 255, 1.0),
        m.ssim(video[0], other[0]), m.ssim(video[0, ..., 0], other[0, ..., 1]),
        m._gaussian_window(), m._gaussian_window(7, 1.0),
        m._filter2d_sep(video[0, ..., 0].astype(np.float64), m._gaussian_window()),
        m.video_fidelity(video, other[:9]), m.temporal_profile(video),
        m.temporal_profile(video[:1]), m.motion_energy(video),
        m.audio_stats(audio), m.audio_stats(audio[:100]), m.audio_stats(audio * 5.0),
        m.audio_onset_envelope(audio, sr, fps, len(video)),
        m.av_sync(video, audio, sr, fps), m.av_sync(video, audio, sr, fps, max_lag_frames=3),
        m.av_sync(video[:4], audio, sr, fps),
        m.lse_from_embeddings(emb, emb[::-1], vshift=4), m.lse_from_embeddings(emb, emb),
        m._resample_linear(audio, sr, 16000), m._resample_linear(audio, sr, sr),
        m._cer("abcd", "abed"), m._cer("", ""), m._cer("x", ""),
        m.clip_scores(video, "a prompt"), m.clip_scores(video, "a prompt", None),
        m.lse_scores(video, audio, sr, fps), m.dnsmos_score(audio, sr),
        m.inception_score(video), m.ib_score(video, audio, sr),
        m.cpcer(audio, sr, "text"), m.cpcer(audio, sr, ""),
        m.evaluate_clip(video, audio, sr, fps),
        m.evaluate_clip(video, audio, sr, fps, reference_video=other, first_frame=other[0],
                        prompt="a prompt"),
    ]


def test_every_function_matches_jax():
    port, jax_ = _calls(metrics), _calls(jax_metrics)
    assert len(port) == len(jax_)
    for i, (a, b) in enumerate(zip(port, jax_)):
        assert _same(a, b), (i, a, b)


class _Sync(torch.nn.Module):
    def forward(self, video, audio):
        v = video.mean(dim=(2, 3))
        return v, v.flip(0) + audio[: v.shape[0], None]


class _Dnsmos(torch.nn.Module):
    def forward(self, audio):
        m = audio.abs().mean()
        return torch.stack([m, 2 * m, 3 * m])[None, :]


class _Classifier(torch.nn.Module):
    def forward(self, frames):
        return frames.mean(dim=(2, 3)).repeat(1, 3) * torch.arange(9.0)


class _Embedder(torch.nn.Module):
    def forward(self, frames, audio):
        return frames.mean(dim=(2, 3)), audio[:12].reshape(4, 3)


@pytest.fixture(scope="module")
def hooks(tmp_path_factory):
    root = tmp_path_factory.mktemp("hooks")
    paths = {}
    for name, module in (("syncnet", _Sync()), ("dnsmos", _Dnsmos()),
                         ("is", _Classifier()), ("ib", _Embedder())):
        paths[name] = str(root / f"{name}.pt")
        torch.jit.script(module).save(paths[name])
    return paths


def test_torchscript_hooks_match_jax(hooks):
    video, audio, sr, fps = _clip(t=30)
    audio = np.concatenate([audio] * 40)         # > 9 s at 16 kHz: two DNSMOS windows

    def run(m):
        return [m.lse_scores(video, audio, sr, fps, hooks["syncnet"], vshift=3),
                m.dnsmos_score(audio, sr, hooks["dnsmos"]),
                m.inception_score(video, hooks["is"], max_frames=5),
                m.ib_score(video, audio, sr, hooks["ib"]),
                m.evaluate_clip(video, audio, sr, fps, syncnet_model=hooks["syncnet"],
                                dnsmos_model=hooks["dnsmos"], is_model=hooks["is"],
                                ib_model=hooks["ib"])]

    port, jax_ = run(metrics), run(jax_metrics)
    assert all(x is not None for x in port)
    for a, b in zip(port, jax_):
        assert _same(a, b), (a, b)
    assert {"lse_d", "dnsmos_ovrl", "inception_score", "ib_score"} <= set(port[-1])


# --- the eval CLI ------------------------------------------------------------------

def _jax_eval_main():
    spec = importlib.util.spec_from_file_location("_jax_eval", REPO / "scripts" / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, capsys, monkeypatch, jax_script):
    if jax_script:
        monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
        main()
    else:
        main(argv)
    out = capsys.readouterr().out
    return out


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    video, audio, sr, fps = _clip(t=10, seed=2)
    np.savez(root / "clip.npz", video=video, audio=audio, fps=fps, sr=sr)
    np.savez(root / "ref.npz", video=_clip(t=10, seed=3)[0])
    Image.fromarray(video[0]).save(root / "first.png")
    yy, xx = np.mgrid[0:24, 0:32].astype(np.float32)
    smooth = np.stack([np.stack([(yy * 8 + t * 10) % 256, (xx * 5) % 256,
                                 np.full_like(yy, 64 + 8 * t)], axis=-1)
                       for t in range(8)]).astype(np.uint8)
    write_mjpeg_avi(str(root / "clip.avi"), smooth, fps=23.976, audio=audio[:8000],
                    sample_rate=sr)
    frames = root / "frames"
    frames.mkdir()
    for i, f in enumerate(smooth[:5]):
        Image.fromarray(f).save(frames / f"{i:03d}.png")
    with wave.open(str(frames / "audio.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(np.repeat(audio[:3200, None], 2, 1), -1, 1) * 32767)
                      .astype("<i2").tobytes())
    batch = root / "batch"
    batch.mkdir()
    for i in range(2):
        v, a, s, f = _clip(t=6, seed=10 + i)
        np.savez(batch / f"c{i}.npz", video=v, audio=a, fps=f, sr=s)
    np.savez(batch / "state.npz", step=np.int64(3))      # not a clip
    (batch / "notes.txt").write_text("not a clip")
    (batch / "prompts.json").write_text(json.dumps({"c0.npz": "a drum", "c1.npz": "waves"}))
    return root


CASES = {
    "npz": lambda r: [str(r / "clip.npz"), "--reference", str(r / "ref.npz"),
                      "--first_frame", str(r / "first.png"), "--prompt", "a drum"],
    "avi": lambda r: [str(r / "clip.avi")],
    "frames": lambda r: [str(r / "frames"), "--sample_rate", "16000"],
    "batch": lambda r: [str(r / "batch"), "--batch", "--model_name", "port-vs-jax",
                        "--prompts_json", str(r / "batch" / "prompts.json")],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_cli_matches_the_jax_script(case, clips, capsys, monkeypatch):
    argv = CASES[case](clips)
    port = _run(eval_cli.main, argv, capsys, monkeypatch, False)
    jax_ = _run(_jax_eval_main().main, argv, capsys, monkeypatch, True)
    assert port == jax_
    if case == "batch":
        table, payload = port.split("\n{", 1)
        assert "| port-vs-jax |" in table
        assert set(json.loads("{" + payload)) == {"desync"}
    else:
        report = json.loads(port)
        assert report["num_frames"] == {"npz": 10, "avi": 8, "frames": 5}[case]


def test_eval_cli_batch_report_matches_the_jax_script(clips, capsys, monkeypatch, hooks,
                                                       tmp_path):
    argv = CASES["batch"](clips) + ["--dnsmos_model", hooks["dnsmos"]]
    reports = []
    for main, jax_script in ((eval_cli.main, False), (_jax_eval_main().main, True)):
        out = tmp_path / f"{jax_script}.json"
        _run(main, argv + ["--out_json", str(out)], capsys, monkeypatch, jax_script)
        reports.append(json.loads(out.read_text()))
    assert reports[0] == reports[1]
    assert set(reports[0]["clips"]) == {"c0.npz", "c1.npz"}
    assert "dnsmos_ovrl" in reports[0]["aggregate"]


def test_eval_cli_flags_match_the_jax_script(monkeypatch):
    class Grabbed(Exception):
        pass

    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        raise Grabbed

    mod = _jax_eval_main()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Grabbed):
        mod.main()
    monkeypatch.undo()

    def flags(parser):
        return {s: (a.dest, a.default, a.choices, a.required, type(a))
                for a in parser._actions for s in a.option_strings}

    assert flags(eval_cli.build_parser()) == flags(grabbed["parser"])
    positional = [(a.dest, a.nargs) for a in eval_cli.build_parser()._actions
                  if not a.option_strings]
    assert positional == [(a.dest, a.nargs) for a in grabbed["parser"]._actions
                          if not a.option_strings]
