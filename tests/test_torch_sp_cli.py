"""The base inference CLI under torchrun (`python -m torch.distributed.run
--nproc-per-node 2`) at `--cp_size 2` on a tiny fp32 checkpoint on the CPU,
against the same request through the CLI in one process: the clip within
1e-4 (a uint8 level where a value sits on a rounding edge), written by rank
0 alone. (The fsdp path's bits are held in test_torch_sp_world2.py and
test_torch_sp_world3.py, and through the CLI on the card by chip_smoke.py.)"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dualforce_tpu_torch.cli import inference_single as cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.utils.av_io import read_mjpeg_avi
from test_torch_sp_mesh import REPO, ByteTokenizer, _free_port
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REQUEST = ["--height", "32", "--width", "32", "--num_frames", "5", "--num_inference_steps",
           "2", "--cfg_scale", "5", "--sigma_shift", "5", "--seed", "7", "--negative_prompt",
           "blurry", "--prompt", "a cat playing piano", "--device", "cpu"]



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("sp_cli")
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(root / "ckpt"))
    png = root / "ref.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (40, 48, 3), np.uint8)).save(png)
    base = ["--ckpt_path", str(root / "ckpt"), "--ref_path", str(png)] + REQUEST
    out = {"one": cli.main(base + ["--output", str(root / "one.mp4")],
                           tokenizer=ByteTokenizer(), dtype=torch.float32)}
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for name, flags in (("cp2", ["--cp_size", "2"]),):
        d = root / name
        d.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
             "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
             os.path.join(REPO, "tests", "test_torch_sp_mesh.py"), "--cli"]
            + base + flags + ["--output", str(d / "clip.mp4")],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        out[name] = dict(np.load(d / "clip.npz"), log=proc.stdout, files=sorted(os.listdir(d)),
                         dir=str(d))
    out["one_path"] = str(root / "one.avi")
    return out


def test_torchrun_cli_matches_one_process(runs):
    got, want = runs["cp2"], runs["one"]
    for r in range(2):
        assert f"[dist] rank {r} of 2 on cpu, backend gloo" in got["log"]
    assert got["files"] == ["clip.avi", "clip.npz"]           # rank 0's clip alone
    assert got["video"].shape == want.video.shape == (5, 32, 32, 3)
    diff = np.abs(got["video"].astype(np.int16) - want.video.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3
    np.testing.assert_allclose(got["audio"], want.audio, rtol=1e-4, atol=1e-4)


def test_torchrun_cli_clip_reads_back(runs):
    """The clip rank 0 wrote reads back: its audio within 1e-4 of the
    one-process file's and its frames within half a level on average after
    the JPEG round trip."""
    one = read_mjpeg_avi(runs["one_path"])
    video, audio, sample_rate, fps = read_mjpeg_avi(os.path.join(runs["cp2"]["dir"],
                                                                 "clip.avi"))
    assert video.shape == one[0].shape and (sample_rate, fps) == (one[2], one[3])
    np.testing.assert_allclose(audio, one[1], atol=1e-4)
    assert np.abs(video.astype(np.float32) - one[0].astype(np.float32)).mean() < 0.5
