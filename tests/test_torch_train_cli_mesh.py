"""The training CLI under torchrun (`python -m torch.distributed.run
--nproc-per-node 2`) on `configs/training/lora_tiny.py --set mesh.cp=2` from
a tiny fp32 checkpoint and an npz clip on the CPU: the LoRA it exports
within 1e-5 of the one-process CLI's, `step-N/` and the metrics written by
rank 0 alone, and a resume at step 2 that reaches step 4's LoRA bit-equal
to the uninterrupted run (one clip: the data iterator starts again on a
resume, in both packages). Also the refusals that stay: component offload
with a mesh, and the server's mesh flags and fsdp over quantized towers
(ROADMAP A7c)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dualforce_tpu_torch.cli import train as cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.engine import lora as lora_mod
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_sp_mesh import REPO, ByteTokenizer, _free_port
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RECIPE = os.path.join(REPO, "configs", "training", "lora_tiny.py")
# within 1e-5: three AdamW updates at lr 1e-3 carry the fp32 sums' order
# (the cp sum) into the factors, most where a gradient is near 0
TOL = dict(rtol=1e-5, atol=1e-5)


def _sets(root):
    return ["--device", "cpu", "--set", f"pipeline.ckpt_path={root / 'ckpt'}",
            f"data.metadata_path={root / 'metadata.json'}", "data.num_workers=1",
            "trainer.save_interval=2", "trainer.max_steps=4", "trainer.lr=1e-3",
            "trainer.warmup_steps=1", "trainer.logger=jsonl", "trainer.remat=True"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli_mesh")
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(root / "ckpt"))
    rng = np.random.default_rng(0)
    np.savez(root / "clip0.npz", video=rng.integers(0, 256, (5, 40, 48, 3)).astype(np.uint8),
             audio=rng.uniform(-0.3, 0.3, 10000).astype(np.float32), fps=24.0, sr=48000)
    with open(root / "metadata.json", "w") as f:
        json.dump([{"video_path": "clip0.npz", "caption": "a clip"}], f)
    one = cli.run([RECIPE] + _sets(root) + ["mesh={}", f"trainer.save_dir={root / 'one'}"],
                  tokenizer=ByteTokenizer(), dtype=torch.float32)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         os.path.join(REPO, "tests", "test_torch_sp_mesh.py"), "--train-cli", str(root / "cp2"),
         "2", RECIPE] + _sets(root) + ["mesh.cp=2"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(root=root, cfg=cfg, one=one, log=proc.stdout)


def _lora(step_dir, cfg):
    return lora_mod.load_lora(str(step_dir / "lora_weights.npz"),
                              cfg.bridge.interaction_layers())[0]


def _flat(lora):
    return {f"{m}.{n}.{p}": t.detach() for m in lora for n in lora[m]
            for p, t in lora[m][n].items()}


def test_cp2_cli_lora_matches_one_process(runs):
    root, cfg = runs["root"], runs["cfg"]
    got, want = _flat(_lora(root / "cp2" / "a" / "step-4", cfg)), _flat(
        _lora(root / "one" / "step-4", cfg))
    assert set(got) == set(want) and len(got) > 20
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **TOL)
    assert any(w.abs().max() > 0 for k, w in want.items() if k.endswith(".b"))


def test_rank0_alone_writes_steps_and_metrics(runs):
    """Each `step-N/` holds one set of files, no other rank's state, and
    the metrics hold one line per step; the world joined over gloo."""
    a = runs["root"] / "cp2" / "a"
    assert sorted(d.name for d in a.iterdir() if d.is_dir()) == ["step-2", "step-4"]
    for step in ("step-2", "step-4"):
        assert sorted(x.name for x in (a / step).iterdir()) == [
            "lora_config.pt", "lora_weights.json", "lora_weights.npz", "lora_weights.pt",
            "meta.json", "state.pt"]
    lines = [json.loads(x) for x in (a / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    assert "rank 1 of 2" in runs["log"] and "backend gloo" in runs["log"]
    assert runs["log"].count("[done] trained to step 4") == 2


def test_resume_reaches_the_uninterrupted_lora(runs):
    root, cfg = runs["root"], runs["cfg"]
    assert "resumed from step 2" in runs["log"]
    got, want = _flat(_lora(root / "cp2" / "b" / "step-4", cfg)), _flat(
        _lora(root / "cp2" / "a" / "step-4", cfg))
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_component_offload_with_a_mesh_is_refused(tmp_path):
    """As JAX's trainer refuses it: before the (absent) checkpoint is read,
    from the CLI, and by the trainer itself."""
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

    recipe = os.path.join(REPO, "configs", "training", "lora_low_resource.py")
    with pytest.raises(ValueError, match="needs a world of 2 processes"):
        cli.run([recipe, "--device", "cpu", "--set", "mesh.cp=2",
                 f"pipeline.ckpt_path={tmp_path / 'absent'}"])

    class OneByOne:           # a mesh of two ranks, as the trainer reads it
        def size(self):
            return 2

    with pytest.raises(ValueError, match="single-chip low-resource regime"):
        LoRATrainer(tiny_test_config(), {}, TrainerConfig(offload="component"),
                    device="cpu", mesh=OneByOne())


def test_what_stays_refused_names_a7c(tmp_path, monkeypatch):
    """`serve --cp_size/--fsdp_size` and fsdp over quantized towers."""
    from dualforce_tpu_torch.cli import serve
    from dualforce_tpu_torch.nn import quantize_modules
    from dualforce_tpu_torch.parallel import mesh as pm
    from dualforce_tpu_torch.parallel import sharding

    for flag in ("--cp_size", "--fsdp_size"):
        with pytest.raises(SystemExit, match="A7c"):
            serve.build_server(serve.parse_args(["--ckpt_path", str(tmp_path), flag, "2"]))
    cfg = tiny_test_config(visual_layers=1, audio_layers=1)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                with_vaes=False, with_text=False, two_video_towers=False)

    class Fsdp2:              # this rank's view of an fsdp 2 mesh
        def get_local_rank(self, name):
            return 0

    monkeypatch.setattr(pm, "mesh_shape", lambda mesh: {"data": 1, "fsdp": 2, "cp": 1})
    with pytest.raises(ValueError, match="A7c"):
        sharding.shard_params({"video_dit": quantize_modules(mods["video_dit"], "int8")},
                              Fsdp2())
