"""The port's training CLI (`cli/train.py`) on the CPU: its config reading
against `scripts/train.py`'s, a run of the low-resource recipe
(`configs/training/lora_low_resource.py`: fp8-stored weights, component
offload, AdamW8bit) from a tiny checkpoint written by
`save_pipeline_params` on npz clips, its resume, and the mesh refusal.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dualforce_tpu_torch.cli import train as cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.convert.lora_import import load_reference_lora
from dualforce_tpu_torch.engine import lora as lora_mod
from dualforce_tpu_torch.engine.optim import AdamW8bit
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_torch_pipeline import FakeTokenizer

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs" / "training").glob("*.py"))
RECIPE = str(REPO / "configs" / "training" / "lora_low_resource.py")


def _jax_script():
    spec = importlib.util.spec_from_file_location("_jax_train_script",
                                                  REPO / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_and_overrides_match_scripts_train(path):
    jax_script = _jax_script()
    overrides = ["trainer.lr=2e-4", "trainer.save_dir=/tmp/x y", "mesh={}",
                 "data.num_workers=1", "trainer.betas=(0.8, 0.9)", "trainer.remat=False",
                 "pipeline.weight_dtype=fp8", "trainer.logger=jsonl", "data.fps=24",
                 "pipeline.extra=[1, 'a']", "trainer.offload='component'"]
    got = cli.apply_overrides(cli.load_config(str(path)), overrides)
    want = jax_script.apply_overrides(jax_script.load_config(str(path)), overrides)
    assert got == want
    assert got["trainer"]["betas"] == (0.8, 0.9) and got["trainer"]["save_dir"] == "/tmp/x y"
    # every trainer key of the repo's recipes is a field of the port's TrainerConfig
    from dualforce_tpu_torch.engine.trainer import TrainerConfig

    TrainerConfig(**cli.load_config(str(path))["trainer"])


def test_mesh_over_devices_is_refused_before_reading(tmp_path):
    with pytest.raises(SystemExit, match="A7"):
        cli.run([str(REPO / "configs" / "training" / "lora_360p.py"), "--set",
                 f"pipeline.ckpt_path={tmp_path / 'absent'}", "--device", "cpu"])


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    cfg = tiny_test_config()
    lc.save_pipeline_params(init_pipeline_params(cfg, device="cpu", dtype=torch.float32,
                                                 seed=0), cfg, str(root / "ckpt"))
    rng = np.random.default_rng(0)
    items = []
    for i in range(3):
        np.savez(root / f"clip{i}.npz",
                 video=rng.integers(0, 256, (5, 40, 48, 3)).astype(np.uint8),
                 audio=rng.uniform(-0.3, 0.3, 10000).astype(np.float32), fps=24.0,
                 sr=48000)
        items.append({"video_path": f"clip{i}.npz", "caption": f"clip {i}"})
    with open(root / "metadata.json", "w") as f:
        json.dump(items, f)
    return root


def _argv(root, max_steps):
    return [RECIPE, "--device", "cpu", "--set", f"pipeline.ckpt_path={root / 'ckpt'}",
            f"data.metadata_path={root / 'metadata.json'}", "data.height=32",
            "data.width=32", "data.num_frames=5", "data.num_workers=1",
            f"trainer.save_dir={root / 'lora'}", f"trainer.max_steps={max_steps}",
            "trainer.expert_switch_interval=1", "trainer.grad_accum_steps=2",
            "trainer.warmup_steps=1", "trainer.lora_rank=2", "trainer.logger=jsonl",
            "trainer.log_interval=1"]


def test_low_resource_recipe_trains_and_resumes(tiny_data, capsys):
    root = tiny_data
    trainer = cli.run(_argv(root, 2), tokenizer=FakeTokenizer(), dtype=torch.float32)
    assert trainer.global_step == 2
    assert trainer.tcfg.offload == "component" and isinstance(trainer.optimizer, AdamW8bit)
    assert trainer.modules["video_dit"].blocks[0].self_attn.q.weight.dtype == \
        torch.float8_e4m3fn
    step2 = root / "lora" / "step-2"
    for name in ("state.pt", "meta.json", "lora_weights.npz", "lora_weights.json",
                 "lora_weights.pt", "lora_config.pt"):
        assert (step2 / name).is_file(), name
    lines = [json.loads(x) for x in (root / "lora" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
    cfg = lc.config_from_checkpoint(str(root / "ckpt"))
    npz, meta = lora_mod.load_lora(str(step2 / "lora_weights.npz"),
                                   cfg.bridge.interaction_layers())
    ref, ref_meta = load_reference_lora(str(step2), cfg)
    assert meta == {"alpha": 16.0, "rank": 2} and ref_meta == {"alpha": 16.0, "rank": 2}
    live = trainer.lora
    for mod, tree in live.items():
        for name, ab in tree.items():
            for p in ("a", "b"):
                assert torch.equal(npz[mod][name][p], ab[p].detach()), (mod, name, p)
                # the export leaves out factor pairs that are zero everywhere
                if ab["a"].any() or ab["b"].any():
                    assert torch.equal(ref[mod][name][p], ab[p].detach()), (mod, name, p)
    # step 0 trained expert 0 at the warmup's lr 0, step 1 expert 1 at lr > 0
    assert not any(ab["b"].any() for ab in live["video_dit"].values())
    assert all(ab["b"].any() for m in ("video_dit_2", "audio_dit", "bridge")
               for ab in live[m].values())
    capsys.readouterr()

    resumed = cli.run(_argv(root, 3), tokenizer=FakeTokenizer(), dtype=torch.float32)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.global_step == 3
    assert (root / "lora" / "step-3" / "lora_weights.pt").is_file()
    assert resumed.optimizer.count == 3
    after, _ = lora_mod.load_lora(str(root / "lora" / "step-3" / "lora_weights.npz"),
                                  cfg.bridge.interaction_layers())
    # step 2 trained expert 0 again, now at lr > 0
    assert all(after["video_dit"][n]["b"].any() for n in after["video_dit"])
    assert all(torch.equal(after["video_dit_2"][n]["b"], npz["video_dit_2"][n]["b"])
               for n in npz["video_dit_2"])
