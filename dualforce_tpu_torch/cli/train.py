"""LoRA training from a MOVA checkpoint (counterpart of `scripts/train.py`):

    python -m dualforce_tpu_torch.cli.train configs/training/lora_low_resource.py \\
        --set pipeline.ckpt_path=CKPT data.metadata_path=clips/metadata.json \\
        trainer.save_dir=out/lora trainer.max_steps=100 [--device cpu]

The config is a Python file defining a dict `config` with `pipeline`
(`ckpt_path`, optional `weight_dtype="fp8"`), `mesh`, `data` and `trainer`
(`TrainerConfig`'s fields) sections; `--set dotted.key=value` overrides an
entry, the value read as a Python literal where it parses as one and as a
string otherwise. It runs on the CUDA card unless `--device cpu` asks for
the CPU. Under `trainer.offload="component"` the modules are loaded into
page-locked host memory and staged per phase. A mesh over more than one
device (`lora_360p.py`'s fsdp 2 x cp 4) exits before anything is read: it
needs data and sequence parallelism, not ported yet (ROADMAP A7); `--set
mesh={}` runs such a recipe on one device. Each `step-N/` under
`trainer.save_dir` holds `state.pt` (resumed from on the next run),
`lora_weights.npz` (+ `.json`, the JAX package's format) and
`lora_weights.pt` + `lora_config.pt` (the reference trainer's). Importing
this module loads no model code, so `--help` is quick.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import math
from typing import Optional, Sequence


def load_config(path: str) -> dict:
    """The dict `config` of a Python config file."""
    spec = importlib.util.spec_from_file_location("train_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod.config


def apply_overrides(cfg: dict, overrides: Optional[Sequence[str]]) -> dict:
    """Set each `dotted.key=value` in `cfg` (in place; returned): the value
    as a Python literal (`ast.literal_eval`) where it parses, else the
    string."""
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        try:
            node[parts[-1]] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            node[parts[-1]] = value
    return cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dualforce_tpu_torch.cli.train",
                                description="Train a LoRA on video+audio clips.")
    p.add_argument("config")
    p.add_argument("--set", nargs="*", dest="overrides",
                   help="dotted config overrides, e.g. trainer.lr=2e-4")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain PyTorch path)")
    return p


def refuse_unported(cfg: dict) -> None:
    """Exit, naming the ROADMAP item, where the config asks for a part that
    is not ported yet."""
    mesh = cfg.get("mesh") or {}
    if math.prod(int(v) for v in mesh.values()) > 1:
        raise SystemExit(f"mesh {mesh} spans more than one device: data and sequence "
                         "parallelism are not ported yet (ROADMAP A7); --set mesh={} "
                         "trains on one")


def run(argv: Optional[Sequence[str]] = None, tokenizer=None, dtype=None):
    """Parse `argv`, load the checkpoint, the clips and the trainer, and
    train to `trainer.max_steps` (resuming from the latest `step-N`).
    tokenizer: the checkpoint's (`load_tokenizer`) unless given; dtype: the
    weights' dtype where `pipeline.weight_dtype` is not "fp8", and the
    compute dtype (bf16 unless given). Returns the `LoRATrainer`."""
    args = build_parser().parse_args(argv)
    cfg_dict = apply_overrides(load_config(args.config), args.overrides)
    refuse_unported(cfg_dict)
    import torch

    from dualforce_tpu_torch import resolve_device
    from dualforce_tpu_torch.convert.load_checkpoint import (config_from_checkpoint,
                                                             load_pipeline_params,
                                                             load_tokenizer)
    from dualforce_tpu_torch.data.dataset import VideoAudioDataset, make_data_iter
    from dualforce_tpu_torch.engine.trainer import LoRATrainer, TrainerConfig

    device = resolve_device(args.device)
    dtype = dtype or torch.bfloat16
    pipeline, data = cfg_dict["pipeline"], cfg_dict["data"]
    trainer_cfg = dict(cfg_dict.get("trainer", {}))
    trainer_cfg.setdefault("compute_dtype", dtype)
    tcfg = TrainerConfig(**trainer_cfg)
    ckpt = pipeline["ckpt_path"]
    cfg = config_from_checkpoint(ckpt)
    wdtype = torch.float8_e4m3fn if pipeline.get("weight_dtype") == "fp8" else dtype
    modules = load_pipeline_params(ckpt, cfg, dtype=wdtype, device=device,
                                   host=tcfg.offload == "component")
    dataset = VideoAudioDataset(
        data["metadata_path"], height=data.get("height", 352), width=data.get("width", 640),
        num_frames=data.get("num_frames", 49), fps=data.get("fps", 24.0),
        sample_rate=cfg.audio_vae.sample_rate)
    batches = make_data_iter(dataset, tokenizer or load_tokenizer(ckpt),
                             batch_size=data.get("batch_size", 1),
                             num_workers=data.get("num_workers", 2))
    trainer = LoRATrainer(cfg, modules, tcfg, device=device)
    try:
        step = trainer.train(batches)
    finally:
        batches.close()
    print(f"[done] trained to step {step}; checkpoints in {tcfg.save_dir}", flush=True)
    return trainer


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
