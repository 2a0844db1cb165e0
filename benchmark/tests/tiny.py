"""A tiny checkout for the benchmark's CPU tests: a copy of `benchmark/` with
a tiny MOVA configuration (head_dim 128, widths 256, the cells' depth
pattern, small encoders), traffic and cells of its own, and a
`BENCHMARK.json` naming them, so a whole run goes through the harness on
the CPU in seconds."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_config(weight_dtype: str = "bf16") -> dict:
    cfg = json.loads((BENCH / "configs" / "mova-360p.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["name"] = f"tiny-{weight_dtype}"
    cfg["weight_dtype"] = weight_dtype
    cfg["video_dit"].update(dim=256, ffn_dim=512, text_dim=64, freq_dim=32, num_heads=2)
    cfg["audio_dit"].update(dim=256, ffn_dim=512, text_dim=64, freq_dim=32, num_heads=2)
    cfg["bridge"].update(visual_hidden_dim=256, audio_hidden_dim=256)
    cfg["text_encoder"].update(vocab_size=512, d_model=64, d_kv=16, d_ff=64, num_layers=2,
                               num_heads=2)
    cfg["video_vae"].update(base_dim=8)
    cfg["audio_vae"].update(encoder_dim=4)
    return cfg


def tiny_traffic(name: str, cache: int) -> dict:
    return {"name": name, "why": "tiny", "height": 32, "width": 64, "num_frames": 9,
            "video_fps": 24.0, "num_inference_steps": 6, "sigma_shift": 5.0,
            "cfg_scale": 5.0, "cfg_cache_interval": cache, "attn_impl": "auto",
            "quantize": "none", "compute_dtype": "bf16", "start_step": 0, "text_tokens": 16,
            "prompt_tokens": [4, 12], "negative_tokens": [1, 4]}


def tiny_train_traffic(name: str) -> dict:
    tr = json.loads((BENCH / "traffic" / "lora-352x640x49.json").read_text())
    tr.update(name=name, why="tiny", height=32, width=64, num_frames=9, text_tokens=16,
              prompt_tokens=[4, 12])
    return tr


# (cell, weight dtype, traffic, the cell file it copies)
CELLS = (("tiny-denoise", "bf16", "tiny-1", "mova360p-t2va"),
         ("tiny-denoise-fp8", "fp8", "tiny-3", "mova360p-t2va"),
         ("tiny-train", "bf16", "tiny-train", "mova360p-lora-train"))


def make_checkout(root: Path, limits=None) -> Path:
    """`root` laid out as a checkout holding the tiny cells of `CELLS`:
    `tiny-denoise` (bf16, two passes a step), `tiny-denoise-fp8` (fp8
    storage, the negative cached for 3 steps) and `tiny-train` (LoRA
    training). `limits`: {name: limit} over the cells' own. Returns root."""
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    traffic = {"tiny-1": tiny_traffic("tiny-1", 1), "tiny-3": tiny_traffic("tiny-3", 3),
               "tiny-train": tiny_train_traffic("tiny-train")}
    cells = []
    for name, dtype, tr_name, like in CELLS:
        cfg = tiny_config(dtype)
        (root / "benchmark" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (root / "benchmark" / "traffic" / f"{tr_name}.json").write_text(
            json.dumps(traffic[tr_name]))
        spec = json.loads((BENCH / "workloads" / f"{like}.json").read_text())
        spec.update(name=name, config=cfg["name"], traffic=tr_name)
        # 24 video and 19 audio tokens: every attention takes plain attention
        for plan in spec["launch_plan"].values():
            if isinstance(plan, dict):
                plan.update({k: 0 for k in plan})
        spec["check"]["limits"] = {k: (limits or {}).get(k, 0.05)
                                   for k in spec["check"]["limits"]}
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(spec))
        cells.append({"name": name, "config": cfg["name"], "traffic": tr_name, "chips": 1,
                      "why": "tiny"})
        if all(c["name"] != cfg["name"] for c in bench["configs"]):
            bench["configs"].append({"name": cfg["name"], "source": "tiny",
                                     "file": f"benchmark/configs/{cfg['name']}.json",
                                     "reduced": [], "why": "tiny"})
    bench["workloads"] += cells
    have = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    bench["end_to_end"] += [m for m in TRAIN_END_TO_END if m["name"] not in have]
    bench["per_layer"] += [m for m in TRAIN_PER_LAYER if m["name"] not in have]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" not in m:
            continue
        train = "train_step_s" in (m["name"], m.get("moves"))
        m["workloads"] = m["workloads"] + [c["name"] for c in cells
                                           if ("train" in c["name"]) == train]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _per_layer(name: str, unit: str, better: str, source: str, layer: str) -> dict:
    return {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
            "moves": "train_step_s", "workloads": []}


# the training cell's metrics, for a BENCHMARK.json that does not hold them
TRAIN_END_TO_END = [{"name": "train_step_s", "unit": "s", "better": "lower", "bound": 0.05,
                     "source": "host_clock", "workloads": []}]
TRAIN_PER_LAYER = [
    _per_layer("mfu.train", "%", "higher", "device_trace", "model step: towers, bridge"),
    _per_layer("attn_bwd_roofline.train", "%", "higher", "device_trace", "attention kernels"),
    _per_layer("idle_share.train", "%", "lower", "device_trace", "device"),
    _per_layer("optimizer_s.train", "s", "lower", "program_span", "trainer, optimizer"),
    _per_layer("encode_s.train", "s", "lower", "program_span", "encoders"),
    _per_layer("loss_backward_s.train", "s", "lower", "program_span", "training step")]
