"""The harness on the CPU: whole runs of tiny cells through `run.main`, the
check against its control and its faults, the reference against the port
in fp32, the FLOP and bound arithmetic, the kernel classes, and the pieces
found by name.

Run from the root of the checkout: `python -m pytest benchmark/tests -q`.
"""

from __future__ import annotations

import ast
import functools
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

from benchmark import faults, flops, loader, run  # noqa: E402
from tiny import make_checkout, tiny_config, tiny_traffic  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
E2E = {"denoise": {"denoise_step_s", "peak_mem_gib", "setup_s"},
       "train": {"train_step_s", "peak_mem_gib", "setup_s"}}
# the compared numbers' limits in the tiny checkout, between what the tiny
# program reads (each pass's prediction and the gradients ~0.01) and what
# its controls read (fp8 storage: 0.05 and more)
TINY_LIMITS = {"pos_video_gap": 0.03, "pos_audio_gap": 0.03, "neg_video_gap": 0.03,
               "neg_audio_gap": 0.03, "loss_gap": 0.05, "grad_gap": 0.05, "change_gap": 0.05}


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    root = make_checkout(tmp_path / "checkout", TINY_LIMITS)
    monkeypatch.setattr(loader, "load_cell", functools.partial(
        loader.load_cell, bench_json=root / "BENCHMARK.json", bench_dir=root / "benchmark"))
    torch.set_num_threads(2)
    return root


def _run(capsys, cell, seed=2**31 + 7, seconds=0.0, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device=torch.device("cpu"))
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("cell,kind", [("tiny-denoise", "denoise"),
                                       ("tiny-denoise-fp8", "denoise"),
                                       ("tiny-train", "train")])
def test_run_is_correct(checkout, capsys, cell, kind):
    res, err = _run(capsys, cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == E2E[kind]
    assert list(res)[-1] == "checks"
    last = list(res["checks"])[-1]
    assert err.strip().splitlines()[-1].startswith(f"check {last} ")
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["count"] == 1 and "memory_peak_bytes" in res["device"]


@pytest.mark.parametrize("cell", ["tiny-denoise-fp8", "tiny-train"])
def test_traced_run(checkout, capsys, cell):
    """A traced run reports per-layer metrics only; with no device trace (the
    CPU) the readers of device time find nothing and are left out, and the
    trainer's spans are read."""
    res, _ = _run(capsys, cell, trace=1)
    assert res["correct"], res["checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    want = {"encode_s.train", "loss_backward_s.train", "optimizer_s.train"} \
        if cell == "tiny-train" else set()
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("cell,fault", [(c, f) for c, kind in (("tiny-denoise", "denoise"),
                                                                ("tiny-denoise-fp8", "denoise"),
                                                                ("tiny-train", "train"))
                                        for f in faults.FAULTS[kind]])
def test_planted_fault_is_not_correct(checkout, capsys, cell, fault):
    """Each fault the cell can have, planted under the timed path, makes the
    run not correct (the harness's look for a card skipped)."""
    kind = "train" if "train" in cell else "denoise"
    with faults.planted(kind, fault):
        res, _ = _run(capsys, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,control", [("tiny-denoise", "fp8"), ("tiny-denoise-fp8", "int4"),
                                          ("tiny-train", "fp8")])
def test_control_is_not_correct(checkout, cell, control):
    """The control, the program with its next lower precision switched on,
    reads above a limit on three seeds."""
    from benchmark import calibrate

    for rec in calibrate.readings(cell, [11, 12, 2**31 + 13], control=control,
                                  device=torch.device("cpu")):
        assert any(rec[k] > TINY_LIMITS[k] for k in TINY_LIMITS if k in rec), rec


@pytest.mark.parametrize("weight_dtype,cache", [("bf16", 1), ("fp8", 3)])
def test_denoise_reference_matches_port_in_fp32(weight_dtype, cache):
    """The plain reference and the port agree in fp32 on the CPU (weights
    fp32, or fp8-stored and computed in fp32), step by step with the cached
    negative: the reference follows the published equations the port runs."""
    from benchmark import weights
    from benchmark.entries.denoise import port_config, port_modules
    from benchmark.reference import layout, schedule
    from benchmark.reference import mova as ref
    from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
    from dualforce_tpu_torch.diffusion.sampler import build_plan, denoise_steps, resident_passes
    from dualforce_tpu_torch.diffusion.step import make_rope_pack

    torch.manual_seed(0)
    cpu = torch.device("cpu")
    cfg = dict(tiny_config(weight_dtype), video_fps=24.0)
    tr = tiny_traffic("t", cache)
    geo = flops.geometry(cfg, tr)
    dtype = torch.float32 if weight_dtype == "bf16" else torch.bfloat16
    tensors = weights.draw(layout.denoise_modules(cfg), 7, cpu, dtype=dtype)
    mods = port_modules(cfg, tensors, copy=True)
    if weight_dtype == "fp8":       # compute in fp32 on the fp8-stored values
        for m in mods.values():
            m.float()
    pc = port_config(cfg)
    sched = FlowMatchPairScheduler(pc.scheduler)
    sched.set_timesteps(tr["num_inference_steps"], shift=tr["sigma_shift"])
    plan = build_plan(sched, pc.boundary_ratio)
    f, lh, lw = geo["latent"]
    pack = make_rope_pack(pc.video_dit, pc.audio_dit, pc.bridge, (f, lh // 2, lw // 2),
                          geo["audio"], 24.0, cpu)
    timesteps, sigmas, boundary = schedule.plan(cfg, tr["num_inference_steps"], 5.0, 0.9)
    assert boundary == plan.boundary_step
    assert abs(timesteps - plan.pair_timesteps[:, 0]).max() == 0
    assert abs(sigmas - plan.sigmas_visual).max() == 0
    lat = torch.randn(1, 16, f, lh, lw)
    alat = torch.randn(1, cfg["audio_dit"]["in_dim"], geo["audio_t"])
    cond = torch.randn(1, 20, f, lh, lw)
    ctx_pos, ctx_neg = torch.randn(1, 16, 64), torch.randn(1, 16, 64)
    p = {m: ref.Params(m, tensors[m], ref.fp8_storage if weight_dtype == "fp8" else None)
         for m in tensors}
    neg, src = None, None
    for i in range(plan.num_steps):
        expert = "video_dit" if i < plan.boundary_step else "video_dit_2"
        if i == plan.boundary_step:
            neg = None
        refresh = neg is None or cache == 1 or i % cache == 0
        if refresh:
            src = (lat[0], alat[0], float(timesteps[i]), float(timesteps[i]))
        run_ = resident_passes(mods[expert], mods["audio_dit"], mods["bridge"], 24.0,
                               torch.float32, pack, "auto")
        lat2, alat2, neg = denoise_steps(run_, lat, cond, alat, ctx_pos, ctx_neg, plan, i,
                                         i + 1, cfg_scale=5.0, cfg_cache_interval=cache,
                                         neg_cache=neg)
        dv, da, (nv, na), _ = ref.step_update(cfg, p[expert], p["audio_dit"], p["bridge"],
                                           lat[0], alat[0], cond[0], ctx_pos[0], ctx_neg[0],
                                           float(timesteps[i]), float(timesteps[i]),
                                           float(sigmas[i + 1] - sigmas[i]),
                                           float(sigmas[i + 1] - sigmas[i]), 5.0,
                                           None if refresh else src)
        assert ref.frame_gap((lat2 - lat)[0], dv) < 2e-5, i
        assert ref.rel_l2((alat2 - alat)[0], da) < 2e-5, i
        assert ref.frame_gap(neg[0][0], nv) < 2e-5, i
        assert ref.rel_l2(neg[1][0], na) < 2e-5, i
        lat, alat = lat2, alat2


def test_train_reference_matches_port_in_fp32(checkout, capsys, monkeypatch):
    """The plain training reference (encoders, draws, loss, gradients,
    clipping, AdamW, schedule) and the port's trainer agree in fp32 on the
    CPU: a tiny run with every module in fp32 reads gaps of round-off."""
    from benchmark.entries import train as entry

    path = checkout / "benchmark" / "traffic" / "tiny-train.json"
    tr = json.loads(path.read_text())
    path.write_text(json.dumps(dict(tr, compute_dtype="fp32")))
    towers, encoders = entry.port_modules, entry.port_encoders
    monkeypatch.setattr(entry, "port_modules",
                        lambda *a, **k: {n: m.float() for n, m in towers(*a, **k).items()})
    monkeypatch.setattr(entry, "port_encoders",
                        lambda *a, **k: {n: m.float() for n, m in encoders(*a, **k).items()})
    res, _ = _run(capsys, "tiny-train")
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert res["checks"][name]["value"] < 1e-4, res["checks"]


def test_flops_match_the_hand_worked_numbers():
    """A 360p video layer-pass: linears 2 * 43,120 * 298.9 M and
    self-attention 4 * 43,120^2 * 5120, about 64 TFLOP; B1 at 720p (40 heads,
    176,400 tokens) bound by its operations at 644.36 ms."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "mova-360p.json").read_text())
    tr = json.loads((ROOT / "benchmark" / "traffic" / "t2va-352x640x193.json").read_text())
    geo = flops.geometry(dict(cfg, video_fps=24.0), tr)
    assert (geo["video"], geo["audio"], geo["text"]) == (43120, 403, 512)
    assert flops.video_layer_flops(cfg, geo) == pytest.approx(64.0e12, rel=0.01)
    t, binds = flops.attention_fwd_bound(flops.AttnCall("video_self", 40, 176400, 176400))
    assert binds == "operations" and t * 1e3 == pytest.approx(644.36, abs=0.01)
    # the training step holds the pass and more: backward attention at 2.5x
    tr = json.loads((ROOT / "benchmark" / "traffic" / "lora-352x640x49.json").read_text())
    geo = flops.geometry(dict(cfg, video_fps=24.0), tr)
    assert (geo["video"], geo["audio"]) == (11440, 103)
    assert 2 * flops.pass_flops(cfg, geo) < flops.train_step_flops(cfg, geo, 16) \
        < 3.5 * flops.pass_flops(cfg, geo)


def test_kernel_classes_sort_recorded_names():
    from benchmark import trace

    recorded = json.loads((HERE / "kernel_names.json").read_text())["names"]
    classes = loader.kernel_classes()
    assert [trace.classify(n, classes) for n, _ in recorded] == [c for _, c in recorded]


def test_trace_reduction_leaves_out_annotations_and_counts_gaps():
    from benchmark import trace

    classes = loader.kernel_classes()
    device = [("nvjet_tst_1", 10, 20), ("void (anonymous namespace)::flash_fwd_kernel<false>",
                                        15, 30), ("x", 50, 60)]
    host = [("aten::mm", 30, 45), ("cudaStreamSynchronize", 40, 52)]
    rec = trace.reduce((0, 100), device, host, classes)
    assert rec["busy_s"] == pytest.approx(30e-9)
    assert rec["device_s"] == pytest.approx({"gemm": 10e-9, "attention": 15e-9,
                                             "other": 10e-9})
    assert dict(rec["breakdown"]["idle_gaps"]) == pytest.approx(
        {"python": 50e-9, "aten::mm": 20e-9})


def test_loader_finds_every_piece_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert CELLS
    for name in CELLS:
        cell = loader.load_cell(name)
        assert cell.chips == 1 and cell.spec["name"] == name
        assert cell.config["name"] == cell.spec["config"]
        assert cell.traffic["name"] == cell.spec["traffic"]
        assert {m.name for m in cell.end_to_end} == E2E[cell.spec["entry"]]
        assert all(callable(m.read) and m.moves for m in cell.per_layer)
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def _files(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_adding_files_adds_a_cell_and_a_metric(tmp_path):
    """A new cell and a new per-layer metric come from new files and new
    entries of BENCHMARK.json: no file of the harness is edited."""
    root = tmp_path / "co"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _files(root / "benchmark")
    tr = json.loads((root / "benchmark/traffic/t2va-352x640x193.json").read_text())
    tr.update(name="t2va-352x640x193-sage", attn_impl="sage", quantize="int8")
    (root / "benchmark/traffic/t2va-352x640x193-sage.json").write_text(json.dumps(tr))
    spec = json.loads((root / "benchmark/workloads/mova360p-t2va.json").read_text())
    spec.update(name="mova360p-t2va-sage-int8", traffic=tr["name"])
    (root / "benchmark/workloads/mova360p-t2va-sage-int8.json").write_text(json.dumps(spec))
    (root / "benchmark/metrics/steps.denoise.py").write_text(
        'LAYER = "device"\nMOVES = "denoise_step_s"\n\n\ndef read(rec):\n'
        '    return rec["steps"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": spec["name"], "config": "mova-360p",
                               "traffic": tr["name"], "chips": 1, "why": "sage"})
    for m in bench["end_to_end"]:
        if "denoise_step_s" == m["name"]:
            m["workloads"].append(spec["name"])
    bench["per_layer"].append({"name": "steps.denoise", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "denoise_step_s", "workloads": [spec["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = loader.load_cell(spec["name"], bench_json=root / "BENCHMARK.json",
                            bench_dir=root / "benchmark")
    assert cell.traffic["attn_impl"] == "sage"
    assert [m.name for m in cell.per_layer] == ["steps.denoise"]
    assert cell.per_layer[0].read({"steps": 3}) == 3
    after = _files(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_loader_refuses_a_metric_without_moves(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "gemm_ms.denoise":
            del m["moves"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(loader.SpecError, match="moves"):
        loader.load_cell("mova360p-t2va", bench_json=path)


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dualforce_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dualforce_tpu.models", sys)
    assert run.forbidden_modules() == ["dualforce_tpu"]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run of each entry, in a fresh interpreter, loads no
    module whose top-level name is jax, jaxlib, flax or dualforce_tpu."""
    code = f"""
import functools, sys, torch
sys.path[:0] = [{str(ROOT)!r}, {str(HERE)!r}]
from pathlib import Path
from benchmark import loader, run
from tiny import make_checkout
root = make_checkout(Path({str(tmp_path)!r}) / "co")
loader.load_cell = functools.partial(loader.load_cell, bench_json=root / "BENCHMARK.json",
                                     bench_dir=root / "benchmark")
torch.set_num_threads(2)
for cell in ("tiny-denoise", "tiny-train"):
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "0", "--trace", "0"],
                    device=torch.device("cpu")) == 0
print(sorted({{m.partition(".")[0] for m in sys.modules}}))
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))
    assert "dualforce_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = sorted(p.stem for p in (ROOT / "benchmark" / "reference").glob("*.py"))
    proc = _python("import sys; sys.path.insert(0, '.')\n"
                   + "".join(f"import benchmark.reference.{n}\n" for n in names)
                   + "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & {"dualforce_tpu_torch", "dualforce_tpu", "jax", "jaxlib", "flax"}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert all(m.partition(".")[0] in ("benchmark", "torch", "numpy", "math",
                                                   "contextlib", "typing", "__future__")
                           for m in mods), (path.name, mods)


def test_without_a_card_a_run_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mova360p-t2va",
                           "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
