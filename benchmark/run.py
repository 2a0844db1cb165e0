"""The benchmark of the PyTorch/CUDA port (`dualforce_tpu_torch`): one run of
one cell, in a fresh process, on the card this process is given.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the start of the process: imports, the kernels' build or load,
weights and inputs from the seed, the warm-up: one denoise step, or a
training cell's first steps, which its check follows), then a window of
`--seconds` (`--trace 1`: under `torch.profiler`, events kept in memory),
then the check against the plain reference. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`, each compared
number beside its limit, which also close standard error. Without a CUDA
card, or with fewer than the cell asks for, it prints no result and exits
2; if JAX or the JAX package is loaded after the window, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the port must not load, compared whole (the port's own
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dualforce_tpu")


def forbidden_modules():
    return sorted({name.partition(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; libraries
    kept from loading JAX on their own."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" where it cannot)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ""
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def judge(checks) -> bool:
    """A run is correct where every compared number is at most its limit."""
    return all(c["value"] <= c["limit"] for c in checks)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, t0: float = T0) -> int:
    """One run. `device`: the card is looked for unless a device is given
    (the CPU rehearsals of the tests)."""
    args = parse(argv)
    _environment()
    from benchmark import loader
    from benchmark import trace as tracing

    cell = loader.load_cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    entry = importlib.import_module(f"benchmark.entries.{cell.spec['entry']}")
    imported = time.perf_counter() - t0
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    run = entry.ENTRY(cell, args.seed, device)
    started = time.perf_counter() - t0
    run.setup()
    setup_s = time.perf_counter() - t0
    # set-up in its parts, printed on standard error
    parts = {"imports": imported, "cuda_init": started - imported, **getattr(run, "parts", {})}
    print("setup_parts " + " ".join(f"{k} {v:.4f}" for k, v in parts.items()),
          file=sys.stderr)

    tracer = tracing.Tracer() if args.trace else None
    if tracer is not None:
        with tracer.window():
            e2e = run.window(args.seconds, tracer)
    else:
        e2e = run.window(args.seconds)
    e2e["setup_s"] = setup_s
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(e2e["memory_peak_bytes"]),
           "power_limit": power_limit() if device.type == "cuda" else ""}
    result = {"attempted": e2e["steps"], "failed": 0}
    if tracer is not None:
        records = tracing.reduce(*tracer.events(), cell.kernel_classes)
        records.update(run.layer_records())
        dev.update(busy_s=records["busy_s"], window_s=records["window_s"])
        metrics = {}
        for m in cell.per_layer:
            value = m.read(records)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        breakdown = records["breakdown"]
        tracer = None
    else:
        missing = [m.name for m in cell.end_to_end if m.name not in e2e]
        if missing:
            raise loader.SpecError(f"entry {cell.spec['entry']} gives no {missing}")
        metrics = {m.name: {"value": e2e[m.name], "unit": m.unit} for m in cell.end_to_end}
        breakdown = None

    run.free()
    checks = run.check()
    # every number the check worked out, compared or not
    print("readings " + json.dumps(getattr(run, "readings", {})), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    correct = judge(checks)
    out = {"correct": correct, **result, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(out), flush=True)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
