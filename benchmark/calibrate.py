"""Readings for a cell's check limits, on the card, in one process: the
compared numbers of the program over a set of seeds, of the control (the
program with a lower precision of its own switched on: `--control` "fp8"
weight storage, as `--weight_dtype fp8`, or "int8" / "int4" linears, as
`MOVAPipeline(quantize=...)`), or of the program with a fault planted
(`--fault`, `benchmark.faults`). The benchmark's runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control fp8 | --fault altered] [--seconds 0]

Prints one JSON line per seed: the variant, the seed, the window's steps
and kernel launches, and every number the check works out, compared or
not. `--seconds 0` runs the shortest window the cell
allows (one step, or one cache cycle).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell_name: str, seeds, control=None, fault=None, seconds: float = 0.0,
             device=None):
    import importlib

    import torch

    from benchmark import faults, loader, run as harness

    cell = loader.load_cell(cell_name)
    device = device or torch.device("cuda", 0)
    kind = cell.spec["entry"]
    entry = importlib.import_module(f"benchmark.entries.{kind}")
    for seed in seeds:
        t0 = time.perf_counter()
        with faults.planted(kind, fault) if fault else contextlib.nullcontext():
            run = entry.ENTRY(cell, seed, device, control=control)
            run.setup()
            e2e = run.window(seconds)
            run.free()
            compared = run.check()
            checks = {c["name"]: c["value"] for c in compared}
            checks.update(run.readings)
            correct = (harness.judge(compared)
                       if all(c["limit"] is not None for c in compared) else None)
        launches = {k: v for k, v in run.launches.items() if v}
        parts = getattr(run, "parts", {})
        del run
        yield {"cell": cell_name, "seed": seed, "variant": control or fault or "program",
               "steps": e2e["steps"], "seconds": time.perf_counter() - t0,
               "launches": launches, "setup_parts": parts,
               "correct": correct, **checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    for rec in readings(args.workload, seeds, args.control, args.fault, args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
