"""Finds the benchmark's pieces by name and checks them.

`BENCHMARK.json` (at the root of the checkout) lists the configurations, the
cells and the metrics. Each piece sits in a file of its own under
`benchmark/`, found by its name:

- `configs/<config>.json`: a configuration as it is run;
- `traffic/<traffic>.json`: a traffic mix's parameters;
- `workloads/<cell>.json`: a cell: its configuration, traffic, entry kind
  (`entries/<entry>.py`), launch plan and the limits of its check;
- `metrics/<metric>.py`: a per-layer metric's reader, with its `LAYER`
  and the end-to-end metric it `MOVES`;
- `kernel_classes/<class>.json`: kernel-name patterns that sort device time.

A cell or a metric is added by adding files (and its `BENCHMARK.json`
entry); no file that is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A piece of the benchmark is missing or malformed."""


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"bad {kind} name {name!r}")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(path.parents[1])}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str] = None          # per-layer metrics
    layer: Optional[str] = None
    workloads: Optional[List[str]] = None
    bound: Optional[float] = None         # end-to-end metrics
    read: object = None                   # the reader, per-layer metrics

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict                       # the workload file
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    kernel_classes: Dict[str, List[str]] = field(default_factory=dict)


def load_metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module `metrics/<name>.py`: `LAYER`, `MOVES` and `read(records)`."""
    path = bench_dir / "metrics" / f"{_name('metric', name)}.py"
    if not path.is_file():
        raise SpecError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("LAYER", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise SpecError(f"metrics/{name}.py lacks {attr}")
    return mod


def kernel_classes(bench_dir: Path = BENCH_DIR) -> Dict[str, List[str]]:
    """{class: [lower-case substrings of kernel names]} from
    `kernel_classes/*.json`, in name order."""
    out = {}
    for path in sorted((bench_dir / "kernel_classes").glob("*.json")):
        spec = _json(path)
        out[_name("kernel class", path.stem)] = [p.lower() for p in spec["patterns"]]
    return out


def load_cell(cell_name: str, bench_json: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `cell_name` of `BENCHMARK.json` with its files read and its
    metrics' readers loaded. Raises SpecError on anything missing."""
    bench = _json(bench_json or (bench_dir.parent / "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in entries:
        raise SpecError(f"no cell {cell_name!r} in BENCHMARK.json")
    entry = entries[cell_name]
    spec = _json(bench_dir / "workloads" / f"{_name('cell', cell_name)}.json")
    for key in ("config", "traffic", "chips"):
        if spec.get(key) != entry.get(key):
            raise SpecError(f"workloads/{cell_name}.json has {key} {spec.get(key)!r}, "
                            f"BENCHMARK.json {entry.get(key)!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs.get(entry["config"])
    if cfg_entry is None:
        raise SpecError(f"no configuration {entry['config']!r} in BENCHMARK.json")
    config = _json(bench_dir.parent / cfg_entry["file"])
    traffic = _json(bench_dir / "traffic" / f"{_name('traffic', entry['traffic'])}.json")
    cell = Cell(cell_name, int(entry["chips"]), config, traffic, spec,
                kernel_classes=kernel_classes(bench_dir))
    for m in bench["end_to_end"]:
        metric = Metric(m["name"], m["unit"], m["better"], m["source"], bound=m["bound"],
                        workloads=m.get("workloads"))
        if metric.applies(cell_name):
            cell.end_to_end.append(metric)
    reported = {m.name for m in cell.end_to_end}
    for m in bench["per_layer"]:
        metric = Metric(m["name"], m["unit"], m["better"], m["source"], moves=m.get("moves"),
                        layer=m.get("layer"), workloads=m.get("workloads"))
        if not metric.applies(cell_name):
            continue
        if not metric.moves:
            raise SpecError(f"per-layer metric {metric.name} names no end-to-end metric "
                            "it moves")
        if metric.moves not in reported:
            raise SpecError(f"{metric.name} moves {metric.moves}, which cell {cell_name} "
                            "does not report")
        reader = load_metric_reader(metric.name, bench_dir)
        if reader.MOVES != metric.moves or reader.LAYER != metric.layer:
            raise SpecError(f"metrics/{metric.name}.py says layer {reader.LAYER!r} moves "
                            f"{reader.MOVES!r}; BENCHMARK.json {metric.layer!r} moves "
                            f"{metric.moves!r}")
        metric.read = reader.read
        cell.per_layer.append(metric)
    return cell
