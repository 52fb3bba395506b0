"""What a run reads: BENCHMARK.json at the checkout's root, and the files of
the cell, its configuration and its traffic, found by their names:

  benchmark/workloads/<cell>.json   how the program serves the cell (kind,
                                    mode, kernels, warm-up, check limits)
  benchmark/configs/<config>.json   the model's sizes and settings
  benchmark/traffic/<traffic>.json  the traffic generator's parameters
  benchmark/metrics/<metric>.py     a per-layer metric's reader, `read(run)`

so that a cell, a configuration, a traffic mix or a metric is added as new
files and new entries, without an edit to a file that is there."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict  # the cell's entry in BENCHMARK.json's workloads
    cell: Dict  # benchmark/workloads/<name>.json
    config: Dict  # benchmark/configs/<config>.json
    traffic: Dict  # benchmark/traffic/<traffic>.json
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports


def _load(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names it, or,
    without the list, the end-to-end metric it moves is the cell's."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(cell: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else _load(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reports(m, cell, names)]
    return Cell(cell, entry, _load(HERE / "workloads" / f"{cell}.json"),
                _load(HERE / "configs" / f"{entry['config']}.json"),
                _load(HERE / "traffic" / f"{entry['traffic']}.json"), e2e, per_layer)


def reader(metric: str) -> Callable:
    """`read` of benchmark/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
