"""Everything a run needs, found by the names in ``BENCHMARK.json``:

* ``workloads/<cell>.json``: the cell's configuration, traffic, chips,
  ``why`` and the limits of its correctness check;
* ``configs/<configuration>.json``: the configuration's sizes;
* ``traffic/<traffic>.json``: the traffic mix's parameters, whose
  ``kind`` names the generator ``traffic/<kind>.py``;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

Adding a cell, a mix or a metric adds files and ``BENCHMARK.json`` entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str):
    return _json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str):
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str):
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str):
    """The generator module of a traffic kind."""
    return _module(BENCH_DIR / "traffic" / f"{name}.py",
                   f"mrccbench_traffic_{name}")


def metric(name: str):
    """The reader module of a per-layer metric."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py",
                   "mrccbench_metric_" + name.replace(".", "_"))


def cell_metrics(bench, cell: str, section: str):
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those listing it, and those listing no cells."""
    return [m for m in bench[section]
            if cell in m.get("workloads", (cell,))]
