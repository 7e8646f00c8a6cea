"""A run of one cell, as ``run.py`` drives it and the tests drive it on the
CPU: the :class:`Run` a traffic kind gets, and the result line made of its
outcome."""

from __future__ import annotations

import dataclasses
import subprocess
import time

from . import profiling, registry


@dataclasses.dataclass
class Run:
    """What a traffic kind gets: the cell and its files, the run's
    arguments, the process start and the device."""

    name: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: object
    fault: str = None


def make_run(name, seed, seconds, trace, device, t0=None, fault=None,
             cell=None, config=None, mix=None) -> Run:
    """A :class:`Run` of the cell ``name`` (``cell``, ``config`` and ``mix``
    replace its files where given)."""
    cell = cell or registry.workload(name)
    return Run(name=name, cell=cell,
               config=config or registry.config(cell["config"]),
               mix=mix or registry.traffic(cell["traffic"]), seed=int(seed),
               seconds=float(seconds), trace=bool(trace),
               t0=time.perf_counter() if t0 is None else t0, device=device,
               fault=fault)


def execute(r: Run):
    """Run the cell's traffic kind; returns its outcome."""
    return registry.kind(r.mix["kind"]).run(r)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(r: Run, out, bench) -> dict:
    """The result object of one run (``out``: the traffic kind's
    outcome)."""
    import torch

    section = "per_layer" if r.trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(bench, r.name, section):
        if r.trace:
            value = registry.metric(m["name"]).read(out["context"])
        else:
            value = out["end_to_end"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = r.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(r.cell["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if cuda:
        device["power_limit_w"] = _power_limit()
    line = {"correct": all(v <= lim for v, lim, _ in out["checks"].values())
            and out["failed"] == 0 and out["attempted"] > 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if r.trace:
        t = out["trace"]
        device["busy_s"] = profiling.busy_seconds(t)
        device["window_s"] = profiling.window_seconds(t)
        line["breakdown"] = {"device_ops": profiling.top_device_ops(t),
                             "idle_gaps": profiling.idle_gaps(t)}
    line["checks"] = {k: {"value": v, "limit": lim, "at": at}
                      for k, (v, lim, at) in out["checks"].items()}
    return line


