#!/usr/bin/env python3
"""Run one cell of the benchmark of ``mrcc_tpu_torch`` on the machine it is
started on, from the root of a checkout:

    python3 mrccbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``workloads/<cell>.json``), its configuration, its traffic mix
and its metrics are found by name (``harness/registry.py``); this file
knows none of them.  Set-up (imports, kernel builds or loads from the
checkout's build cache, inputs and weights from the seed, warm-up) counts
into ``setup_s``; the window then runs for ``--seconds``; with
``--trace 1`` the run reports the cell's per-layer metrics instead of its
end-to-end ones.  After the window the plain reference checks what the
timed path produced, and the run prints each number compared beside its
limit, on standard error and last in its result line, the last line of
standard output.

Exit codes: 0 with a result (``correct`` may be false); 2 without one when
the card or the cards the cell asks for are missing; 3 without one when
the process imported JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".mrccbench_cache"


def _fixed_caches():
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run in a checkout builds."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


_fixed_caches()
sys.path.insert(0, str(ROOT))

from mrccbench.harness import guard, registry  # noqa: E402
from mrccbench.harness.core import execute, make_run, result_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = registry.benchmark()
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = registry.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards, the machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    r = make_run(args.workload, args.seed, args.seconds, args.trace,
                 torch.device("cuda"), t0=T0, cell=cell)
    out = execute(r)
    line = result_line(r, out, bench)
    found = guard.forbidden_modules()
    if found:
        print(f"the run imported JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    units = sorted(out["context"]["window"]["unit_s"])
    print(f"setup_s {out['setup_s']!r} {out['setup_parts']}, "
          f"{line['attempted']} units in the window, unit s min "
          f"{units[0]:.4f} median {units[len(units) // 2]:.4f} max "
          f"{units[-1]:.4f}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}, worst at "
              f"{c['at']})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
