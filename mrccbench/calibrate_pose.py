#!/usr/bin/env python3
"""The readings that a pose training cell's correctness limits are set from,
at the cell's own size, in one process (``calibrate.py``'s path for the
``pose_steps`` kind, whose net, reference and faults differ):

    python3 mrccbench/calibrate_pose.py --workload <cell> --seeds 12 \\
        --controls 3 --out chiprun_out/calibrate-<cell>.jsonl

For each seed, the program's step through the cell's checked steps against
the plain reference (``sound``); on the first ``--controls`` seeds also the
control, the reference in TF32 put in the program's place (``tf32``), the
reference on features moved by 1e-7 relative (``moved``: the step's own
spread), the program with the second half of each batch's crops masked out
(``half_batch``), with ``update`` a no-op (``frozen``) and with the head's
eval-mode quaternion normalisation applied in training
(``unit_quaternion``).  Each reading is one JSON line, as ``calibrate.py``
writes them.  No window runs; nothing here is timed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mrccbench import calibrate  # noqa: E402
from mrccbench.harness import guard, registry  # noqa: E402
from mrccbench.harness.core import make_run  # noqa: E402
from mrccbench.reference import robotnet, train as ref_train  # noqa: E402

FAULTS = ("half_batch", "frozen", "unit_quaternion")


def seed_readings(r, controls):
    """``[(kind of reading, {number: (value, where)}, loss gap by step)]``
    of one seed."""
    kind = registry.kind(r.mix["kind"])
    s, program = calibrate.program_readings(kind, r)
    reference = kind.reference_readings(s)
    got = [("sound", program)]
    if controls:
        checked = s.batches[:s.mix["checked_steps"]]
        got.append(("tf32", kind.reference_readings(s, precision="tf32")))
        got.append(("moved", robotnet.readings(
            s.cfg, s.mix, s.weights, [calibrate._moved(b) for b in checked])))
        for fault in FAULTS:
            rf = make_run(r.name, r.seed, 0, 0, r.device, fault=fault,
                          cell=r.cell, config=r.config, mix=r.mix)
            got.append((fault, calibrate.program_readings(kind, rf)[1]))
    return [(name, ref_train.compare(g, reference),
             ref_train.loss_gaps(g, reference)) for name, g in got]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=calibrate.SEED0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for i in range(args.seeds):
            seed = args.seed0 + 7919 * i
            r = make_run(args.workload, seed, 0, 0, dev)
            t = time.perf_counter()
            for name, gaps, steps in seed_readings(r, i < args.controls):
                line = {"cell": args.workload, "seed": seed, "reading": name,
                        "seconds": time.perf_counter() - t,
                        "loss_by_step": steps,
                        **{k: {"value": v, "at": at}
                           for k, (v, at) in gaps.items()}}
                f.write(json.dumps(line) + "\n")
                f.flush()
                print(json.dumps(line), flush=True)
    found = guard.forbidden_modules()
    if found:
        print(f"imported {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
