"""Dataset statistics of a split JSON (port of ``scripts/data_stats.py``):
per split the sample count, the point-count distribution and the class
balance.

  python -m mrcc_tpu_torch.tools.data_stats splits.json
"""

import argparse
import json

import numpy as np

from ..data.dataset import load_sample


def main(argv=None):
    """Prints one line per non-empty split; returns the lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("splits", help="split JSON path")
    args = ap.parse_args(argv)

    with open(args.splits) as f:
        splits = json.load(f)
    lines = []
    for split, entries in splits.items():
        counts = []
        class_counts = np.zeros(3, np.int64)
        for e in entries:
            path = e["filepath"] if isinstance(e, dict) else e
            s = load_sample(path)
            counts.append(len(s["points"]))
            labs = np.asarray(s["labels"]).astype(np.int64)
            class_counts += np.bincount(np.clip(labs, 0, 2), minlength=3)
        if counts:
            lines.append(f"{split}: {len(entries)} samples, "
                         f"points avg={np.mean(counts):.0f} "
                         f"min={np.min(counts)} max={np.max(counts)}, "
                         f"class balance bg/arm/ee = "
                         f"{class_counts.tolist()}")
            print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
