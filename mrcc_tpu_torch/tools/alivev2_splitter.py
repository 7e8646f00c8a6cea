"""Build split JSONs from recorded alivev2 pickle folders (port of
``scripts/alivev2_splitter.py``): walks ``<infolder>/<position_light>/
labeled/*.pickle``, derives position / light / arm_point_count metadata and
splits train / val / test by ratio (shuffled with Python's ``random`` from
``--seed``, so the same folders give the same JSON) or temporally.

  python -m mrcc_tpu_torch.tools.alivev2_splitter --infolder alivev2/ \
      --out splits.json
"""

import argparse
import glob
import json
import os
import random

from ..data.dataset import load_sample


def create_info(filepath):
    """The split entry of one pickle: its path, position, light and
    arm point count."""
    instance_parts = filepath.split("/")[-3].split("_")
    data = load_sample(filepath)
    labels = data["labels"]
    return {
        "filepath": filepath,
        "position": ("_".join(instance_parts[:-1])
                     if len(instance_parts) > 1 else instance_parts[0]),
        "light": instance_parts[-1],
        "arm_point_count": int((labels == 1).sum()),
    }


def build_splits(infolder, ratio=(0.9, 0.05, 0.05), temporal=False, seed=1):
    """``{"train", "val", "test"}`` lists of :func:`create_info` entries,
    each position folder split by ``ratio`` (the last share takes the
    rest)."""
    random.seed(seed)
    class_folders = [cf for cf in glob.glob(os.path.join(infolder, "*"))
                     if os.path.isdir(cf)]
    out = {"train": [], "val": [], "test": []}
    for cf in class_folders:
        pickles = glob.glob(os.path.join(cf, "labeled", "*.pickle"))
        pickles = [p for p in pickles if not p.endswith("_eemask.pickle")
                   and not p.endswith("_semantic.pickle")]
        if temporal:
            pickles.sort(key=lambda x: int(
                os.path.basename(x).split(".")[0]))
        else:
            random.shuffle(pickles)
        bounds = [0]
        for r in ratio:
            bounds.append(bounds[-1] + int(r * len(pickles)))
        bounds[-1] = len(pickles)
        for split, lo, hi in zip(out, bounds[:-1], bounds[1:]):
            out[split].extend(create_info(p) for p in pickles[lo:hi])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Split alivev2")
    p.add_argument("--infolder", type=str, default="alivev2/")
    p.add_argument("--out", type=str, default="splits.json")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--temporal", action="store_true")
    p.add_argument("--ratio", nargs="+", type=float,
                   default=[0.9, 0.05, 0.05])
    args = p.parse_args(argv)
    splits = build_splits(args.infolder, tuple(args.ratio), args.temporal,
                          args.seed)
    with open(args.out, "w") as f:
        json.dump(splits, f, indent=4)
    print({k: len(v) for k, v in splits.items()})
    return splits


if __name__ == "__main__":
    main()
