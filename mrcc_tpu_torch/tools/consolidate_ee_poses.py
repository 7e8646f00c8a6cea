"""Collect every labeled pickle's EE pose into one pose list (port of
``scripts/consolidate_ee_poses.py``; appends to an existing output
pickle, as the script does).

  python -m mrcc_tpu_torch.tools.consolidate_ee_poses --infolder alive/ \
      --out out.pickle
"""

import argparse
import glob
import os
import pickle

from ..data.dataset import load_sample


def main(argv=None):
    """Returns the pose list written to ``--out``."""
    p = argparse.ArgumentParser(description="Consolidate EE poses")
    p.add_argument("--infolder", type=str, default="alive/")
    p.add_argument("--out", type=str, default="out.pickle")
    args = p.parse_args(argv)

    ee_poses = []
    if os.path.isfile(args.out):
        with open(args.out, "rb") as f:
            ee_poses = pickle.load(f, encoding="bytes")
    pickles = sorted(glob.glob(os.path.join(args.infolder, "labeled",
                                            "*.pickle")))
    pickles = [q for q in pickles if not q.endswith("_eemask.pickle")
               and not q.endswith("_semantic.pickle")]
    ee_poses.extend(load_sample(q)["pose"] for q in pickles)
    with open(args.out, "wb") as f:
        pickle.dump(ee_poses, f)
    print(f"{len(ee_poses)} poses -> {args.out}")
    return ee_poses


if __name__ == "__main__":
    main()
