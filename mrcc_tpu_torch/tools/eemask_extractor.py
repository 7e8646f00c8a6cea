"""Extract end-effector point masks from labeled pickles (port of
``scripts/eemask_extractor.py``): the indices of the points inside the EE
box in the labelled EE frame (``data.labels.get_ee_idx``) go to
``*_eemask.pickle`` beside each split entry.

  python -m mrcc_tpu_torch.tools.eemask_extractor --splits splits.json
"""

import argparse
import json
import pickle

import numpy as np

from ..data.dataset import load_sample
from ..data.labels import get_ee_idx


def extract(splits):
    """Write every split entry's EE mask; returns the paths written."""
    written = []
    for split in splits.values():
        for ins in split:
            path = ins["filepath"]
            data = load_sample(path)
            points = np.asarray(data["points"])
            pose = np.asarray(data["pose"], np.float64)
            # stored poses are XYZW; get_ee_idx expects WXYZ
            pose = np.concatenate([pose[:3], pose[6:7], pose[3:6]])
            ee_idx = get_ee_idx(points, pose)
            out = path.replace(".pickle", "_eemask.pickle")
            with open(out, "wb") as f:
                pickle.dump(np.asarray(ee_idx), f)
            written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--splits", required=True)
    args = p.parse_args(argv)
    with open(args.splits) as f:
        splits = json.load(f)
    written = extract(splits)
    print(f"wrote {len(written)} eemask files")
    return written


if __name__ == "__main__":
    main()
