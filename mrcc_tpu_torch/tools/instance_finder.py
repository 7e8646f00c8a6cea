"""Group recorded frames into robot-position instances (port of
``scripts/instance_finder.py``): walk time-ordered pickles, start a new
instance where the EE position jumps by more than ``--pos-threshold``
after a run of at least 5 frames, and copy each run of frames into a
per-instance folder ``p{instance + 1}``.

  python -m mrcc_tpu_torch.tools.instance_finder --infolder rec/ \
      --outfolder fold/
"""

import argparse
import glob
import os
import shutil

import numpy as np

from ..data.dataset import load_sample


def find_instances(pickles, pos_threshold=0.01, min_run=5):
    """Yield ``(instance_id, filepath)`` for time-ordered frames.  Only the
    position of each frame's ``pose`` decides (the script also reorders the
    quaternion, which it never reads)."""
    last = None
    instance = 0
    run = 0
    for path in pickles:
        position = np.asarray(load_sample(path)["pose"][:3], np.float64)
        if last is not None and np.linalg.norm(
                position - last) > pos_threshold:
            if run >= min_run:
                instance += 1
            run = 0
        run += 1
        last = position
        yield instance, path


def main(argv=None):
    """Returns the ``(instance_id, filepath)`` pairs copied."""
    p = argparse.ArgumentParser(
        description="Find instances for test/calib set")
    p.add_argument("--infolder", type=str, required=True)
    p.add_argument("--outfolder", type=str, default="fold/")
    p.add_argument("--pos-threshold", type=float, default=0.01)
    args = p.parse_args(argv)

    pickles = sorted(
        glob.glob(os.path.join(args.infolder, "*.pickle")),
        key=lambda x: int(os.path.basename(x).split(".")[0]))
    copied = []
    for instance, path in find_instances(pickles, args.pos_threshold):
        dst = os.path.join(args.outfolder, f"p{instance + 1}")
        os.makedirs(dst, exist_ok=True)
        shutil.copy(path, dst)
        copied.append((instance, path))
    print(f"{len(copied)} frames distributed into {args.outfolder}")
    return copied


if __name__ == "__main__":
    main()
