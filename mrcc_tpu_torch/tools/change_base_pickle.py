"""Rewrite the robot2ee poses of recorded pickles into a new base frame
(port of ``scripts/change_base_pickle.py``): each frame's ee2base pose is
composed with a base-change pose (``geometry.transform_pose2pose``, in
f32 on the CPU) and the pickle written back.

  python -m mrcc_tpu_torch.tools.change_base_pickle <folder> \
      --base-pose x y z qx qy qz qw
"""

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from ..data.dataset import load_sample
from ..geometry import transform_pose2pose
from ..geometry.quaternion import switch_pose_w, wxyz_to_xyzw


def change_base(data, base_pose_xyzw):
    """``data`` (a sample dict with ``robot2ee_pose``, XYZW) with that pose
    composed with ``base_pose_xyzw``; a new dict."""
    ee2base = torch.as_tensor(np.asarray(data["robot2ee_pose"], np.float32))
    base = torch.as_tensor(np.asarray(base_pose_xyzw, np.float32))
    new = transform_pose2pose(switch_pose_w(ee2base), switch_pose_w(base))
    data = dict(data)
    data["robot2ee_pose"] = torch.cat(
        [new[:3], wxyz_to_xyzw(new[3:7])]).numpy().astype(np.float32)
    return data


def main(argv=None):
    """Returns the paths rewritten."""
    p = argparse.ArgumentParser()
    p.add_argument("folder")
    p.add_argument("--base-pose", type=float, nargs=7, required=True,
                   help="x y z qx qy qz qw")
    args = p.parse_args(argv)
    written = []
    for path in sorted(glob.glob(os.path.join(args.folder, "*.pickle"))):
        if path.endswith(("_semantic.pickle", "_eemask.pickle")):
            continue
        data = load_sample(path)
        if "robot2ee_pose" not in data:
            continue
        data = change_base(data, np.asarray(args.base_pose))
        with open(path, "wb") as f:
            pickle.dump(data, f)
        print(path)
        written.append(path)
    return written


if __name__ == "__main__":
    main()
