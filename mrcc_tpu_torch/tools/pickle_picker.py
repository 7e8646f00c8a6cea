"""Eligibility labeling of recorded split instances (port of
``scripts/pickle_picker.py``): walk every Nth split instance, show the
ROI-cropped cloud (a snapshot PNG through ``utils.visualization.
save_cloud_png`` with ``--snapshots``), ask "Is position OK? / Is
orientation OK?" on stdin and store ``position_eligibility`` /
``orientation_eligibility`` back into the split JSON (periodic saves,
saved on KeyboardInterrupt).  ``--auto MIN_ARM`` labels without asking:
eligible where ``arm_point_count >= MIN_ARM``.

  python -m mrcc_tpu_torch.tools.pickle_picker --splits s.json --auto 500
"""

import argparse
import json
import os

import numpy as np

from ..data.dataset import load_sample
from ..data.labels import get_roi_mask

ROI = {"min_x": -0.52, "max_x": 0.52, "max_y": 0.4,
       "min_z": 0, "max_z": 1.2}
NEW_FIELDS = ("position_eligibility", "orientation_eligibility")


def save_file(filename, data):
    with open(filename, "w") as fp:
        json.dump(data, fp, indent=4)
    print("Saved")


def _ask(prompt):
    return input(prompt).strip().lower() in ("", "yes", "y")


def label_instance(ins, snapshot_dir=None, auto_min_arm=None):
    """Returns ``(position_ok, orientation_ok, arm_point_count)``."""
    data = load_sample(ins["filepath"])
    points = np.asarray(data["points"], np.float32)
    rgb = np.asarray(data["rgb"], np.float32)
    arm_count = int((np.asarray(data["labels"]) == 1).sum())

    if auto_min_arm is not None:
        ok = arm_count >= auto_min_arm
        return ok, ok, arm_count

    if rgb.min() < 0:  # the reference's minmax rescue for bad data prep
        lo, hi = rgb.min(axis=0), rgb.max(axis=0)
        rgb = (rgb - lo) / np.maximum(hi - lo, 1e-9)
    roi = get_roi_mask(points, **ROI)
    if snapshot_dir is not None:
        from ..utils.visualization import save_cloud_png

        path = os.path.join(snapshot_dir,
                            os.path.basename(ins["filepath"]) + ".png")
        save_cloud_png(points[roi], rgb[roi], path)
        print("snapshot:", path)
    print(ins["filepath"], f"(arm points: {arm_count})")
    return _ask("Is position OK? [Y/n]: "), \
        _ask("Is orientation OK? [Y/n]: "), arm_count


def main(argv=None):
    """Returns the labelled splits (also saved to ``--splits``)."""
    ap = argparse.ArgumentParser(description="Label split eligibility")
    ap.add_argument("--splits", default="alivev2_splits.json")
    ap.add_argument("--save_freq", type=int, default=16)
    ap.add_argument("--every", type=int, default=3,
                    help="visit every Nth instance (reference: i %% 3)")
    ap.add_argument("--auto", type=int, default=None, metavar="MIN_ARM",
                    help="non-interactive: eligible iff arm_point_count >= N")
    ap.add_argument("--snapshots", default=None)
    args = ap.parse_args(argv)

    with open(args.splits) as fp:
        splits = json.load(fp)
    if args.snapshots:
        os.makedirs(args.snapshots, exist_ok=True)

    for s in splits:
        try:
            for i, ins in enumerate(splits[s]):
                if i % args.every != 0 or not isinstance(ins, dict):
                    continue
                if all(k in ins for k in NEW_FIELDS):
                    continue
                try:
                    pos_ok, ori_ok, arm = label_instance(
                        ins, snapshot_dir=args.snapshots,
                        auto_min_arm=args.auto)
                except FileNotFoundError as e:
                    print("missing:", e)
                    continue
                ins["arm_point_count"] = arm
                ins["position_eligibility"] = bool(pos_ok)
                ins["orientation_eligibility"] = bool(ori_ok)
                if i % args.save_freq == 0:
                    save_file(args.splits, splits)
                    print(f"{s}: %{round(i / max(len(splits[s]), 1) * 100, 1)}"
                          " done.")
        except KeyboardInterrupt:
            save_file(args.splits, splits)
            raise
        save_file(args.splits, splits)
    print("Done!")
    return splits


if __name__ == "__main__":
    main()
