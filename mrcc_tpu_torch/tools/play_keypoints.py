"""The 6-keypoint labels and the Kabsch pose from keypoints (port of
``playground/play_keypoints.py``): a synthetic scene's EE crop, its
keypoint labels as the data loader makes them (``data.labels.
get_6_key_points``), then ``solve.keypoints.pose_from_key_points`` of the
labelled points and the round-trip error against the known pose: the
noise-free bound of the keypoint pipeline.

The sample's ``pose`` is XYZW; the labels and the error take WXYZ, so it
is reordered first (the JAX script hands the XYZW pose over as it is,
ROADMAP C37).

  python -m mrcc_tpu_torch.tools.play_keypoints [--seed 5] \
      [--snapshot kp.png] [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..data.labels import get_6_key_points
from ..data.synthetic import generate_sample
from ..device import resolve_device
from ..geometry.quaternion import switch_pose_w
from ..geometry.transform import quat_to_matrix
from ..solve.keypoints import pose_from_key_points


def main(argv=None):
    """Returns ``{pose, kp_idx, found, rec, ok, t_err, r_err}`` (WXYZ
    poses, metres and radians), or None where the EE face is not
    visible."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--snapshot", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    s = generate_sample(seed=args.seed)
    ee = s["labels"] == 2
    ee_pts = s["points"][ee]
    pose = switch_pose_w(torch.as_tensor(s["pose"], dtype=torch.float32))
    pose = pose.numpy()
    print(f"EE crop: {len(ee_pts)} points | GT pose {np.round(pose, 3)}")

    kp_xyz, kp_idx = get_6_key_points(ee_pts, pose)
    if len(kp_xyz) == 0:
        print("EE face not visible from this pose — try another --seed")
        return None
    found = kp_idx >= 0
    print("keypoints found:", int(found.sum()), "of 6 | indices:",
          kp_idx.tolist())

    rec, ok = pose_from_key_points(
        torch.as_tensor(np.asarray(kp_xyz, np.float32), device=dev)[None],
        torch.as_tensor(found, device=dev)[None])
    rec, ok = rec[0].cpu(), bool(ok[0])
    print("Kabsch ok:", ok)
    t_err = float(np.linalg.norm(rec[:3].numpy() - pose[:3]))
    r_gt = quat_to_matrix(torch.as_tensor(pose[3:]))
    r_rec = quat_to_matrix(rec[3:])
    cos = (torch.trace(r_gt.T @ r_rec) - 1) / 2
    r_err = float(np.arccos(np.clip(float(cos), -1, 1)))
    print(f"Kabsch round-trip: translation {t_err * 100:.2f} cm, "
          f"rotation {np.degrees(r_err):.2f} deg")

    if args.snapshot:
        from ..utils.visualization import save_cloud_png

        colors = np.full_like(ee_pts, 0.75)
        for j, i in enumerate(kp_idx):
            if i >= 0:
                colors[int(i)] = [1.0, j / 6.0, 0.0]
        save_cloud_png(ee_pts, colors, args.snapshot, s=3.0)
        print("snapshot:", args.snapshot)
    return dict(pose=pose, kp_idx=kp_idx, found=found, rec=rec.numpy(),
                ok=ok, t_err=t_err, r_err=r_err)


if __name__ == "__main__":
    main()
