"""EE crop to template ICP: recovery error against the initial pose error
(port of ``playground/play_ee_icp.py``).  A synthetic scene's EE crop
(plus noise) at its known pose; the pose estimate is rotated by 2-40
degrees and moved by 1 or 3 cm, and ``solve.icp_refine`` pulls it back.

The sample's ``pose`` is XYZW; the solver takes WXYZ, so it is reordered
first (the JAX script hands the XYZW pose over as it is, ROADMAP C37).

  python -m mrcc_tpu_torch.tools.play_ee_icp [--noise 0.003] [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..data.synthetic import generate_sample
from ..device import resolve_device
from ..geometry.quaternion import qmul, switch_pose_w
from ..geometry.transform import quat_to_matrix
from ..solve.icp import default_template, icp_refine


def axis_angle_quat(angle, axis, rng):
    """WXYZ rotation of ``angle`` about ``axis`` (a random one for None)."""
    axis = rng.normal(size=3) if axis is None else np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    return np.array([np.cos(angle / 2), *(np.sin(angle / 2) * axis)],
                    np.float32)


def rot_err_deg(qa, qb):
    """Angle in degrees between two WXYZ rotations."""
    ra = quat_to_matrix(torch.as_tensor(qa))
    rb = quat_to_matrix(torch.as_tensor(qb))
    cos = (torch.trace(ra.T @ rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(float(cos), -1, 1))))


def main(argv=None):
    """Returns the table's rows: ``{init_rot, init_t, rot_err, t_err}``
    (degrees and metres)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", type=float, default=0.003)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(2)
    s = generate_sample(seed=9)
    ee_mask = s["labels"] == 2
    ee_pts = s["points"][ee_mask] + rng.normal(
        0, args.noise, (int(ee_mask.sum()), 3)).astype(np.float32)
    gt = switch_pose_w(torch.as_tensor(s["pose"], dtype=torch.float32))
    gt = gt.numpy()
    tmpl = torch.as_tensor(default_template(1024), device=dev)
    pts = torch.as_tensor(ee_pts, device=dev)[None]
    mask = torch.ones((1, len(ee_pts)), dtype=torch.bool, device=dev)
    print(f"EE crop {len(ee_pts)} pts, noise sigma {args.noise} m")

    print(f"{'init rot err':>13} {'init t err':>11} "
          f"{'-> rot err':>11} {'-> t err':>9}")
    rows = []
    for angle_deg in (2, 5, 10, 20, 40):
        for t_off in (0.01, 0.03):
            dq = axis_angle_quat(np.radians(angle_deg), None, rng)
            init = gt.copy()
            init[:3] += rng.normal(0, t_off, 3).astype(np.float32)
            init[3:] = qmul(torch.as_tensor(dq),
                            torch.as_tensor(gt[3:])).numpy()
            refined = icp_refine(tmpl, pts, mask,
                                 torch.as_tensor(init, device=dev)[None],
                                 iterations=args.iters)[0].cpu().numpy()
            row = dict(init_rot=rot_err_deg(init[3:], gt[3:]),
                       init_t=float(np.linalg.norm(init[:3] - gt[:3])),
                       rot_err=rot_err_deg(refined[3:], gt[3:]),
                       t_err=float(np.linalg.norm(refined[:3] - gt[:3])))
            rows.append(row)
            print(f"{row['init_rot']:13.2f} {row['init_t']:11.4f} "
                  f"{row['rot_err']:11.2f} {row['t_err']:9.4f}")
    return rows


if __name__ == "__main__":
    main()
