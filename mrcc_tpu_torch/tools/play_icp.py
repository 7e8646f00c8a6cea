"""Trimmed-ICP convergence against noise and initial rotation (port of
``playground/play_icp.py``): the template plus Gaussian noise, in the
identity pose, is refined by ``solve.icp_refine`` (the plain distance
matrix: the script's ``use_pallas`` default) from a pose rotated by 0.1,
0.3 or 0.6 rad about a random axis and moved by 5.4 cm; the table gives
the final rotation (rad) and translation (m) errors against the identity.

Where ICP starts near the optimum (noise <= ``CONVERGED["noise"]``, initial
rotation <= ``CONVERGED["angle"]``) it converges to the noise:
``converged`` says whether such a row's errors are within
``CONVERGED["rot"]`` rad and ``CONVERGED["trans"]`` m (printed with the
table).  Larger starts may settle in another minimum.

  python -m mrcc_tpu_torch.tools.play_icp [--iters 30] [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.transform import quat_to_matrix
from ..solve.icp import default_template, icp_refine

CONVERGED = {"noise": 0.002, "angle": 0.3, "rot": 0.01, "trans": 0.001}


def perturbed_pose(angle_rad, axis, t_off):
    """WXYZ pose: a rotation of ``angle_rad`` about ``axis``, then
    ``t_off``."""
    axis = np.asarray(axis, np.float32)
    axis /= np.linalg.norm(axis)
    half = angle_rad / 2
    q = np.array([np.cos(half), *(np.sin(half) * axis)], np.float32)
    return np.concatenate([np.asarray(t_off, np.float32), q])


def converged(row):
    """Whether a row that starts near the optimum met the thresholds (True
    for the other rows)."""
    if row["noise"] > CONVERGED["noise"] or row["angle"] > CONVERGED["angle"]:
        return True
    return (row["rot_err"] <= CONVERGED["rot"]
            and row["trans_err"] <= CONVERGED["trans"])


def main(argv=None):
    """Returns the table's rows: ``{noise, angle, rot_err, trans_err}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    template = default_template(args.points)
    tmpl = torch.as_tensor(template, device=dev)

    print(f"converged where noise <= {CONVERGED['noise']} and init rot <= "
          f"{CONVERGED['angle']}: rot err <= {CONVERGED['rot']} rad, "
          f"trans err <= {CONVERGED['trans']} m")
    print(f"{'noise':>8} {'init rot':>9} {'final rot err':>14} "
          f"{'final trans err':>16}")
    rows = []
    for sigma in (0.0, 0.002, 0.005, 0.01):
        for angle in (0.1, 0.3, 0.6):
            # the observed cloud is the template plus noise in the identity
            # pose; ICP starts from a wrong pose and pulls back
            obs = template + rng.normal(0, sigma, template.shape).astype(
                np.float32)
            init = perturbed_pose(angle, rng.normal(size=3),
                                  [0.03, -0.02, 0.04])
            refined = icp_refine(
                tmpl, torch.as_tensor(obs, device=dev)[None],
                torch.ones((1, len(obs)), dtype=torch.bool, device=dev),
                torch.as_tensor(init, device=dev)[None],
                iterations=args.iters)[0].cpu()
            cos = (torch.trace(quat_to_matrix(refined[3:])) - 1) / 2
            row = dict(noise=sigma, angle=angle,
                       rot_err=float(np.arccos(np.clip(float(cos), -1, 1))),
                       trans_err=float(torch.linalg.vector_norm(
                           refined[:3])))
            rows.append(row)
            print(f"{sigma:8.3f} {angle:9.2f} {row['rot_err']:14.4f} "
                  f"{row['trans_err']:16.4f}")
    return rows


if __name__ == "__main__":
    main()
