"""Pose averaging and outlier flags of the extrinsic calibration (port of
``mrcc_tpu/geometry/calibration.py``, after the reference's
``utils/calibration.py``).

The quaternion mean is the Markley eigenvector method: the eigenvector of
the largest eigenvalue of ``sum w q q^T / sum w``, which is symmetric PSD,
so ``eigh`` serves; it is sign-invariant (q and -q add the same term) and
its sign is the solver's.
"""

from __future__ import annotations

import torch

from .metrics import compute_pose_metrics


def mad_outliers(y, m=2.0):
    """Median-absolute-deviation outlier flags of a 1-D tensor; a zero MAD
    flags nothing.  The medians average the two middle values of an even
    count, as ``jnp.median`` does (``torch.median`` takes the lower)."""
    d = (y - torch.quantile(y, 0.5)).abs()
    mdev = torch.quantile(d, 0.5)
    s = torch.where(mdev > 0, d / torch.clamp_min(mdev, 1e-30),
                    torch.zeros_like(d))
    return s > m


def pose_outliers(poses, m_pos=2.0, m_ang=4.0):
    """Outlier flags over a stack of poses [N, 3 or 7]: any of x / y / z a
    MAD outlier at ``m_pos``, or (7-vectors) the angle to the identity a MAD
    outlier at ``m_ang``."""
    out = torch.zeros(poses.shape[0], dtype=torch.bool, device=poses.device)
    for i in range(3):
        out |= mad_outliers(poses[:, i], m=m_pos)
    if poses.shape[1] == 7:
        ref = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                           dtype=poses.dtype, device=poses.device)
        angles = compute_pose_metrics(ref.expand_as(poses),
                                      poses)["angle_diff"]
        out |= mad_outliers(angles, m=m_ang)
    return out


def remove_pose_outliers(poses):
    """The reference's no-op: it computes the outliers and returns its input
    unchanged (its filter is commented out); ``pose_outliers`` plus a mask
    filters for real."""
    return poses


def _weights(weights, ref):
    if weights is None:
        return torch.ones(ref.shape[0], dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(weights, dtype=ref.dtype, device=ref.device)


def average_quaternions(quats, weights=None):
    """Weighted quaternion mean [4] of ``quats`` [N, 4] (WXYZ); q = -q."""
    w = _weights(weights, quats)
    a = (torch.einsum("n,ni,nj->ij", w, quats, quats)
         / torch.clamp_min(w.sum(), 1e-12))
    _, vecs = torch.linalg.eigh(a)  # ascending eigenvalues
    return vecs[:, -1]


def average_translations(ts, weights=None):
    """Weighted mean [3] of translations [N, 3]."""
    w = _weights(weights, ts)
    return (ts * w[:, None]).sum(0) / torch.clamp_min(w.sum(), 1e-12)


def average_poses(poses, weights=None):
    """Mean translation and eigen-averaged quaternion of poses (reshaped to
    [N, 7]); one pose comes back unchanged; ``weights`` of another length
    than N are ignored."""
    poses = poses.reshape(-1, 7)
    if poses.shape[0] == 1:
        return poses[0]
    if weights is not None and len(weights) != poses.shape[0]:
        weights = None
    return torch.cat([average_translations(poses[:, :3], weights),
                      average_quaternions(poses[:, 3:], weights)], dim=-1)
