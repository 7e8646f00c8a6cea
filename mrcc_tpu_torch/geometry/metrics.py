"""Pose distances (port of ``mrcc_tpu/geometry/metrics.py::
compute_pose_dist``)."""

from __future__ import annotations

import torch

from .transform import qnormalize


def compute_pose_dist(gt, pred, position_voxelization=1.0):
    """Batched pose distances; the inputs are not modified (the reference
    scales ``gt`` in place, which the JAX package fixed).

    Args:
      gt: [B, 7] ``[x, y, z, qw, qx, qy, qz]``.
      pred: [B, >= 7] (columns past 7, the confidences, are ignored).
    Returns ``(dist, dist_position, dist_orientation, angle_diff)``, each
    [B].
    """
    pred = pred[..., :7]
    position = gt[..., :3] * position_voxelization
    position_pred = pred[..., :3] * position_voxelization
    orientation, orientation_pred = gt[..., 3:7], pred[..., 3:7]
    dist = torch.linalg.vector_norm(
        torch.cat([position, orientation], -1)
        - torch.cat([position_pred, orientation_pred], -1), dim=-1)
    dist_position = torch.linalg.vector_norm(position - position_pred, dim=-1)
    dist_orientation = torch.minimum(
        torch.linalg.vector_norm(orientation - orientation_pred, dim=-1),
        torch.linalg.vector_norm(orientation + orientation_pred, dim=-1))
    inner = (qnormalize(orientation) * qnormalize(orientation_pred)).sum(-1)
    angle_diff = torch.acos(torch.clamp(2.0 * inner ** 2 - 1.0, -1.0, 1.0))
    return dist, dist_position, dist_orientation, angle_diff
