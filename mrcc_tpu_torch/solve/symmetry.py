"""Test-time gripper-symmetry flip disambiguation (port of
``mrcc_tpu/solve/symmetry.py``).

The two-finger gripper is nearly invariant under a 180 degree rotation
about its approach (z) axis, so the rotation regressor has a symmetric
error mode.  The keypoint classes are not symmetric ("top left" is not "top
right"), so the Kabsch pose from class-matched keypoints tells the
branches apart: where the flipped rotation is closer to the keypoint pose,
take it, and recompute the magic translation in the flipped frame.
"""

from __future__ import annotations

import torch

from ..geometry.quaternion import qmul
from .translation import predict_translation

# WXYZ quaternions of a 180 degree body-frame rotation about each axis.
_FLIP_Q = {
    "x": (0.0, 1.0, 0.0, 0.0),
    "y": (0.0, 0.0, 1.0, 0.0),
    "z": (0.0, 0.0, 0.0, 1.0),
}


def _quat_angle(a, b):
    """Rotation angle between quaternions (sign-invariant), the reference's
    metric form ``acos(2 <a, b>^2 - 1)``, over the last axis."""
    a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1,
                                                     keepdim=True), 1e-12)
    b = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1,
                                                     keepdim=True), 1e-12)
    d = (a * b).sum(-1)
    return torch.acos(torch.clamp(2.0 * d * d - 1.0, -1.0, 1.0))


def disambiguate_flip(ee_pose, kp_pose, kp_ok, ee_points, mask, axis="z",
                      magic_x=-0.015, z_percentile=None):
    """Resolve the gripper-symmetry branch of network poses through the
    keypoint poses, batched over items.

    Args:
      ee_pose: [B, 7] network poses; kp_pose: [B, 7] keypoint Kabsch poses;
      kp_ok: [B] whether each keypoint pose is trusted.
      ee_points, mask: the EE crops [B, P, 3], [B, P], for the translation
        under the flipped rotation.
      axis: the body-frame symmetry axis.
    Returns ``([B, 7] poses, [B] flipped)``.
    """
    q = ee_pose[:, 3:7]
    flip = torch.tensor(_FLIP_Q[axis], dtype=q.dtype, device=q.device)
    q_flip = qmul(q, flip.expand_as(q))
    q_kp = kp_pose[:, 3:7]
    use = kp_ok & (_quat_angle(q_flip, q_kp) < _quat_angle(q, q_kp))
    pos_flip, _ = predict_translation(ee_points, mask, q_flip,
                                      magic_x=magic_x,
                                      z_percentile=z_percentile)
    pos = torch.where(use[:, None], pos_flip, ee_pose[:, :3])
    q_out = torch.where(use[:, None], q_flip, q)
    return torch.cat([pos, q_out], dim=-1), use
