"""Host-side (numpy) keypoint labels from a pose (the port's copy of the
part of ``mrcc_tpu/data/labels.py`` that ``InferenceEngine.check_sanity``
runs: ``KEY_POINTS_6`` and ``get_6_key_points``, after the reference's
``utils/data.py``).  Poses are WXYZ ``[x, y, z, qw, qx, qy, qz]``."""

from __future__ import annotations

import numpy as np

from .synthetic import quat_to_matrix_np

__all__ = ["KEY_POINTS_6", "get_6_key_points", "quat_to_matrix_np"]

# Canonical 6-keypoint EE template (utils/data.py:264-271).
KEY_POINTS_6 = np.array([
    [0.02, 0.09, 0],       # P1: top left
    [0.01, -0.1, 0],       # P2: top right
    [0.014, 0.095, 0.07],  # P3: bottom left
    [0.014, -0.095, 0.07],  # P4: bottom right
    [0, 0.048, 0.12],      # gripper
    [0, -0.048, 0.12],     # gripper
])


def _closest_point(p, points, maximize_dim=None):
    """Nearest of ``points`` to ``p`` as ``(index, point, distance)``;
    ``maximize_dim`` first replaces p's coordinate on that axis by the
    points' maximum."""
    if len(points) < 1:
        return None, None, None
    p = np.asarray(p, dtype=np.float64).copy()
    if maximize_dim is not None:
        p[maximize_dim] = points.max(axis=0)[maximize_dim]
    norms = np.linalg.norm(points - p, axis=1)
    i = int(norms.argmin())
    return i, points[i], float(norms[i])


def _gripper_points(key_points, point_idx, new_pts, slot_l=4, slot_r=5):
    """The two gripper-tip keypoints (utils/data.py:214-247), in place."""
    gripper_mask = new_pts[:, 2] > 0.08
    gripper_idx = np.where(gripper_mask)[0]
    sel = new_pts[gripper_mask]

    p5 = p6 = None
    left = sel[:, 1] > 0
    if left.any():
        i, p5, _ = _closest_point([0, 0.01, 0.1], sel[left], maximize_dim=2)
        if p5 is not None:
            key_points[slot_l] = p5
            point_idx[slot_l] = gripper_idx[np.where(left)[0][i]]
    right = sel[:, 1] < 0
    if right.any():
        i, p6, _ = _closest_point([0, -0.01, 0.1], sel[right], maximize_dim=2)
        if p6 is not None:
            key_points[slot_r] = p6
            point_idx[slot_r] = gripper_idx[np.where(right)[0][i]]

    if p5 is None and p6 is not None:
        key_points[slot_l] = p6 * [1, -1, 1]
    elif p5 is not None and p6 is None:
        key_points[slot_r] = p5 * [1, -1, 1]
    key_points[slot_l][2] = max(key_points[slot_l][2], key_points[slot_r][2])
    key_points[slot_r][2] = key_points[slot_l][2]


def _to_ee_frame(ee_points, pose):
    """Points and EE origin rotated into the EE frame, points centred on
    the EE position: ``(points, position, rotation)``."""
    rot = quat_to_matrix_np(pose[3:7])
    local = np.concatenate([ee_points, pose[None, :3]]) @ rot
    pos = local[-1]
    return local[:-1] - pos, pos, rot


def get_6_key_points(ee_points, pose, euclidean_threshold=0.03,
                     ignore_label=-100):
    """6-keypoint labels: 4 front-plate corners and 2 gripper tips
    (utils/data.py:255).  Returns ``(key_points [6, 3] in the points'
    frame, point_idx [6] into ee_points or ignore_label)``, or
    ``([], [])`` when the EE face is not visible."""
    new_pts, offset, rot = _to_ee_frame(ee_points, pose)
    key_points = KEY_POINTS_6.copy()
    point_idx = np.full(len(key_points), ignore_label, dtype=np.int64)

    face = (new_pts[:, 0] > -0.005) & (new_pts[:, 2] < 0.09)
    face_idx = np.where(face)[0]
    sel = new_pts[face]
    if len(sel) < 1:
        return np.array([]), np.array([])

    # corners: the cloud point nearest to each far bbox corner
    ee_bbox = np.array([
        [0.24, 0.32, -0.2],
        [0.24, -0.32, -0.2],
        [0.24, 0.32, 0.2],
        [0.24, -0.32, 0.2],
    ])
    front_pidx = np.linalg.norm(
        ee_bbox[:, None, :] - sel[None, :, :], axis=2).argmin(axis=1)
    candidates = new_pts[face_idx[front_pidx]]
    close = (np.linalg.norm(key_points[:4] - candidates, axis=1)
             < euclidean_threshold)
    key_points[:4][close] = candidates[close]
    point_idx[:4][close] = face_idx[front_pidx][close]

    _gripper_points(key_points, point_idx, new_pts)

    key_points = (key_points + offset) @ rot.T
    return key_points, point_idx
