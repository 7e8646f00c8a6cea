"""Host-side (numpy) geometric labels from a pose (the port's copy of
``mrcc_tpu/data/labels.py``, after the reference's ``utils/data.py``):
the ROI box filter, the EE crop from the pose (``get_ee_idx``), the
cross-section points that supervise voting, the 6- and 10-keypoint labels,
``collect_closest_points`` and farthest-point sampling.  numpy only, in the
JAX package's operation order, so one input gives the same bits.  Poses
are WXYZ ``[x, y, z, qw, qx, qy, qz]``.
"""

from __future__ import annotations

import numpy as np

from .synthetic import quat_to_matrix_np

__all__ = ["EE_DIM_DEFAULT", "KEY_POINTS_10", "KEY_POINTS_6",
           "collect_closest_points", "dists_to_line_np",
           "farthest_point_sample_idx", "get_6_key_points",
           "get_ee_cross_section_idx", "get_ee_idx", "get_key_points",
           "get_roi_mask", "quat_to_matrix_np",
           "select_closest_points_to_line"]

# Canonical 10-keypoint EE template (utils/data.py:150-161).
KEY_POINTS_10 = np.array([
    [0.02, 0.09, 0],
    [0.02, -0.09, 0],
    [0.014, 0.095, 0.07],
    [0.014, -0.095, 0.07],
    [0, 0.048, 0.12],   # gripper
    [0, -0.048, 0.12],  # gripper
    [-0.022, 0.09, 0],
    [-0.022, -0.09, 0],
    [-0.014, 0.095, 0.07],
    [-0.014, -0.095, 0.07],
])

# Canonical 6-keypoint EE template (utils/data.py:264-271).
KEY_POINTS_6 = np.array([
    [0.02, 0.09, 0],       # P1: top left
    [0.01, -0.1, 0],       # P2: top right
    [0.014, 0.095, 0.07],  # P3: bottom left
    [0.014, -0.095, 0.07],  # P4: bottom right
    [0, 0.048, 0.12],      # gripper
    [0, -0.048, 0.12],     # gripper
])

# Default EE bounding box in the EE frame (utils/data.py:79-86).
EE_DIM_DEFAULT = dict(min_z=-0.006, max_z=0.12, min_x=-0.05, max_x=0.05,
                      min_y=-0.11, max_y=0.11)


def get_roi_mask(points, min_x=-500, max_x=500, min_y=-500, max_y=500,
                 min_z=-500, max_z=500, offset=0.0):
    """Axis-aligned box filter (utils/data.py:58)."""
    lo = np.array([min_x - offset, min_y - offset, min_z - offset])
    hi = np.array([max_x + offset, max_y + offset, max_z + offset])
    return np.all((points > lo) & (points < hi), axis=-1)


def get_ee_idx(points, pose, ee_dim=None, arm_idx=None):
    """Indices of points inside the EE bbox in the gt EE frame
    (utils/data.py:78).  pose is WXYZ."""
    dim = dict(EE_DIM_DEFAULT)
    if isinstance(ee_dim, dict):
        dim.update(ee_dim)
    rot = quat_to_matrix_np(pose[3:7])
    local = (points - pose[:3]) @ rot  # == rot.T @ p per point
    mask = get_roi_mask(local, **dim)
    idx = np.where(mask)[0]
    if arm_idx is not None:
        idx = idx[np.isin(idx, arm_idx, assume_unique=True)]
    return idx


def dists_to_line_np(p, lp1, lp2):
    d = (lp1 - lp2) / np.linalg.norm(lp1 - lp2)
    t = (p - lp1) @ d
    proj = lp1 + t[:, None] * d
    return np.linalg.norm(proj - p, axis=-1)


def select_closest_points_to_line(points, lp1, lp2, count=0, cutoff=0.008):
    """Up to ``count`` closest points within ``cutoff`` of the line
    (utils/transformation.py:150)."""
    count = min(count, len(points)) if count > 0 else len(points)
    dists = dists_to_line_np(points, lp2, lp1)
    order = np.argsort(dists)[:count]
    keep = order[dists[order] < cutoff]
    return dists[keep], keep


def get_ee_cross_section_idx(ee_points, pose, count=32, cutoff=0.004):
    """Points closest to the gripper axis line through the EE origin
    (utils/data.py:106) — the voting supervision signal."""
    rot = quat_to_matrix_np(pose[3:7])
    local = (ee_points - pose[:3]) @ rot
    return select_closest_points_to_line(
        local, np.array([-0.05, 0, 0.0]), np.array([0.05, 0, 0.0]),
        count=count, cutoff=cutoff,
    )


def _closest_point(p, points, maximize_dim=None):
    """(utils/data.py:125) nearest point; optionally first replace p's
    coordinate along ``maximize_dim`` with the selection's max."""
    if len(points) < 1:
        return None, None, None
    p = np.asarray(p, dtype=np.float64).copy()
    if maximize_dim is not None:
        p[maximize_dim] = points.max(axis=0)[maximize_dim]
    norms = np.linalg.norm(points - p, axis=1)
    i = int(norms.argmin())
    return i, points[i], float(norms[i])


def _gripper_points(key_points, point_idx, new_pts, slot_l=4, slot_r=5):
    """Shared gripper-tip logic of both keypoint labellers
    (utils/data.py:214-247)."""
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
    """Rotate points+origin into the EE frame, centre on the EE position
    (shared preamble of both labellers, utils/data.py:141-148)."""
    rot = quat_to_matrix_np(pose[3:7])
    stacked = np.concatenate([ee_points, pose[None, :3]])
    local = stacked @ rot
    pos = local[-1]
    pts = local[:-1] - pos
    return pts, pos, rot


def get_key_points(ee_points, pose, euclidean_threshold=0.018, ignore_label=-100):
    """10-keypoint labelling against the canonical template
    (utils/data.py:141).  Returns (key_points [10,3] world frame,
    point_idx [10] into ee_points or ignore_label)."""
    new_pts, offset, rot = _to_ee_frame(ee_points, pose)
    key_points = KEY_POINTS_10.copy()
    point_idx = np.full(len(key_points), ignore_label, dtype=np.int64)

    front = new_pts[:, 0] > 0.005
    front_idx = np.where(front)[0]
    back_offsets = {0: [-0.04, 0, 0], 1: [-0.04, 0, 0],
                    2: [-0.03, 0, 0], 3: [-0.03, 0, 0]}
    for k in range(4):
        i, closest, dist = _closest_point(key_points[k], new_pts[front])
        if closest is not None and dist < euclidean_threshold:
            key_points[k] = closest
            point_idx[k] = front_idx[i]
            key_points[k + 6] = closest + back_offsets[k]

    back = new_pts[:, 0] < -0.01
    back_idx = np.where(back)[0]
    if back.any():
        for k in range(6, 10):
            i, closest, dist = _closest_point(key_points[k], new_pts[back])
            if closest is not None and dist < euclidean_threshold:
                key_points[k] = closest
                point_idx[k] = back_idx[i]

    _gripper_points(key_points, point_idx, new_pts)

    key_points = (key_points + offset) @ rot.T
    return key_points, point_idx


def get_6_key_points(ee_points, pose, euclidean_threshold=0.03,
                     ignore_label=-100):
    """6-keypoint labelling: 4 front-plate corners + 2 gripper tips
    (utils/data.py:255).  Returns ([], []) when the EE face is not visible,
    matching the reference's empty-return guard."""
    new_pts, offset, rot = _to_ee_frame(ee_points, pose)
    key_points = KEY_POINTS_6.copy()
    point_idx = np.full(len(key_points), ignore_label, dtype=np.int64)

    face = (new_pts[:, 0] > -0.005) & (new_pts[:, 2] < 0.09)
    face_idx = np.where(face)[0]
    sel = new_pts[face]
    if len(sel) < 1:
        return np.array([]), np.array([])

    # corner extraction: nearest cloud point to each far bbox corner
    ee_bbox = np.array([
        [0.24, 0.32, -0.2],
        [0.24, -0.32, -0.2],
        [0.24, 0.32, 0.2],
        [0.24, -0.32, 0.2],
    ])
    front_pidx = np.linalg.norm(
        ee_bbox[:, None, :] - sel[None, :, :], axis=2
    ).argmin(axis=1)
    candidates = new_pts[face_idx[front_pidx]]
    close = np.linalg.norm(key_points[:4] - candidates, axis=1) < euclidean_threshold
    key_points[:4][close] = candidates[close]
    point_idx[:4][close] = face_idx[front_pidx][close]

    _gripper_points(key_points, point_idx, new_pts)

    key_points = (key_points + offset) @ rot.T
    return key_points, point_idx


def collect_closest_points(idx, points, euclidean_threshold=0.006):
    """All points within threshold of any seed point (utils/data.py:338).
    Returns (seed_positions, point_indices)."""
    norms = np.linalg.norm(points[idx][:, None, :] - points[None], axis=2)
    pcls_idx, p_idx = np.where(norms < euclidean_threshold)
    return pcls_idx, p_idx


def farthest_point_sample_idx(points, npoint, seed=None, start_idx=None):
    """Numpy FPS (utils/data.py:13).  Deterministic when ``seed`` or
    ``start_idx`` given (``start_idx`` pins the first centroid, matching the
    native C++ path's semantics)."""
    n = len(points)
    xyz = points[:, :3]
    if start_idx is not None:
        farthest = int(start_idx)
    else:
        rng = np.random.default_rng(seed)
        farthest = int(rng.integers(0, n))
    centroids = np.zeros(npoint, dtype=np.int64)
    distance = np.full(n, 1e10)
    for i in range(npoint):
        centroids[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        distance = np.minimum(distance, d)
        farthest = int(distance.argmax())
    return centroids
