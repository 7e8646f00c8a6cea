"""Synthetic labelled scenes, numpy only: the benchmark's frozen copy of the
scene generator of ``mrcc_tpu_torch/data/synthetic.py`` (``generate_sample``
and its helpers), so that a change to the program cannot change the
benchmark's inputs.

A Franka-hand-like end-effector (palm plate, two fingers, wrist collar,
cable fin) on a two-link arm over a table plane with clutter boxes; labels
background 0, arm 1, end-effector 2.  :func:`train_batch` lays scenes out
as the port's training collate does: each scene centred on the middle of
its bounding box, colours moved from [0, 1] to [-0.5, 0.5], padded to
``max_points`` rows with a mask and the ignore label.
"""

from __future__ import annotations

import numpy as np

IGNORE_LABEL = -100


def quat_to_matrix(q):
    """WXYZ quaternion -> 3x3 rotation matrix (unit-norm form)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _box_surface(rng, lo, hi, n):
    """n points uniform on the surface of an axis-aligned box."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    size = hi - lo
    areas = np.array([size[1] * size[2], size[1] * size[2],
                      size[0] * size[2], size[0] * size[2],
                      size[0] * size[1], size[0] * size[1]])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u, v = rng.random(n), rng.random(n)
    pts = np.empty((n, 3))
    for f in range(6):
        m = face == f
        axis = f // 2
        a, b = [i for i in range(3) if i != axis]
        pts[m, axis] = lo[axis] if f % 2 == 0 else hi[axis]
        pts[m, a] = lo[a] + u[m] * size[a]
        pts[m, b] = lo[b] + v[m] * size[b]
    return pts


def _cylinder_surface(rng, p0, p1, radius, n):
    """n points on the lateral surface of a cylinder from p0 to p1."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    axis = axis / length
    ref = (np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9
           else np.array([1.0, 0, 0]))
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    t = rng.random(n) * length
    ang = rng.random(n) * 2 * np.pi
    return (p0[None] + t[:, None] * axis[None]
            + radius * np.cos(ang)[:, None] * u[None]
            + radius * np.sin(ang)[:, None] * v[None])


def _ee_template(rng, n):
    """End-effector surface points in the canonical EE frame."""
    n_palm = int(n * 0.5)
    n_f = int(n * 0.14)
    n_wrist = int(n * 0.12)
    n_fin = n - n_palm - 2 * n_f - n_wrist
    palm = _box_surface(rng, [-0.022, -0.1, 0.0], [0.02, 0.1, 0.07], n_palm)
    f_l = _box_surface(rng, [-0.01, 0.038, 0.07], [0.01, 0.058, 0.12], n_f)
    f_r = _box_surface(rng, [-0.01, -0.058, 0.07], [0.01, -0.038, 0.12], n_f)
    wrist = _cylinder_surface(rng, [0, 0, -0.045], [0, 0, 0.0], 0.032,
                              n_wrist)
    fin = _box_surface(rng, [-0.022, 0.055, -0.02], [0.02, 0.08, -0.005],
                       n_fin)
    return np.concatenate([palm, f_l, f_r, wrist, fin])


def _random_pose(rng):
    pos = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.25, 0.25),
                    rng.uniform(0.6, 1.4)])
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return np.concatenate([pos, q])


def scene(seed, n_ee=4096, n_arm=6000, n_bg=14000, noise=0.0015):
    """One labelled scene of ``n_ee + n_arm + n_bg`` points:
    ``(points [P, 3] f32, rgb [P, 3] f32 in [0, 1], labels [P] int32)``."""
    rng = np.random.default_rng(seed)
    pose = _random_pose(rng)
    rot = quat_to_matrix(pose[3:])
    ee_local = _ee_template(rng, n_ee)
    ee_pts = ee_local @ rot.T + pose[:3]

    mount = pose[:3] + rot @ np.array([0.0, 0.0, -0.01])
    elbow = mount + rng.normal(size=3) * 0.05 + np.array([0.15, 0.1, 0.1])
    base = np.array([0.55, 0.35, 1.1]) + rng.normal(size=3) * 0.03
    link1 = _cylinder_surface(rng, base, elbow, 0.045, n_arm // 2)
    link2 = _cylinder_surface(rng, elbow, mount, 0.035, n_arm - n_arm // 2)
    arm_pts = np.concatenate([link1, link2])

    n_table = int(n_bg * 0.7)
    table = np.stack([rng.uniform(-0.9, 0.9, n_table),
                      0.43 + rng.normal(0.0, 0.002, n_table),
                      rng.uniform(0.5, 1.9, n_table)], axis=1)
    clutter = []
    remaining = n_bg - n_table
    for _ in range(4):
        c = np.array([rng.uniform(-0.7, 0.7), rng.uniform(0.1, 0.35),
                      rng.uniform(0.7, 1.7)])
        s = rng.uniform(0.04, 0.12, size=3)
        clutter.append(_box_surface(rng, c - s, c + s, remaining // 4))
    bg_pts = np.concatenate([table] + clutter)[:n_bg]

    points = np.concatenate([bg_pts, arm_pts, ee_pts]).astype(np.float32)
    labels = np.concatenate([np.zeros(len(bg_pts)), np.ones(len(arm_pts)),
                             np.full(len(ee_pts), 2.0)])
    points = points + rng.normal(size=points.shape).astype(np.float32) * noise

    rgb = np.empty_like(points)
    rgb[labels == 0] = rng.uniform(0.2, 0.9, (int((labels == 0).sum()), 3))
    rgb[labels == 1] = rng.uniform(0.75, 0.95, (int((labels == 1).sum()), 3))
    ee_l = ee_local - ee_local.min(0)
    ee_l = ee_l / np.maximum(ee_l.max(0), 1e-9)
    rgb[labels == 2] = (0.08 + 0.25 * ee_l
                        + rng.normal(size=ee_l.shape) * 0.02)
    rgb = np.clip(rgb, 0.0, 1.0).astype(np.float32)

    perm = rng.permutation(len(points))
    return points[perm], rgb[perm], labels[perm].astype(np.int32)


def scene_seeds(seed, count):
    """``count`` scene seeds drawn from ``seed`` (any non-negative
    integer)."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
    return [int(s) for s in rng.integers(0, 2 ** 62, size=count)]


def train_batch(seeds, max_points, n_ee, n_arm, n_bg):
    """One training batch of the scenes of ``seeds``, laid out as the
    port's training collate: ``{points, feats, labels, mask}`` numpy
    arrays of ``max_points`` rows per scene."""
    b = len(seeds)
    points = np.zeros((b, max_points, 3), np.float32)
    feats = np.zeros((b, max_points, 3), np.float32)
    labels = np.full((b, max_points), IGNORE_LABEL, np.int32)
    mask = np.zeros((b, max_points), bool)
    for i, s in enumerate(seeds):
        p, rgb, lab = scene(s, n_ee=n_ee, n_arm=n_arm, n_bg=n_bg)
        p = p - (p.max(0) + p.min(0)) / 2
        n = min(len(p), max_points)
        points[i, :n] = p[:n]
        feats[i, :n] = rgb[:n] - 0.5
        labels[i, :n] = lab[:n]
        mask[i, :n] = True
    return {"points": points, "feats": feats, "labels": labels, "mask": mask}
