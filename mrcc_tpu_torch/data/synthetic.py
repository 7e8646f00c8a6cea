"""Synthetic labelled scenes, numpy only (the port's own copy of
``mrcc_tpu/data/synthetic.py::generate_sample`` and ``ee_template_points``).

A Franka-hand-like EE (palm plate, two fingers, wrist collar, one-sided
cable fin) on a two-link arm over a table plane with clutter boxes.  Same
seed, same numbers as the JAX package's generator.  Pose is XYZW in the
returned dict, as in the reference's sample pickles.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np


def quat_to_matrix_np(q):
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
    ref = np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9 else np.array([1.0, 0, 0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    t = rng.random(n) * length
    ang = rng.random(n) * 2 * np.pi
    return (p0[None] + t[:, None] * axis[None]
            + radius * np.cos(ang)[:, None] * u[None]
            + radius * np.sin(ang)[:, None] * v[None])


def ee_template_points(rng, n=4096):
    """EE surface points in the canonical EE frame (z along the approach)."""
    n_palm = int(n * 0.5)
    n_f = int(n * 0.14)
    n_wrist = int(n * 0.12)
    n_fin = n - n_palm - 2 * n_f - n_wrist
    palm = _box_surface(rng, [-0.022, -0.1, 0.0], [0.02, 0.1, 0.07], n_palm)
    f_l = _box_surface(rng, [-0.01, 0.038, 0.07], [0.01, 0.058, 0.12], n_f)
    f_r = _box_surface(rng, [-0.01, -0.058, 0.07], [0.01, -0.038, 0.12], n_f)
    wrist = _cylinder_surface(rng, [0, 0, -0.045], [0, 0, 0.0], 0.032, n_wrist)
    fin = _box_surface(rng, [-0.022, 0.055, -0.02], [0.02, 0.08, -0.005],
                       n_fin)
    return np.concatenate([palm, f_l, f_r, wrist, fin])


def random_pose(rng, dist_range=(0.6, 1.4)):
    """A random EE pose in the camera frame (WXYZ), camera looking at +z."""
    pos = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.25, 0.25),
                    rng.uniform(*dist_range)])
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return np.concatenate([pos, q])


def gt_base2cam_pose():
    """The synthetic ground-truth camera-to-robot-base extrinsic (WXYZ)."""
    return np.array([0.645, 0.408, 0.994, 0.656, 0.2964, 0.2756, -0.6299])


def _pose_to_mat(pose):
    m = np.eye(4)
    m[:3, :3] = quat_to_matrix_np(pose[3:7])
    m[:3, 3] = pose[:3]
    return m


def _mat_to_pose(m):
    """4x4 -> [pos, WXYZ] (branching Shepperd), numpy."""
    m = np.asarray(m, np.float64)
    r = m[:3, :3]
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                      (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = np.array([(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                      (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s])
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = np.array([(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                      0.25 * s, (r[1, 2] + r[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = np.array([(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                      (r[1, 2] + r[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return np.concatenate([m[:3, 3], q]).astype(np.float32)


def generate_sample(seed=0, n_ee=4096, n_arm=6000, n_bg=14000,
                    noise=0.0015):
    """One labelled scene: ``{points, rgb, labels, instance_labels, pose
    (XYZW), joint_angles, ee2base_pose (WXYZ)}``."""
    rng = np.random.default_rng(seed)
    pose = random_pose(rng)
    rot = quat_to_matrix_np(pose[3:])

    ee_local = ee_template_points(rng, n_ee)
    ee_pts = ee_local @ rot.T + pose[:3]

    mount = pose[:3] + rot @ np.array([0.0, 0.0, -0.01])
    elbow = mount + rng.normal(size=3) * 0.05 + np.array([0.15, 0.1, 0.1])
    base = np.array([0.55, 0.35, 1.1]) + rng.normal(size=3) * 0.03
    link1 = _cylinder_surface(rng, base, elbow, 0.045, n_arm // 2)
    link2 = _cylinder_surface(rng, elbow, mount, 0.035, n_arm - n_arm // 2)
    arm_pts = np.concatenate([link1, link2])

    n_table = int(n_bg * 0.7)
    table = np.stack([
        rng.uniform(-0.9, 0.9, n_table),
        0.43 + rng.normal(0.0, 0.002, n_table),
        rng.uniform(0.5, 1.9, n_table),
    ], axis=1)
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
                             np.full(len(ee_pts), 2.0)]).astype(np.float32)
    instance_labels = labels.copy()
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
    points, rgb, labels = points[perm], rgb[perm], labels[perm]
    instance_labels = instance_labels[perm]

    ee2base = _mat_to_pose(np.linalg.inv(_pose_to_mat(gt_base2cam_pose()))
                           @ _pose_to_mat(pose))
    pose_xyzw = np.concatenate([pose[:3], pose[4:], pose[3:4]])
    return {
        "points": points,
        "rgb": rgb,
        "labels": labels,
        "instance_labels": instance_labels,
        "pose": pose_xyzw.astype(np.float32),
        "joint_angles": rng.uniform(-1.5, 1.5, 9).astype(np.float32),
        "ee2base_pose": ee2base.astype(np.float32),
    }


def build_batch(batch, capacity, seed=0, with_labels=False):
    """``(points, rgb, mask)`` numpy arrays ``[B, capacity, ...]`` of scenes
    whose real point count scales with the capacity (the rule of the JAX
    package's ``bench.py::build_inputs``).  ``with_labels`` adds the
    per-point class labels ``[B, capacity] int32`` (background 0, arm 1,
    EE 2; padding rows -100, the ignore label) as a fourth value."""
    n_ee = max(capacity // 8, 512)
    n_arm = max(capacity * 3 // 16, 1024)
    n_bg = max(capacity * 7 // 16, 2048)
    pts = np.zeros((batch, capacity, 3), np.float32)
    rgb = np.zeros((batch, capacity, 3), np.float32)
    mask = np.zeros((batch, capacity), bool)
    labels = np.full((batch, capacity), -100, np.int32)
    for i in range(batch):
        s = generate_sample(seed=seed + i, n_ee=n_ee, n_arm=n_arm, n_bg=n_bg)
        n = min(len(s["points"]), capacity)
        pts[i, :n] = s["points"][:n]
        rgb[i, :n] = s["rgb"][:n]
        mask[i, :n] = True
        labels[i, :n] = s["labels"][:n]
    if with_labels:
        return pts, rgb, mask, labels
    return pts, rgb, mask


def write_sample_set(out_dir, n=5, seed0=1, **kw):
    """Write ``n`` sample pickles ``labeled/{i}.pickle`` (seeds ``seed0 +
    i``, ``kw`` to :func:`generate_sample`) and ``sample_splits.json``:
    every entry ``{filepath, position p{i % 3 + 1}, light, arm_point_count,
    position_eligibility, orientation_eligibility}``; the last sample is the
    test split, the one before it val, the rest train.  Byte for byte the
    JAX package's files for the same arguments."""
    out_dir = Path(out_dir)
    (out_dir / "labeled").mkdir(parents=True, exist_ok=True)
    entries = []
    for i in range(n):
        sample = generate_sample(seed=seed0 + i, **kw)
        path = out_dir / "labeled" / f"{i + 1}.pickle"
        with open(path, "wb") as f:
            pickle.dump(sample, f)
        entries.append({
            "filepath": str(path),
            "position": f"p{i % 3 + 1}",
            "light": "bright",
            "arm_point_count": int((sample["labels"] == 1).sum()),
            "position_eligibility": True,
            "orientation_eligibility": True,
        })
    splits = {"train": entries[:-2] or entries,
              "val": entries[-2:-1] or entries,
              "test": entries[-1:] or entries}
    with open(out_dir / "sample_splits.json", "w") as f:
        json.dump(splits, f, indent=2)
    return splits
