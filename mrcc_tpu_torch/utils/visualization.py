"""Headless visualization helpers (port of
``mrcc_tpu/utils/visualization.py``): the reference's frame / axis meshes
and keypoint markers and its ``viz_pickle`` viewer, rendered to PNG files
with matplotlib (imported inside the functions, Agg backend) instead of an
interactive window.
"""

from __future__ import annotations

import os

import numpy as np

SEG_COLORS = np.array([[0.17, 0.24, 0.31],   # background '2C3E50'
                       [0.91, 0.30, 0.24],   # arm 'E74C3C'
                       [0.95, 0.77, 0.06]])  # ee 'F1C40F'
KP_COLORS = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                      [1, 1, 0], [1, 0, 1], [0, 1, 1]])


def _axes_points(pose, scale=0.1, n=20):
    """Points along the pose's x/y/z axes (visualization.py:13 frame mesh)."""
    from ..data.labels import quat_to_matrix_np

    rot = quat_to_matrix_np(np.asarray(pose[3:7]))
    t = np.asarray(pose[:3])
    out = []
    colors = []
    for axis, col in zip(rot.T, np.eye(3)):
        seg = t[None] + np.linspace(0, scale, n)[:, None] * axis[None]
        out.append(seg)
        colors.append(np.tile(col, (n, 1)))
    return np.concatenate(out), np.concatenate(colors)


def save_cloud_png(points, colors, path, elev=-70, azim=-90, s=0.3):
    """Scatter a cloud to PNG (viz_pickle.py viewer equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=colors, s=s)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def save_scene_snapshot(data, result, path, max_points=20000):
    """Render a prediction: segmentation colors + predicted pose axes +
    keypoints (app/main.py seg-overlay checkboxes equivalent)."""
    pts = np.asarray(data.points)
    seg = (np.asarray(result.segmentation)
           if result.segmentation is not None else np.zeros(len(pts), int))
    colors = SEG_COLORS[np.clip(seg, 0, 2)]
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, colors = pts[sel], colors[sel]
    extra_p = []
    extra_c = []
    if result.ee_pose is not None:
        p, c = _axes_points(result.ee_pose)
        extra_p.append(p)
        extra_c.append(c)
    for cls, coord in result.key_points:
        extra_p.append(coord[None].repeat(8, 0)
                       + np.random.default_rng(cls).normal(size=(8, 3)) * 2e-3)
        extra_c.append(np.tile(KP_COLORS[cls % 6], (8, 1)))
    if extra_p:
        pts = np.concatenate([pts] + extra_p)
        colors = np.concatenate([colors] + extra_c)
    return save_cloud_png(pts, colors, path)
