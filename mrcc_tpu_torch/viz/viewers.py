"""Headless equivalents of the reference's one-off Open3D viewers (port of
``mrcc_tpu/viz/viewers.py``).

The reference's ``visualization/viz_*.py`` scripts each open an interactive
Open3D window (key callbacks toggle RGB / GT / predicted colorings).  This
runtime has no display and no open3d, so every viewer renders the same
content to a multi-panel PNG (matplotlib 3D) — the key-toggle views become
panels — and can optionally emit the interactive HTML point-cloud viewer
(``viz.html_viewer``) for browser inspection.

Coverage (reference file -> function):
  viz_segmentation.py           -> viz_segmentation
  viz_ee-bbox.py                -> viz_ee_bbox
  viz_pcd.py                    -> viz_pcd
  viz_pickle.py / _refined/_cad -> viz_pickle
  viz_cross_section.py          -> viz_cross_section
  viz_data-instances.py /
    viz_test-data-instances.py  -> viz_data_instances
  viz_data-collection-positions -> viz_data_collection_positions

``matplotlib`` is imported inside the functions (Agg backend), so the
package imports on a machine without it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def generate_colors(n, seed=39):
    """Random class colors (utils/visualization.py ``generate_colors``,
    np.random.seed(39) preserved so class colors match the reference)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(0.1, 0.95, size=(n, 3))


def _scatter(ax, points, colors, title, s=1.0, pose=None, bbox=None):
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=colors, s=s,
               linewidths=0)
    if pose is not None:
        _draw_frame(ax, pose, size=0.25)
    if bbox is not None:
        _draw_bbox(ax, *bbox)
    ax.set_title(title, fontsize=9)
    # equal aspect (matplotlib 3D default skews clouds)
    lo, hi = points.min(axis=0), points.max(axis=0)
    c, r = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-6
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.tick_params(labelsize=5)


def _quat_matrix(q_wxyz):
    from ..data.labels import quat_to_matrix_np

    return quat_to_matrix_np(np.asarray(q_wxyz, np.float64))


def _draw_frame(ax, pose_wxyz, size=0.2):
    """RGB axis triad at a [pos, WXYZ quat] pose (o3d coordinate frame)."""
    pose_wxyz = np.asarray(pose_wxyz, np.float64)
    rot = _quat_matrix(pose_wxyz[3:7])
    o = pose_wxyz[:3]
    for axis, color in zip(rot.T, ("r", "g", "b")):
        tip = o + axis * size
        ax.plot([o[0], tip[0]], [o[1], tip[1]], [o[2], tip[2]],
                color=color, linewidth=1.5)


def _draw_bbox(ax, center, rot, extent, color="r"):
    """Oriented bbox wireframe (o3d OrientedBoundingBox)."""
    ext = np.asarray(extent, np.float64) / 2
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * ext
    corners = corners @ np.asarray(rot).T + np.asarray(center)
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    for a, b in edges:
        ax.plot(*np.stack([corners[a], corners[b]]).T, color=color,
                linewidth=0.8)
    return corners


def _fig(n_panels):
    plt = _plt()
    fig = plt.figure(figsize=(4 * n_panels, 4), dpi=110)
    return fig, [fig.add_subplot(1, n_panels, i + 1, projection="3d")
                 for i in range(n_panels)]


def _xyzw_to_wxyz(pose):
    pose = np.asarray(pose, np.float64)
    return np.concatenate([pose[:3], pose[6:7], pose[3:6]])


def viz_segmentation(sample, out_png, pred_labels=None, num_classes=3,
                     roi_mask=None):
    """RGB | GT classes | predicted classes panels
    (visualization/viz_segmentation.py:60-84 key toggles K/L/J)."""
    plt = _plt()
    pts = np.asarray(sample["points"])
    rgb = np.asarray(sample["rgb"])
    labels = np.asarray(sample["labels"]).astype(int)
    if roi_mask is not None:
        pts, rgb, labels = pts[roi_mask], rgb[roi_mask], labels[roi_mask]
        if pred_labels is not None:
            pred_labels = np.asarray(pred_labels)[roi_mask]
    colors = generate_colors(num_classes)
    panels = 2 + (pred_labels is not None)
    fig, axes = _fig(panels)
    _scatter(axes[0], pts, np.clip(rgb, 0, 1), "rgb")
    _scatter(axes[1], pts, colors[np.clip(labels, 0, num_classes - 1)],
             "gt segmentation")
    if pred_labels is not None:
        pred = np.asarray(pred_labels).astype(int)
        acc = float((pred == labels).mean())
        _scatter(axes[2], pts,
                 colors[np.clip(pred, 0, num_classes - 1)],
                 f"predicted (acc {acc:.3f})")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


# the reference's hand-tuned EE box (viz_ee-bbox.py:84-90): extent and the
# +3 cm approach-axis offset are the task constants it visualizes
EE_BBOX_EXTENT = np.array([0.15, 0.27, 0.18])
EE_BBOX_OFFSET = np.array([0.0, 0.0, 0.03])


def viz_ee_bbox(sample, out_png, pose_xyzw=None):
    """Cloud + camera frame + EE frame + oriented EE bbox; prints the
    point counts the reference prints (viz_ee-bbox.py:45-47, 133)."""
    plt = _plt()
    pts = np.asarray(sample["points"])
    rgb = np.clip(np.asarray(sample["rgb"]), 0, 1)
    labels = np.asarray(sample.get("labels"))
    pose = _xyzw_to_wxyz(pose_xyzw if pose_xyzw is not None
                         else sample["pose"])
    rot = _quat_matrix(pose[3:7])
    center = pose[:3] + rot @ EE_BBOX_OFFSET

    n_arm = int((labels == 1).sum()) if labels is not None else 0
    print(f"# of points: {len(pts)}")
    print(f"# of arm points: {n_arm}")

    fig, axes = _fig(2)
    _scatter(axes[0], pts, rgb, "rgb + frames",
             pose=np.concatenate([[0, 0, 0], [1, 0, 0, 0]]))
    _draw_frame(axes[0], pose, size=0.25)
    corners = _draw_bbox(axes[0], center, rot, EE_BBOX_EXTENT)

    # in-box mask (OrientedBoundingBox.get_point_indices_within_bounding_box)
    local = (pts - center) @ rot
    inside = (np.abs(local) <= EE_BBOX_EXTENT / 2).all(axis=1)
    print(f"# of masked points: {int(inside.sum())}")
    col = np.where(inside[:, None], [[1.0, 0.2, 0.2]], [[0.7, 0.7, 0.7]])
    _scatter(axes[1], pts, col, f"EE bbox crop ({int(inside.sum())} pts)")
    _draw_bbox(axes[1], center, rot, EE_BBOX_EXTENT)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return inside


def viz_pcd(path_or_points, out_png, rgb=None):
    """View a .pcd file / raw array (visualization/viz_pcd.py)."""
    plt = _plt()
    if isinstance(path_or_points, (str, bytes)):
        from ..data.rgbd import read_pcd

        pts, rgb = read_pcd(path_or_points)
    else:
        pts = np.asarray(path_or_points)
    if rgb is None:
        z = pts[:, 2]
        zn = (z - z.min()) / max(float(np.ptp(z)), 1e-9)
        rgb = plt.cm.viridis(zn)[:, :3]
    fig, axes = _fig(1)
    _scatter(axes[0], pts, np.clip(rgb, 0, 1), f"{len(pts)} points")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def viz_pickle(sample, out_png, keypoints=None):
    """Sample pickle: rgb cloud + EE pose frame (+ keypoint markers) —
    covers viz_pickle.py and its _refined/_cad variants headlessly."""
    plt = _plt()
    pts = np.asarray(sample["points"])
    rgb = np.clip(np.asarray(sample["rgb"]), 0, 1)
    pose = _xyzw_to_wxyz(sample["pose"])
    fig, axes = _fig(1)
    _scatter(axes[0], pts, rgb, "sample + EE pose", pose=pose)
    if keypoints is not None:
        kp = np.asarray(keypoints)
        axes[0].scatter(kp[:, 0], kp[:, 1], kp[:, 2], c="red", s=40,
                        marker="*")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def viz_cross_section(sample, out_png, cutoff=0.008):
    """EE cross-section bands: points closest to the gripper's approach
    line (viz_cross_section.py, utils select_closest_points_to_line)."""
    plt = _plt()
    from ..data.labels import select_closest_points_to_line

    pts = np.asarray(sample["points"])
    rgb = np.clip(np.asarray(sample["rgb"]), 0, 1)
    pose = _xyzw_to_wxyz(sample["pose"])
    rot = _quat_matrix(pose[3:7])
    p0 = pose[:3]
    fig, axes = _fig(2)
    _scatter(axes[0], pts, rgb, "cloud + section lines", pose=pose)
    col = np.full_like(rgb, 0.75)
    for axis, c in zip(rot.T, ([1, 0, 0], [0, 0.8, 0], [0, 0, 1])):
        lp1, lp2 = p0 - axis * 0.2, p0 + axis * 0.2
        _, idx = select_closest_points_to_line(pts, lp1, lp2, cutoff=cutoff)
        col[idx] = c
        axes[0].plot(*np.stack([lp1, lp2]).T, color=c, linewidth=1.0)
    _scatter(axes[1], pts, col, "cross-section membership")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def viz_data_instances(samples, out_png, max_panels=6):
    """Instance-colored clouds, one panel per sample (viz_data-instances.py
    and viz_test-data-instances.py)."""
    plt = _plt()
    samples = samples[:max_panels]
    fig, axes = _fig(len(samples))
    for ax, s in zip(axes, samples):
        pts = np.asarray(s["points"])
        inst = np.asarray(s.get("instance_labels",
                                s.get("labels"))).astype(int)
        n_inst = max(int(inst.max()) + 1, 1)
        colors = generate_colors(n_inst)
        _scatter(ax, pts, colors[np.clip(inst, 0, n_inst - 1)],
                 f"{n_inst} instances")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def viz_data_collection_positions(samples, out_png):
    """Per-sample camera poses in the robot-base frame
    (viz_data-collection-positions.py): cam2base = ee2base ∘ ee2cam^-1.
    Pure numpy (viewers must never dispatch to the accelerator).
    Returns the camera poses and prints their position spread."""
    plt = _plt()
    from ..data.synthetic import _mat_to_pose

    def mat(pose_wxyz):
        m = np.eye(4)
        m[:3, :3] = _quat_matrix(pose_wxyz[3:7])
        m[:3, 3] = pose_wxyz[:3]
        return m

    def inv(m):
        out = np.eye(4)
        out[:3, :3] = m[:3, :3].T
        out[:3, 3] = -m[:3, :3].T @ m[:3, 3]
        return out

    cams = []
    for s in samples:
        ee2cam = _xyzw_to_wxyz(s["pose"])
        ee2base = np.asarray(s.get("ee2base_pose",
                                   s.get("robot2ee_pose")), np.float64)
        cams.append(_mat_to_pose(mat(ee2base) @ inv(mat(ee2cam))))
    cams = np.stack(cams)
    spread = cams[:, :3].std(axis=0)
    print(f"camera position spread (m): {spread}")

    fig, axes = _fig(1)
    axes[0].scatter(cams[:, 0], cams[:, 1], cams[:, 2], c="tab:blue", s=30)
    for c in cams:
        _draw_frame(axes[0], c, size=0.1)
    _draw_frame(axes[0], np.array([0, 0, 0, 1, 0, 0, 0]), size=0.3)
    axes[0].set_title(f"{len(cams)} collection positions (base frame)",
                      fontsize=9)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return cams
