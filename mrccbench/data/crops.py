"""End-effector crops with their pose labels, numpy only: the pose trainer's
input, made from the benchmark's frozen scenes (:mod:`.scenes`).

A crop is the points of one scene labelled end-effector (label 2), in the
scene's own order, with their colours moved from [0, 1] to [-0.5, 0.5];
its label is the scene's end-effector pose ``[x, y, z, qw, qx, qy, qz]``,
drawn first from the scene's seed, so it is re-derived here from that seed
alone.  The crop is then centred on the middle of its bounding box and the
label's position moves with it.  :func:`pose_batch` lays crops out as the
port's pose collate lays out its ``ee_seg`` items: ``max_points`` rows a
crop with a mask, the ignore label on padding rows, ``pose [B, 7]`` and
``joint_angles [B, 9]`` (zeros: the scenes have none).
"""

from __future__ import annotations

import numpy as np

from . import scenes

EE_LABEL = 2
JOINT_ANGLES = 9


def ee_pose(seed) -> np.ndarray:
    """The end-effector pose of :func:`scenes.scene` ``(seed)``, WXYZ,
    float32: the first draw of the scene's generator."""
    return scenes._random_pose(np.random.default_rng(seed)).astype(
        np.float32)


def crop(seed, n_ee, n_arm, n_bg):
    """``(points [n, 3], feats [n, 3], labels [n], pose [7])``, float32
    and int32, of the end-effector crop of one scene, centred."""
    points, rgb, labels = scenes.scene(seed, n_ee=n_ee, n_arm=n_arm,
                                       n_bg=n_bg)
    keep = labels == EE_LABEL
    points, rgb, labels = points[keep], rgb[keep], labels[keep]
    pose = ee_pose(seed)
    offset = (points.max(0) + points.min(0)) / 2
    pose[:3] -= offset
    return points - offset, rgb - np.float32(0.5), labels, pose


def pose_batch(seeds, max_points, n_ee, n_arm, n_bg):
    """One pose batch of the crops of ``seeds``: ``{points, feats,
    labels, mask, pose, joint_angles}`` numpy arrays, ``max_points`` rows
    a crop."""
    b = len(seeds)
    out = {"points": np.zeros((b, max_points, 3), np.float32),
           "feats": np.zeros((b, max_points, 3), np.float32),
           "labels": np.full((b, max_points), scenes.IGNORE_LABEL, np.int32),
           "mask": np.zeros((b, max_points), bool),
           "pose": np.zeros((b, 7), np.float32),
           "joint_angles": np.zeros((b, JOINT_ANGLES), np.float32)}
    for i, s in enumerate(seeds):
        p, f, lab, pose = crop(s, n_ee, n_arm, n_bg)
        n = min(len(p), max_points)
        out["points"][i, :n] = p[:n]
        out["feats"][i, :n] = f[:n]
        out["labels"][i, :n] = lab[:n]
        out["mask"][i, :n] = True
        out["pose"][i] = pose
    return out
