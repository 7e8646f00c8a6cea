"""Labelled synthetic data for the trainers (the port's counterpart of
``mrcc_tpu/data/dataset.py``, restricted to the synthetic scenes and
without augmentation).

``DataConfig`` holds the DATA fields the trainers read.  ``SceneDataset``
serves whole scenes for segmentation (the JAX segmentation main sets
``data_type`` to None): colours rescued and points centred as
``AliveV2Dataset._load_item`` and ``_post_point_ops`` do.
``PoseDataset`` serves pose items as ``AliveV2Dataset._load_item`` builds
them: the label pose in WXYZ, the crop to the EE (label 2) for
``data_type="ee_seg"``, the colour rescue, ``voxelize_position``,
``move_ee_to_origin`` and ``center_at_origin``.  Both
pad items into fixed ``max_points`` rows with a mask (:func:`collate`) and
iterate batches in a seeded order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .synthetic import generate_sample, quat_to_matrix_np


@dataclasses.dataclass
class DataConfig:
    """DATA section (``config/default.yaml``): voxel size ``1 / scale``."""

    scale: float = 100.0
    max_points: int = 65536
    data_type: Optional[str] = "ee_seg"  # None | 'ee_seg' (pose items)
    ignore_label: int = -100
    classes: int = 3
    center_at_origin: bool = True
    move_ee_to_origin: bool = False
    voxelize_position: bool = False

    @property
    def quantization_size(self) -> float:
        return 1.0 / self.scale


def collate(items, cfg: DataConfig):
    """Stack items into ``max_points`` rows with a mask; padding rows carry
    ``ignore_label``.  Items with a ``pose`` add ``pose [B, 7]`` and
    ``joint_angles [B, 9]``."""
    p = cfg.max_points
    b = len(items)
    points = np.zeros((b, p, 3), np.float32)
    feats = np.zeros((b, p, items[0]["feats"].shape[-1]), np.float32)
    labels = np.full((b, p), cfg.ignore_label, np.int32)
    mask = np.zeros((b, p), bool)
    for k, it in enumerate(items):
        n = min(len(it["points"]), p)
        points[k, :n] = it["points"][:n]
        feats[k, :n] = it["feats"][:n]
        labels[k, :n] = it["labels"][:n]
        mask[k, :n] = True
    out = {"points": points, "feats": feats, "labels": labels, "mask": mask}
    if "pose" in items[0]:
        out["pose"] = np.stack([it["pose"][:7] for it in items])
        out["joint_angles"] = np.stack([it["joint_angles"] for it in items])
    return out


def rescue_colours(rgb):
    """``AliveV2Dataset._load_item``'s colour rescue: colours with a
    negative value are min-max scaled into [0, 1] per channel, and colours
    in [0, 1] are centred to [-0.5, 0.5]."""
    if len(rgb) > 0:
        if rgb.min() < 0:
            mn, mx = rgb.min(0), rgb.max(0)
            rgb = (rgb - mn) / np.maximum(mx - mn, 1e-12)
        if rgb.min() > -1e-6 and rgb.max() < 1 + 1e-6:
            rgb = rgb - 0.5
    return rgb


def _batches(dataset, batch_size, shuffle, seed, drop_last):
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for s in range(0, len(order), batch_size):
        idx = order[s:s + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield dataset.collate([dataset.items[int(i)] for i in idx])


class SceneDataset:
    """``n_scenes`` scenes of ``generate_sample(seed + i, **sample_kw)``,
    generated once: ``points``, ``feats`` (RGB after the colour rescue,
    :func:`rescue_colours`) and ``labels`` (int32)."""

    def __init__(self, cfg: DataConfig, n_scenes: int, seed: int = 0,
                 **sample_kw):
        self.cfg = cfg
        self.items = []
        for i in range(n_scenes):
            s = generate_sample(seed=seed + i, **sample_kw)
            points = s["points"]
            if cfg.center_at_origin:
                points = points - (points.max(0) + points.min(0)) / 2
            rgb = rescue_colours(np.asarray(s["rgb"], np.float32))
            self.items.append({"points": points.astype(np.float32),
                               "feats": rgb.astype(np.float32),
                               "labels": s["labels"].astype(np.int32)})

    def __len__(self):
        return len(self.items)

    def collate(self, items):
        return collate(items, self.cfg)

    def batches(self, batch_size, shuffle=True, seed=0, drop_last=False):
        """Batches in a seeded order (``np.random.default_rng(seed)``)."""
        return _batches(self, batch_size, shuffle, seed, drop_last)


def pose_item(sample, cfg: DataConfig):
    """One pose item from a sample dict (``points``, ``rgb``, ``labels``,
    ``pose`` XYZW, ``joint_angles``), the ``ee_seg`` / full-scene branch of
    ``AliveV2Dataset._load_item`` and ``_post_point_ops``; None for an EE
    crop without EE points."""
    points = np.asarray(sample["points"], np.float32)
    rgb = np.asarray(sample["rgb"], np.float32)
    labels = np.asarray(sample["labels"], np.float32).reshape(-1)
    pose = np.asarray(sample["pose"], np.float32).reshape(-1)
    pose = np.concatenate([pose[:3], pose[6:7], pose[3:6]])  # XYZW -> WXYZ
    if cfg.data_type == "ee_seg":
        sel = np.where(labels == 2)[0]
        if len(sel) < 1:
            return None
        points, rgb, labels = points[sel], rgb[sel], labels[sel]
    elif cfg.data_type is not None:
        raise NotImplementedError(f"data_type {cfg.data_type!r}: the port "
                                  "serves None and 'ee_seg'")
    rgb = rescue_colours(rgb)
    if cfg.voxelize_position:
        pose[:3] /= cfg.quantization_size
    if cfg.data_type == "ee_seg" and cfg.move_ee_to_origin:
        stacked = np.concatenate([points, pose[None, :3]]) @ \
            quat_to_matrix_np(pose[3:7])
        pose[:3] = stacked[-1]
        points = stacked[:-1]
    if cfg.center_at_origin:
        offset = (points.max(0) + points.min(0)) / 2
        points = points - offset
        pose[:3] -= offset
    ja = sample.get("joint_angles")
    return {"points": points.astype(np.float32),
            "feats": rgb.astype(np.float32),
            "labels": labels.astype(np.int32),
            "pose": pose.astype(np.float32),
            "joint_angles": (np.zeros(9, np.float32) if ja is None
                             else np.asarray(ja, np.float32))}


class PoseDataset:
    """Pose items (:func:`pose_item`) of ``n_samples`` scenes of
    ``generate_sample(seed + i, **sample_kw)``, generated once; samples
    whose crop is empty are dropped."""

    def __init__(self, cfg: DataConfig, n_samples: int, seed: int = 0,
                 **sample_kw):
        self.cfg = cfg
        items = (pose_item(generate_sample(seed=seed + i, **sample_kw), cfg)
                 for i in range(n_samples))
        self.items = [it for it in items if it is not None]

    def __len__(self):
        return len(self.items)

    def collate(self, items):
        return collate(items, self.cfg)

    def batches(self, batch_size, shuffle=True, seed=0, drop_last=False):
        """Batches in a seeded order (``np.random.default_rng(seed)``)."""
        return _batches(self, batch_size, shuffle, seed, drop_last)
