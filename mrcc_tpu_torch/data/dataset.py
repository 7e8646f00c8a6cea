"""Labelled items for the trainers (the port's copy of
``mrcc_tpu/data/dataset.py``, after the reference's ``data/alivev2.py``).

``DataConfig`` holds the DATA fields of the JAX package's config.
``AliveV2Dataset`` serves items from sample pickles or in-memory sample
dicts exactly as the JAX ``AliveV2Dataset`` does: the WXYZ pose, EE labels
derived from the pose where a sample has none, the ``gt_seg`` / ``ee_seg``
crops, the ROI box, the colour rescue, ``voxelize_position``, the voting
cross-section and keypoint labels, augmentation, ``move_ee_to_origin`` /
``center_at_origin`` / ``base_at_origin`` and
``use_coordinates_as_features``.  Items pad into fixed ``max_points``
rows with a mask (:meth:`AliveV2Dataset.collate`); voxelization runs in
the train step on the device.

``SceneDataset`` and ``PoseDataset`` build ``AliveV2Dataset`` items from
the port's synthetic scenes: whole scenes for segmentation and pose items
(EE crops by default) for the pose trainer.

Sample schema: a dict with ``points``, ``rgb``, ``labels``,
``instance_labels``, ``pose`` (XYZW) and ``joint_angles``; the pose turns
WXYZ at load.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import augmentation as aug
from .labels import (collect_closest_points, get_6_key_points,
                     get_ee_cross_section_idx, get_ee_idx, get_key_points,
                     get_roi_mask, quat_to_matrix_np)
from .synthetic import generate_sample

# the EE box of the geometric EE labels (alivev2.py:135-154)
GEOMETRIC_EE_DIM = {"min_z": -0.0, "max_z": 0.13, "min_x": -0.05,
                    "max_x": 0.05, "min_y": -0.14, "max_y": 0.14}


@dataclasses.dataclass
class DataConfig:
    """DATA section (``config/default.yaml:14-65``): voxel size
    ``1 / scale``; ``data_type`` None (whole scenes), ``"gt_seg"`` (the arm,
    label 1) or ``"ee_seg"`` (the EE, label 2)."""

    scale: float = 100.0
    max_points: int = 65536
    data_type: Optional[str] = "ee_seg"
    ignore_label: int = -100
    classes: int = 3
    ee_segmentation_enabled: bool = True
    center_at_origin: bool = True
    base_at_origin: bool = False
    move_ee_to_origin: bool = False
    voxelize_position: bool = False
    voting_enabled: bool = False
    keypoints_enabled: bool = False
    num_of_keypoints: int = 6
    use_coordinates_as_features: bool = False
    augmentation: Sequence[str] = ()
    augmentation_probability: float = 0.2
    roi: Optional[Dict[str, Dict[str, float]]] = None
    roi_offset: float = 0.13

    @property
    def quantization_size(self) -> float:
        return 1.0 / self.scale


def load_sample(path):
    """Unpickle one sample; tuple pickles (alivev1) are accepted too.
    Unpickling runs code: read only pickles this project wrote."""
    with open(path, "rb") as f:
        x = pickle.load(f)
    if isinstance(x, dict):
        return x
    points, rgb, labels, instance_labels, pose = x[:5]
    return {"points": points, "rgb": rgb, "labels": labels,
            "instance_labels": instance_labels, "pose": pose,
            "joint_angles": None}


def filter_file(entry, prefix="") -> bool:
    """Whether a split entry is a sample to train on (alivev2.py:306):
    no ``_semantic`` / ``_eemask`` side files, no ``dark`` captures, and
    the name starts with ``prefix``."""
    filepath = entry["filepath"] if isinstance(entry, dict) else entry
    name = filepath.split("/")[-1]
    if name.endswith("_semantic.pickle") or name.endswith("_eemask.pickle"):
        return False
    if "dark" in name:
        return False
    if prefix and not name.startswith(prefix):
        return False
    return True


def merge_split_files(paths, split="train", prefix=""):
    """The ``split`` entries of one or more split JSONs (a comma-separated
    string or a list of paths), filtered by :func:`filter_file`."""
    entries: List[dict] = []
    for p in str(paths).split(",") if isinstance(paths, str) else paths:
        with open(p) as f:
            data = json.load(f)
        entries.extend(data.get(split, []))
    return [e for e in entries if filter_file(e, prefix=prefix)]


def rescue_colours(rgb):
    """The colour rescue of ``_load_item``: colours with a negative value
    are min-max scaled into [0, 1] per channel, and colours in [0, 1] are
    centred to [-0.5, 0.5]."""
    if len(rgb) > 0:
        if rgb.min() < 0:
            mn, mx = rgb.min(0), rgb.max(0)
            rgb = (rgb - mn) / np.maximum(mx - mn, 1e-12)
        if rgb.min() > -1e-6 and rgb.max() < 1 + 1e-6:
            rgb = rgb - 0.5
    return rgb


class AliveV2Dataset:
    """Items of labelled sample pickles (``files``: paths or split entries
    with a ``filepath``) or in-memory sample dicts (``samples``).
    ``augment`` turns on ``cfg.augmentation`` with draws from
    ``np.random.default_rng(seed)``.  Items are cached after their first
    load unless augmenting (``cache_items``).  An ``ee_seg`` item whose
    crop is empty is None."""

    def __init__(self, files=None, samples=None, cfg: DataConfig = None,
                 augment: bool = False, seed: int = 0, cache_items=None):
        self.cfg = cfg or DataConfig()
        self.files = list(files) if files is not None else None
        self.samples = samples
        self.augmenting = augment
        self.rng = np.random.default_rng(seed)
        self._kp_memo: Dict[int, tuple] = {}
        self._cs_memo: Dict[int, np.ndarray] = {}
        self.cache_items = (not augment) if cache_items is None else cache_items
        self._item_memo: Dict[int, dict] = {}

    def __len__(self):
        return len(self.files) if self.files is not None else len(self.samples)

    def _raw(self, i):
        if self.samples is not None:
            return dict(self.samples[i]), {}
        entry = self.files[i]
        path = entry["filepath"] if isinstance(entry, dict) else entry
        other = dict(entry) if isinstance(entry, dict) else {"filepath": path}
        return load_sample(path), other

    def __getitem__(self, i):
        if self.cache_items and i in self._item_memo:
            return self._item_memo[i]
        item = self._load_item(i)
        if self.cache_items:
            self._item_memo[i] = item
        return item

    def _load_item(self, i):
        cfg = self.cfg
        sample, other = self._raw(i)
        points = np.asarray(sample["points"], np.float32)
        rgb = np.asarray(sample["rgb"], np.float32)
        # a copy: the EE labels below must not write into the sample
        labels = np.array(sample["labels"], np.float32).reshape(-1)
        pose = np.asarray(sample["pose"], np.float32).reshape(-1)
        pose = np.concatenate([pose[:3], pose[6:7], pose[3:6]])  # XYZW -> WXYZ
        joint_angles = sample.get("joint_angles")
        other["filename"] = other.get("filepath", f"sample_{i}")
        other["joint_angles"] = joint_angles
        if "ee2base_pose" in sample:
            other["ee2base_pose"] = np.asarray(sample["ee2base_pose"],
                                               np.float32)

        arm_idx = np.where(labels == 1)[0]
        if cfg.ee_segmentation_enabled or cfg.data_type == "ee_seg":
            if (labels == 2).any():
                ee_idx = np.where(labels == 2)[0]
            else:  # no EE labels: the arm points inside the EE box
                ee_idx = get_ee_idx(points, pose, ee_dim=GEOMETRIC_EE_DIM,
                                    arm_idx=arm_idx)
            labels[ee_idx] = 2

        if cfg.data_type == "gt_seg":
            sel = arm_idx
        elif cfg.data_type == "ee_seg":
            sel = np.where(labels == 2)[0]
            if len(sel) < 1:
                return None
        else:
            sel = slice(None)
        points, rgb, labels = points[sel], rgb[sel], labels[sel]

        if cfg.roi is not None and other.get("position") in cfg.roi:
            m = get_roi_mask(points, offset=cfg.roi_offset,
                             **cfg.roi[other["position"]])
            points, rgb, labels = points[m], rgb[m], labels[m]

        rgb = rescue_colours(rgb)

        if cfg.voxelize_position:
            pose = pose.copy()
            pose[:3] /= cfg.quantization_size

        if cfg.voting_enabled:
            if cfg.keypoints_enabled:
                raise AttributeError(
                    "Voting and keypoint cannot be simultaneously enabled.")
            if i not in self._cs_memo:
                _, cs_idx = get_ee_cross_section_idx(points, pose, count=32,
                                                     cutoff=0.004)
                self._cs_memo[i] = cs_idx
            if cfg.data_type == "ee_seg":
                labels = labels * 0
            labels[self._cs_memo[i]] = 1 if cfg.data_type == "ee_seg" else 3

        if cfg.keypoints_enabled:
            labels = self._keypoint_labels(i, points, pose, labels)

        if self.augmenting and cfg.augmentation:
            points = aug.augment_segmentation(
                points, self.rng, scale=cfg.scale,
                probability=cfg.augmentation_probability,
                **{k: True for k in cfg.augmentation})

        points, pose, other = self._post_point_ops(points, pose, other)

        if cfg.use_coordinates_as_features:
            rgb = points.copy()
            if not cfg.center_at_origin:
                c = (rgb.max(0) + rgb.min(0)) / 2
                rgb = rgb - c
            rgb = rgb / np.maximum(np.abs(rgb).max(0), 1e-12)

        return {
            "points": points.astype(np.float32),
            "feats": rgb.astype(np.float32),
            "labels": labels.astype(np.int32),
            "pose": pose.astype(np.float32),
            "other": other,
        }

    def _keypoint_labels(self, i, points, pose, labels):
        """Per-point keypoint classes (alivev2.py:212-238): the points
        within 6 mm of each found keypoint take its class, the rest
        ``ignore_label``."""
        cfg = self.cfg
        labels = labels * 0 + cfg.ignore_label
        if i not in self._kp_memo:
            gen = get_6_key_points if cfg.num_of_keypoints == 6 else get_key_points
            _, kp_idx = gen(points, pose, ignore_label=cfg.ignore_label)
            if len(kp_idx) == 0:
                self._kp_memo[i] = (np.array([], np.int64),
                                    np.array([], np.int64))
            else:
                real = kp_idx > -1
                kp_classes_real = np.arange(len(kp_idx))[real]
                kp_idx_real = kp_idx[real]
                pcls_idx, p_idx = collect_closest_points(kp_idx_real, points)
                self._kp_memo[i] = (kp_classes_real[pcls_idx], p_idx)
        kp_classes, kp_idx = self._kp_memo[i]
        labels[kp_idx] = kp_classes
        return labels

    def _post_point_ops(self, points, pose, other):
        """``move_ee_to_origin`` (EE crops), then ``center_at_origin`` or
        else ``base_at_origin`` (alivev2.py:192-210); the offsets go into
        ``other``."""
        cfg = self.cfg
        pose = pose.copy()
        if cfg.data_type == "ee_seg" and cfg.move_ee_to_origin:
            rot = quat_to_matrix_np(pose[3:7])
            stacked = np.concatenate([points, pose[None, :3]]) @ rot
            pose[:3] = stacked[-1]
            points = stacked[:-1]
        if cfg.center_at_origin:
            offset = (points.max(0) + points.min(0)) / 2
            points = points - offset
            pose[:3] -= offset
            other["origin_offset"] = offset
        elif cfg.base_at_origin:
            offset = points.min(0)
            points = points - offset
            pose[:3] -= offset
            other["origin_base_offset"] = offset
        return points, pose, other

    def collate(self, items):
        """Items (None dropped) into ``max_points`` rows with a mask:
        ``points``, ``feats``, ``labels`` (padding ``ignore_label``),
        ``mask``, ``pose [B, 7]``, ``joint_angles [B, 9]`` (zeros where an
        item has none) and ``others``."""
        items = [it for it in items if it is not None]
        p = self.cfg.max_points
        b = len(items)
        c = items[0]["feats"].shape[-1]
        points = np.zeros((b, p, 3), np.float32)
        feats = np.zeros((b, p, c), np.float32)
        labels = np.full((b, p), self.cfg.ignore_label, np.int32)
        mask = np.zeros((b, p), bool)
        poses = np.zeros((b, 7), np.float32)
        joint_angles = np.zeros((b, 9), np.float32)
        others = []
        for k, it in enumerate(items):
            n = min(len(it["points"]), p)
            points[k, :n] = it["points"][:n]
            feats[k, :n] = it["feats"][:n]
            labels[k, :n] = it["labels"][:n]
            mask[k, :n] = True
            poses[k] = it["pose"][:7]
            ja = it["other"].get("joint_angles")
            if ja is not None:
                joint_angles[k] = ja
            others.append(it["other"])
        return {"points": points, "feats": feats, "labels": labels,
                "mask": mask, "pose": poses, "joint_angles": joint_angles,
                "others": others}

    def batches(self, batch_size, shuffle=True, drop_last=False, seed=0):
        """Collated batches in a seeded order (``np.random.default_rng
        (seed)``); None items are left out, and a batch left empty is
        skipped."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s:s + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            items = [self[int(i)] for i in idx]
            items = [it for it in items if it is not None]
            if items:
                yield self.collate(items)


def collate(items, cfg: DataConfig):
    """Stack ``SceneDataset`` / ``PoseDataset`` items into ``max_points``
    rows with a mask; padding rows carry ``ignore_label``.  Items with a
    ``pose`` add ``pose [B, 7]`` and ``joint_angles [B, 9]``."""
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


def _batches(dataset, batch_size, shuffle, seed, drop_last):
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for s in range(0, len(order), batch_size):
        idx = order[s:s + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield dataset.collate([dataset.items[int(i)] for i in idx])


def _synthetic(n, seed, sample_kw):
    return [generate_sample(seed=seed + i, **sample_kw) for i in range(n)]


class SceneDataset:
    """Whole scenes (``AliveV2Dataset`` items with ``data_type=None``) of
    ``n_scenes`` scenes of ``generate_sample(seed + i, **sample_kw)``,
    built once: ``points``, ``feats`` (colours after the rescue) and
    ``labels`` (int32)."""

    def __init__(self, cfg: DataConfig, n_scenes: int, seed: int = 0,
                 **sample_kw):
        self.cfg = cfg
        source = AliveV2Dataset(samples=_synthetic(n_scenes, seed, sample_kw),
                                cfg=dataclasses.replace(cfg, data_type=None))
        self.items = [{k: source[i][k] for k in ("points", "feats", "labels")}
                      for i in range(n_scenes)]

    def __len__(self):
        return len(self.items)

    def collate(self, items):
        return collate(items, self.cfg)

    def batches(self, batch_size, shuffle=True, seed=0, drop_last=False):
        """Batches in a seeded order (``np.random.default_rng(seed)``)."""
        return _batches(self, batch_size, shuffle, seed, drop_last)


def _pose_item(item):
    if item is None:
        return None
    ja = item["other"]["joint_angles"]
    return {"points": item["points"], "feats": item["feats"],
            "labels": item["labels"], "pose": item["pose"],
            "joint_angles": (np.zeros(9, np.float32) if ja is None
                             else np.asarray(ja, np.float32))}


def pose_item(sample, cfg: DataConfig):
    """One pose item of a sample dict (``AliveV2Dataset``'s item for
    ``cfg``: an EE crop for ``data_type="ee_seg"``, the EE labels derived
    from the pose where the sample has none), with ``joint_angles`` [9]
    (zeros where the sample has none); None for an empty crop."""
    return _pose_item(AliveV2Dataset(samples=[sample], cfg=cfg)[0])


class PoseDataset:
    """Pose items (:func:`pose_item`) of ``n_samples`` scenes of
    ``generate_sample(seed + i, **sample_kw)``, built once; samples whose
    crop is empty are dropped."""

    def __init__(self, cfg: DataConfig, n_samples: int, seed: int = 0,
                 **sample_kw):
        self.cfg = cfg
        source = AliveV2Dataset(samples=_synthetic(n_samples, seed,
                                                   sample_kw), cfg=cfg)
        items = (_pose_item(source[i]) for i in range(n_samples))
        self.items = [it for it in items if it is not None]

    def __len__(self):
        return len(self.items)

    def collate(self, items):
        return collate(items, self.cfg)

    def batches(self, batch_size, shuffle=True, seed=0, drop_last=False):
        """Batches in a seeded order (``np.random.default_rng(seed)``)."""
        return _batches(self, batch_size, shuffle, seed, drop_last)
