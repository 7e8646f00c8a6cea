"""Labelled scenes for segmentation training (the port's counterpart of
``mrcc_tpu/data/dataset.py``, restricted to the synthetic scenes).

``DataConfig`` holds the DATA fields the segmentation trainer reads;
``SceneDataset`` centres each scene as the JAX dataset does
(``_post_point_ops``, ``center_at_origin``), pads it into fixed
``max_points`` rows with a mask (``collate``) and iterates batches in a
seeded order (``batches``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import generate_sample


@dataclasses.dataclass
class DataConfig:
    """DATA section (``config/default.yaml``): voxel size ``1 / scale``."""

    scale: float = 100.0
    max_points: int = 65536
    ignore_label: int = -100
    classes: int = 3
    center_at_origin: bool = True

    @property
    def quantization_size(self) -> float:
        return 1.0 / self.scale


class SceneDataset:
    """``n_scenes`` scenes of ``generate_sample(seed + i, **sample_kw)``,
    generated once: ``points``, ``feats`` (RGB) and ``labels`` (int32)."""

    def __init__(self, cfg: DataConfig, n_scenes: int, seed: int = 0,
                 **sample_kw):
        self.cfg = cfg
        self.items = []
        for i in range(n_scenes):
            s = generate_sample(seed=seed + i, **sample_kw)
            points = s["points"]
            if cfg.center_at_origin:
                points = points - (points.max(0) + points.min(0)) / 2
            self.items.append({"points": points.astype(np.float32),
                               "feats": s["rgb"].astype(np.float32),
                               "labels": s["labels"].astype(np.int32)})

    def __len__(self):
        return len(self.items)

    def collate(self, items):
        """Stack items into ``max_points`` rows with a mask; padding rows
        carry ``ignore_label``."""
        p = self.cfg.max_points
        b = len(items)
        points = np.zeros((b, p, 3), np.float32)
        feats = np.zeros((b, p, items[0]["feats"].shape[-1]), np.float32)
        labels = np.full((b, p), self.cfg.ignore_label, np.int32)
        mask = np.zeros((b, p), bool)
        for k, it in enumerate(items):
            n = min(len(it["points"]), p)
            points[k, :n] = it["points"][:n]
            feats[k, :n] = it["feats"][:n]
            labels[k, :n] = it["labels"][:n]
            mask[k, :n] = True
        return {"points": points, "feats": feats, "labels": labels,
                "mask": mask}

    def batches(self, batch_size, shuffle=True, seed=0, drop_last=False):
        """Batches in a seeded order (``np.random.default_rng(seed)``)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s:s + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            yield self.collate([self.items[int(i)] for i in idx])
