"""Object clouds with class labels for FeatureNet's metric learning (the
port's copy of ``mrcc_tpu/data/ycb.py``, after the reference's
``data/ycb.py``).  Pickles of YCB object clouds (``points`` and a
``label`` or ``class``) load when ``files`` are given; otherwise a seeded
generator of posed primitives (box, cylinder, sphere shell, plate) stands
in, whose shape family and size encode the class.  No file is read unless
``files`` names it.
"""

from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from .dataset import DataConfig
from .synthetic import _box_surface, _cylinder_surface, quat_to_matrix_np


def synthetic_object_cloud(cls: int, rng, n=2048):
    """A posed primitive cloud whose shape family encodes the class."""
    kind = cls % 4
    scale = 0.04 + 0.02 * (cls % 5)
    if kind == 0:
        pts = _box_surface(rng, [-scale] * 3, [scale] * 3, n)
    elif kind == 1:
        pts = _cylinder_surface(rng, [0, 0, -scale], [0, 0, scale],
                                scale * 0.6, n)
    elif kind == 2:  # sphere shell
        v = rng.normal(size=(n, 3))
        pts = v / np.linalg.norm(v, axis=1, keepdims=True) * scale
    else:  # flat plate
        pts = _box_surface(rng, [-scale, -scale, -0.005],
                           [scale, scale, 0.005], n)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    rot = quat_to_matrix_np(q)
    pts = pts @ rot.T + rng.normal(size=3) * 0.05
    pts += rng.normal(size=pts.shape) * 0.001
    return pts.astype(np.float32)


class YCBDataset:
    """Object clouds with their class: items ``points`` (centred),
    ``feats`` (the points scaled into [-1, 1] per axis) and ``label``;
    :meth:`collate` pads them to ``max_points`` rows with a mask and stacks
    the labels ``[B]``.  ``files``: pickles of ``points`` and a ``label``
    (or ``class``), written by this project (unpickling runs code); else
    ``num_classes * samples_per_class`` clouds of
    :func:`synthetic_object_cloud` from ``seed``."""

    def __init__(self, files: Optional[List[str]] = None, num_classes=21,
                 samples_per_class=8, max_points=2048, seed=0,
                 cfg: DataConfig = None):
        self.cfg = cfg or DataConfig(data_type=None, center_at_origin=True,
                                     max_points=max_points, scale=200)
        self.max_points = max_points
        self.items = []
        if files:
            for f in files:
                with open(f, "rb") as fh:
                    d = pickle.load(fh)
                self.items.append((np.asarray(d["points"], np.float32),
                                   int(d.get("label", d.get("class", 0)))))
        else:
            rng = np.random.default_rng(seed)
            for c in range(num_classes):
                for _ in range(samples_per_class):
                    self.items.append(
                        (synthetic_object_cloud(c, rng, max_points), c))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        pts, cls = self.items[i]
        c = (pts.max(0) + pts.min(0)) / 2
        pts = pts - c
        feats = pts / np.maximum(np.abs(pts).max(0), 1e-12)
        return {"points": pts, "feats": feats.astype(np.float32),
                "label": cls}

    def collate(self, items):
        p = self.max_points
        b = len(items)
        points = np.zeros((b, p, 3), np.float32)
        feats = np.zeros((b, p, 3), np.float32)
        mask = np.zeros((b, p), bool)
        labels = np.zeros((b,), np.int32)
        for k, it in enumerate(items):
            n = min(len(it["points"]), p)
            points[k, :n] = it["points"][:n]
            feats[k, :n] = it["feats"][:n]
            mask[k, :n] = True
            labels[k] = it["label"]
        return {"points": points, "feats": feats, "mask": mask,
                "labels": labels}

    def batches(self, batch_size, shuffle=True, seed=0):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s:s + batch_size]
            yield self.collate([self[int(i)] for i in idx])
