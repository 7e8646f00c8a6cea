"""Fixed-size items for the dense PointNet2 paths (port of
``mrcc_tpu/data/dense.py``, after the reference's
``data/alivev2_dense.py``).

``AliveV2DenseDataset`` serves an ``AliveV2Dataset`` item's first
``num_points``-point sample: uniform (``np.random.default_rng(i).choice``)
or FPS (``labels.farthest_point_sample_idx`` seeded with ``i``), memoised
per item; an item with fewer points is None.  Features are the sampled
coordinates over their largest norm (not centred, as the JAX class
computes them) or the item's own; ``collate`` stacks ``[B, N, ...]``
with an all-true mask.
"""

from __future__ import annotations

import numpy as np

from .dataset import AliveV2Dataset
from .labels import farthest_point_sample_idx


class AliveV2DenseDataset(AliveV2Dataset):
    """``AliveV2Dataset`` items sampled to exactly ``num_points`` points;
    ``sampling`` is ``"uniform"`` or ``"farthest"``."""

    def __init__(self, *args, num_points=2048, sampling="uniform",
                 use_coords_as_features=True, **kw):
        super().__init__(*args, **kw)
        self.num_points = num_points
        self.sampling = sampling
        self.use_coords_as_features = use_coords_as_features
        self._sample_memo = {}

    def __getitem__(self, i):
        item = super().__getitem__(i)
        if item is None:
            return None
        pts = item["points"]
        if len(pts) < self.num_points:
            return None
        if i not in self._sample_memo:
            if self.sampling == "farthest":
                idx = farthest_point_sample_idx(pts, self.num_points, seed=i)
            else:
                idx = np.random.default_rng(i).choice(
                    len(pts), self.num_points, replace=False)
            self._sample_memo[i] = idx
        idx = self._sample_memo[i]
        pts = pts[idx]
        if self.use_coords_as_features:
            feats = pts / np.maximum(np.linalg.norm(pts, axis=-1).max(),
                                     1e-12)
        else:
            feats = item["feats"][idx]
        return {
            "points": pts.astype(np.float32),
            "feats": feats.astype(np.float32),
            "labels": item["labels"][idx],
            "pose": item["pose"],
            "other": item["other"],
        }

    def collate(self, items):
        """Items (None dropped) stacked: ``points [B, N, 3]``, ``feats``,
        ``labels [B, N]`` int32, ``mask`` (all true), ``pose [B, 7]``,
        ``joint_angles [B, 9]`` (zeros where an item has none), ``others``."""
        items = [it for it in items if it is not None]
        b, n = len(items), self.num_points
        c = items[0]["feats"].shape[-1]
        out = {
            "points": np.zeros((b, n, 3), np.float32),
            "feats": np.zeros((b, n, c), np.float32),
            "labels": np.zeros((b, n), np.int32),
            "mask": np.ones((b, n), bool),
            "pose": np.zeros((b, 7), np.float32),
            "joint_angles": np.zeros((b, 9), np.float32),
            "others": [],
        }
        for k, it in enumerate(items):
            out["points"][k] = it["points"]
            out["feats"][k] = it["feats"]
            out["labels"][k] = it["labels"]
            out["pose"][k] = it["pose"][:7]
            ja = it["other"].get("joint_angles")
            if ja is not None:
                out["joint_angles"][k] = ja
            out["others"].append(it["other"])
        return out
