"""AliveV1 dataset (port of ``mrcc_tpu/data/alivev1.py``): the older
tuple-pickle schema on the padded pipeline of ``AliveV2Dataset``.

- files by folder glob ``<folder>/<set_name>/*<suffix>``, filtered by
  :func:`filter_filename` (no ``_semantic.pickle`` sidecars, no "dark"
  captures, an optional prefix);
- tuple pickles ``(points, rgb, labels, instance_labels, pose)`` (dicts are
  read too), with an optional ``*_semantic.pickle`` prediction sidecar;
- the pose stored XYZW, turned WXYZ by inserting w at index 3;
- the ``full_scale`` crop: points whose scaled coordinates leave the grid
  (``|p| >= full_scale[1] / 2 / scale``) are dropped.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from .dataset import AliveV2Dataset, DataConfig


def filter_filename(filepath: str, prefix: str = "") -> bool:
    """v1 eligibility: no semantic sidecars, no dark captures, optional
    prefix."""
    name = filepath.split("/")[-1]
    if name.endswith("_semantic.pickle"):
        return False
    if "dark" in name:
        return False
    if prefix and not name.startswith(prefix):
        return False
    return True


class AliveV1Dataset(AliveV2Dataset):
    """Tuple-pickle items with v1 semantics; ``collate`` / ``batches`` are
    the AliveV2 ones.  Unpickling runs code: read only pickles this
    project wrote."""

    def __init__(self, folder=None, set_name="train", file_names=None,
                 cfg: DataConfig = None, suffix=".pickle", prefix="",
                 full_scale=(128, 512), semantic_enabled=False, **kw):
        self.folder = folder
        self.set_name = set_name
        self.suffix = suffix
        self.prefix = prefix
        self.full_scale = tuple(full_scale)
        self.semantic_enabled = semantic_enabled
        names = list(file_names or ())
        if not names and folder:
            names = sorted(glob.glob(
                os.path.join(folder, set_name, f"*{suffix}")))
        names = [n for n in names if filter_filename(n, prefix)]
        super().__init__(files=[{"filepath": n} for n in names], cfg=cfg,
                         **kw)

    def load_data_file(self, i):
        """``(sample, semantic_pred, path)``."""
        path = self.files[i]["filepath"]
        with open(path, "rb") as f:
            x = pickle.load(f, encoding="bytes")
        semantic_pred = None
        if self.semantic_enabled:
            with open(path.replace(".pickle", "_semantic.pickle"),
                      "rb") as f:
                semantic_pred = pickle.load(f, encoding="bytes")
        return x, semantic_pred, path

    def __getitem__(self, i):
        x, semantic_pred, path = self.load_data_file(i)
        if isinstance(x, dict):
            points, rgb, labels, pose = (x["points"], x["rgb"], x["labels"],
                                         x["pose"])
        else:
            points, rgb, labels, pose = x[0], x[1], x[2], x[4]
        points = np.asarray(points, np.float32)
        rgb = np.asarray(rgb, np.float32)
        labels = np.asarray(labels, np.float32)
        pose = np.asarray(pose, np.float32)
        pose = np.insert(pose[:6], 3, pose[-1])     # XYZW -> WXYZ

        lim = self.full_scale[1] / 2.0 / self.cfg.scale
        m = np.all(np.abs(points) < lim, axis=-1)
        if m.sum() < 1:
            return None
        points, rgb, labels = points[m], rgb[m], labels[m]
        if semantic_pred is not None:
            semantic_pred = np.asarray(semantic_pred)[m]
        n = min(len(points), self.cfg.max_points)
        return {
            "points": points[:n],
            "feats": rgb[:n],
            "labels": labels[:n].astype(np.int32),
            "pose": pose.astype(np.float32),
            "other": {"filename": path.split("/")[-1],
                      "semantic_pred": semantic_pred},
        }
