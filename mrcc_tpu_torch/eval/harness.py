"""Evaluation harnesses (port of ``mrcc_tpu/eval/harness.py``): the
reference's ``test*.py`` logic as functions over a dataset's batches.

- :func:`evaluate_pose`: per-instance pose distances, summaries per
  position and overall;
- :func:`evaluate_segmentation`: per-instance accuracy / precision /
  recall of point labels sliced back from the voxels;
- :func:`evaluate_key_points`: mean L2 error of the found keypoints
  against the geometric ground truth;
- :func:`evaluate_vote`: distance of the voted centre to the EE position.

Every harness runs one forward a batch, as the JAX one's jitted program:
voxelize -> ``build_hierarchy`` of depth 4 at capacities ``(cap,
max(cap // 2, 64), max(cap // 4, 64), max(cap // 8, 64))`` with neighbour
tables on every level (the JAX harness builds its hierarchy without the
self-keyed route) -> the model in eval mode, in f32 under ``no_grad``.  On
the card that runs the sort kernel, the rank kernel, the k3-table conv and
K3's down / up convs.  The model moves to ``device``: the card unless the
caller passes ``device="cpu"``.  The summaries are host-side numpy.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch

from ..data.labels import get_6_key_points, get_key_points
from ..device import resolve_device
from ..geometry.metrics import compute_pose_dist, compute_segmentation_metrics
from ..solve import key_point_predictions, pred_center
from ..sparse import build_hierarchy, slice_to_points, voxelize


def _summary(values):
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return {"count": 0}
    return {"count": int(len(values)), "avg": float(values.mean()),
            "min": float(values.min()), "max": float(values.max()),
            "med": float(np.median(values)), "std": float(values.std())}


class Forward:
    """``forward(batch) -> (out, point_to_voxel)`` of ``model`` on
    ``device`` (module moved there, eval mode)."""

    def __init__(self, model, data_cfg, voxel_capacity, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.qsize = data_cfg.quantization_size
        self.capacity = c = voxel_capacity
        self.caps = (c, max(c // 2, 64), max(c // 4, 64), max(c // 8, 64))

    def tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def __call__(self, batch):
        with torch.no_grad():
            vox, pv = voxelize(self.tensor(batch["points"], torch.float32),
                               self.tensor(batch["feats"], torch.float32),
                               self.tensor(batch["mask"], torch.bool),
                               self.qsize, self.capacity)
            levels = build_hierarchy(vox, 4, capacities=self.caps,
                                     k3_tables=(True,) * 5)
            return self.model(vox.feats, levels), pv


def _point_logits(forward, batch):
    logits, pv = forward(batch)
    return slice_to_points(logits.float(), pv, fill_value=-1e9)


def _dump(result, out_path):
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def _name(other):
    return str(other.get("filename", ""))


def evaluate_pose(model, dataset, voxel_capacity=4096, batch_size=8,
                  position_voxelization=1.0, out_path=None, device=None):
    """Pose regression: per instance ``dist``, ``dist_position``,
    ``dist_orientation``, ``angle_diff``; summaries of the position and
    angle errors per position and overall."""
    forward = Forward(model, dataset.cfg, voxel_capacity, device)
    records = []
    for batch in dataset.batches(batch_size, shuffle=False):
        out, _ = forward(batch)
        dist, dpos, dori, ang = (x.cpu().numpy() for x in compute_pose_dist(
            forward.tensor(batch["pose"], torch.float32), out[:, :7].float(),
            position_voxelization=position_voxelization))
        for i, other in enumerate(batch["others"]):
            records.append({
                "file": _name(other),
                "position": str(other.get("position", "p1")),
                "dist": float(dist[i]), "dist_position": float(dpos[i]),
                "dist_orientation": float(dori[i]),
                "angle_diff": float(ang[i])})
    by_pos = defaultdict(list)
    for r in records:
        by_pos[r["position"]].append(r)
    keys = ("dist_position", "angle_diff")
    return _dump({
        "instances": records,
        "overall": {k: _summary([r[k] for r in records]) for k in keys},
        "positions": {p: {k: _summary([r[k] for r in rs]) for k in keys}
                      for p, rs in by_pos.items()}}, out_path)


def evaluate_segmentation(model, dataset, voxel_capacity=8192, batch_size=4,
                          num_classes=3, out_path=None, device=None):
    """Segmentation: per instance accuracy, precision, recall and the
    per-class results over its valid points; summaries overall."""
    forward = Forward(model, dataset.cfg, voxel_capacity, device)
    records = []
    for batch in dataset.batches(batch_size, shuffle=False):
        preds = _point_logits(forward, batch).argmax(-1).cpu()
        for i, other in enumerate(batch["others"]):
            m = torch.as_tensor(batch["mask"][i])
            res = compute_segmentation_metrics(
                torch.as_tensor(batch["labels"][i])[m], preds[i][m],
                num_classes=num_classes)
            records.append({
                "file": _name(other),
                "position": str(other.get("position", "p1")),
                "accuracy": float(res["accuracy"]),
                "precision": float(res["precision"]),
                "recall": float(res["recall"]),
                "class_results": {
                    cn: {k: float(v) for k, v in cr.items()}
                    for cn, cr in res["class_results"].items()}})
    return _dump({
        "instances": records,
        "overall": {k: _summary([r[k] for r in records])
                    for k in ("accuracy", "precision", "recall")}}, out_path)


def evaluate_key_points(model, dataset, voxel_capacity=4096, batch_size=8,
                        conf_threshold=0.75, num_keypoints=6, out_path=None,
                        device=None):
    """Keypoints: per instance the mean L2 error of the found keypoints
    (``kp_error`` 100 where none is found) and their count."""
    forward = Forward(model, dataset.cfg, voxel_capacity, device)
    gen = get_6_key_points if num_keypoints == 6 else get_key_points
    records = []
    for batch in dataset.batches(batch_size, shuffle=False):
        kp_idx, kp_found, _ = key_point_predictions(
            _point_logits(forward, batch),
            forward.tensor(batch["mask"], torch.bool),
            conf_threshold=conf_threshold)
        kp_idx, kp_found = kp_idx.cpu().numpy(), kp_found.cpu().numpy()
        for i, other in enumerate(batch["others"]):
            pts = batch["points"][i]
            gt_kps, _ = gen(pts[batch["mask"][i]], batch["pose"][i])
            if len(gt_kps) == 0:
                continue
            found = np.where(kp_found[i])[0]
            if len(found) == 0:
                records.append({"file": _name(other), "kp_error": 100.0,
                                "found": 0})
                continue
            err = np.linalg.norm(gt_kps[found] - pts[kp_idx[i][found]],
                                 axis=-1).mean()
            records.append({"file": _name(other), "kp_error": float(err),
                            "found": int(len(found))})
    return _dump({"instances": records,
                  "overall": {"kp_error": _summary([r["kp_error"]
                                                    for r in records])}},
                 out_path)


def evaluate_vote(model, dataset, voxel_capacity=4096, batch_size=8,
                  ee_r=0.02, out_path=None, device=None):
    """Voting: per instance the distance of the voted centre
    (``pred_center`` of each item) to the ground-truth EE position."""
    forward = Forward(model, dataset.cfg, voxel_capacity, device)
    records = []
    for batch in dataset.batches(batch_size, shuffle=False):
        logits = _point_logits(forward, batch)
        points = forward.tensor(batch["points"], torch.float32)
        mask = forward.tensor(batch["mask"], torch.bool)
        centers = torch.stack([pred_center(lg, p, m, ee_r=ee_r) for lg, p, m
                               in zip(logits, points, mask)]).cpu().numpy()
        for i, other in enumerate(batch["others"]):
            d = float(np.linalg.norm(centers[i] - batch["pose"][i][:3]))
            records.append({"file": _name(other), "center_dist": d})
    return _dump({"instances": records,
                  "overall": {"center_dist": _summary([r["center_dist"]
                                                       for r in records])}},
                 out_path)
