"""Pose, segmentation and keypoint metrics (port of
``mrcc_tpu/geometry/metrics.py``)."""

from __future__ import annotations

import math

import torch

from .quaternion import qconj, qmul
from .transform import qnormalize, quat_to_matrix


def compute_pose_dist(gt, pred, position_voxelization=1.0):
    """Batched pose distances; the inputs are not modified (the reference
    scales ``gt`` in place, which the JAX package fixed).

    Args:
      gt: [B, 7] ``[x, y, z, qw, qx, qy, qz]``.
      pred: [B, >= 7] (columns past 7, the confidences, are ignored).
    Returns ``(dist, dist_position, dist_orientation, angle_diff)``, each
    [B].
    """
    pred = pred[..., :7]
    position = gt[..., :3] * position_voxelization
    position_pred = pred[..., :3] * position_voxelization
    orientation, orientation_pred = gt[..., 3:7], pred[..., 3:7]
    dist = torch.linalg.vector_norm(
        torch.cat([position, orientation], -1)
        - torch.cat([position_pred, orientation_pred], -1), dim=-1)
    dist_position = torch.linalg.vector_norm(position - position_pred, dim=-1)
    dist_orientation = torch.minimum(
        torch.linalg.vector_norm(orientation - orientation_pred, dim=-1),
        torch.linalg.vector_norm(orientation + orientation_pred, dim=-1))
    inner = (qnormalize(orientation) * qnormalize(orientation_pred)).sum(-1)
    angle_diff = torch.acos(torch.clamp(2.0 * inner ** 2 - 1.0, -1.0, 1.0))
    return dist, dist_position, dist_orientation, angle_diff


def compute_pose_metrics(gt, pred):
    """``{"dist_position", "angle_diff"}`` of poses (batched over leading
    dims; the JAX function takes one pose), the relative angle in its atan2
    form folded into [0, pi]."""
    dist_position = torch.linalg.vector_norm(gt[..., :3] - pred[..., :3],
                                             dim=-1)
    q_rel = qmul(qnormalize(gt[..., 3:7]), qconj(qnormalize(pred[..., 3:7])))
    angle = (2.0 * torch.atan2(torch.linalg.vector_norm(q_rel[..., 1:],
                                                        dim=-1),
                               q_rel[..., 0])).abs()
    angle = torch.minimum(angle, 2 * math.pi - angle)
    return {"dist_position": dist_position, "angle_diff": angle}


def compute_segmentation_metrics(gt, pred, num_classes=3, mask=None,
                                 classes=("background", "arm", "ee")):
    """Per-class accuracy / precision / recall and the reference's summary,
    with its quirks: precision (recall) is 1 where a class has no false
    positive (negative); "accuracy" is (sensitivity + specificity) / 2 over
    the class-summed confusion counts.  ``mask``: validity of padded rows.
    Values are 0-d f32 tensors."""
    if mask is None:
        mask = torch.ones(gt.shape, dtype=torch.bool, device=gt.device)
    total = mask.sum().float()
    one = torch.ones((), device=gt.device)
    results = {"class_results": {}}
    precisions, recalls = [], []
    tp_sum = tn_sum = fp_sum = fn_sum = 0.0
    for ci, cn in enumerate(classes[:num_classes]):
        gt_c = (gt == ci) & mask
        pr_c = (pred == ci) & mask
        tp = (gt_c & pr_c).sum().float()
        tn = total - (gt_c | pr_c).sum().float()
        fp = pr_c.sum().float() - tp
        fn = gt_c.sum().float() - tp
        tp_sum, tn_sum = tp_sum + tp, tn_sum + tn
        fp_sum, fn_sum = fp_sum + fp, fn_sum + fn
        accuracy = (tp + tn) / torch.clamp_min(tp + tn + fp + fn, 1.0)
        precision = torch.where(fp == 0, one,
                                tp / torch.clamp_min(tp + fp, 1.0))
        recall = torch.where(fn == 0, one, tp / torch.clamp_min(tp + fn, 1.0))
        results["class_results"][cn] = {"accuracy": accuracy,
                                        "precision": precision,
                                        "recall": recall}
        precisions.append(precision)
        recalls.append(recall)
    sensitivity = tp_sum / torch.clamp_min(tp_sum + fn_sum, 1.0)
    specificity = tn_sum / torch.clamp_min(tn_sum + fp_sum, 1.0)
    results["accuracy"] = (sensitivity + specificity) / 2.0
    results["precision"] = torch.stack(precisions).mean()
    results["recall"] = torch.stack(recalls).mean()
    return results


def compute_kp_error(gt_coords, kp_coords, kp_classes):
    """Mean L2 error of predicted keypoints against the ground-truth
    keypoints of their classes."""
    return torch.linalg.vector_norm(gt_coords[kp_classes] - kp_coords,
                                    dim=-1).mean()


def compute_add(points, gt_pose, pred_pose):
    """Average distance of model points (ADD) under two poses."""
    def place(pose):
        return (torch.einsum("...ij,...nj->...ni",
                             quat_to_matrix(pose[..., 3:7]), points)
                + pose[..., None, :3])

    return torch.linalg.vector_norm(place(gt_pose) - place(pred_pose),
                                    dim=-1).mean(dim=-1)


def rotational_diff(q1, q2, degree=True):
    """``2 acos(|<q1, q2>|)``, in degrees unless ``degree`` is False."""
    diff = 2.0 * torch.acos(torch.clamp((q1 * q2).sum(-1).abs(), 0.0, 1.0))
    return diff * 57.2958 if degree else diff


def translational_diff(t1, t2, cm=True):
    """Euclidean translation difference, in cm unless ``cm`` is False."""
    d = torch.linalg.vector_norm(t1 - t2, dim=-1)
    return d * 100.0 if cm else d
