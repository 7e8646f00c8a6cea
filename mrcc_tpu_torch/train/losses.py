"""Training criteria (port of ``mrcc_tpu/train/losses.py``): the
segmentation cross-entropy and the eleven pose criteria of ``LossType``.

Each pose criterion is ``loss(y, y_pred, coords=None, coords_valid=None,
probs=None)`` with ``y`` the [B, >= 7] label poses (WXYZ) and ``y_pred``
the head's output; ``coords`` [B, N, 3] with ``coords_valid`` [B, N] are
the per-item voxel coordinates the shape criteria rotate.  The formulas
are the JAX package's, line by line, with its reference quirks (``cos``
compares positions in both terms, ``cos2`` takes the cosine over the whole
7-vector when the position is on).  Where PyTorch has a near twin that
differs, the port writes the JAX form out: ``_cossim`` clamps each norm
at 1e-6 (not ``F.cosine_similarity``), ``_bce`` clips the probability at
1e-7 and uses ``log1p`` (not ``F.binary_cross_entropy``, which clamps the
log at -100), and the Euler wrap is ``torch.remainder`` (not ``fmod``).

Every mean over the batch goes through ``parallel.mesh``'s ``mean_share``
/ ``global_count``: in a data-parallel step a criterion returns this
rank's share of the global batch's loss (local sum / global count), and
outside one the plain mean.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import partial
from typing import Optional

import torch

from ..geometry.metrics import compute_pose_dist
from ..geometry.quaternion import qeuler, qmul, qnormalize
from ..geometry.transform import quat_to_matrix, rot6d_to_quat
from ..parallel.mesh import global_count, mean_share


class LossType(str, enum.Enum):
    MSE = "mse"
    COS = "cos"
    ANGLE = "angle"
    COS2 = "cos2"
    COS2_6D = "cos2_6d"
    WGEODESIC = "wgeodesic"
    SMOOTHL1 = "smoothl1"
    POSE = "pose"
    SHAPE_MATCH = "shape_match"
    POSE_MATCH = "pose_match"
    KP_POSE_MATCH = "kp_pose_match"


@dataclasses.dataclass
class LossConfig:
    """The STRUCTURE keys the criterion factory reads.
    ``symmetry_flip_axis`` ('x' | 'y' | 'z'): COS2_6D's rotation and
    confidence terms target the better of the label and its 180-degree
    body-frame flip about that axis."""

    loss_type: LossType = LossType.COS2
    reduction: str = "mean"  # 'mean' | 'sum'
    compute_confidence: bool = False
    disable_position: bool = False
    disable_orientation: bool = False
    position_threshold: float = 0.03
    position_ignore_threshold: float = 0.05
    angle_diff_threshold: float = 0.24
    angle_diff_ignore_threshold: float = 0.4
    ignore_label: int = -100
    symmetry_flip_axis: Optional[str] = None


def _reduce(x, reduction):
    return x.sum() if reduction == "sum" else mean_share(x)


def _mse(a, b, reduction):
    return _reduce((a - b) ** 2, reduction)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _cossim(a, b, eps=1e-6):
    na = torch.clamp_min(_norm(a), eps)
    nb = torch.clamp_min(_norm(b), eps)
    return (a * b).sum(-1) / (na * nb)


def _bce(pred, target, mask, reduction):
    """Masked binary cross-entropy on sigmoided inputs."""
    eps = 1e-7
    p = torch.clamp(pred, eps, 1 - eps)
    ll = -(target * torch.log(p) + (1 - target) * torch.log1p(-p))
    m = mask.to(ll.dtype)
    denom = torch.clamp_min(global_count(m.sum()), 1.0)
    return ll @ m / denom if reduction == "mean" else (ll * m).sum()


def angle_loss(q_expected, q_pred, reduction="mean"):
    """Euler-wrap angle loss: |wrap(e2 - e1)| of the zyx angles."""
    e1 = qeuler(q_expected, order="zyx", epsilon=1e-6)
    e2 = qeuler(q_pred, order="zyx", epsilon=1e-6)
    d = torch.remainder(e2 - e1 + math.pi, 2 * math.pi) - math.pi
    return _reduce(d.abs(), reduction)


def cos_loss(y, y_pred, cfg: LossConfig, **_):
    """Position MSE plus a cosine term over the positions (the
    reference's quirk, kept)."""
    loss_coor = _mse(y[:, :3], y_pred[:, :3], cfg.reduction)
    loss_rot = 1.0 - _cossim(y[:, :3], y_pred[:, :3])
    return _reduce(loss_rot, cfg.reduction) + loss_coor


def mse_loss(y, y_pred, cfg: LossConfig, **_):
    return _mse(y[:, : y_pred.shape[-1]], y_pred, cfg.reduction)


def default_loss(y, y_pred, cfg: LossConfig, **_):
    """50 x position MSE + the Euler angle loss (``LossType.ANGLE``)."""
    return 50.0 * _mse(y[:, :3], y_pred[:, :3], cfg.reduction) + angle_loss(
        y[:, 3:7], y_pred[:, 3:7], cfg.reduction)


def _confidence_loss(y7, y_pred7, conf, cfg: LossConfig):
    """BCE of the three confidence heads ``conf`` [B, 3] (position,
    angle, both) against the thresholded distances of ``y_pred7``."""
    _, dist_position, _, angle_diff = compute_pose_dist(y7, y_pred7)
    pos_idx = (dist_position < cfg.position_threshold) | (
        dist_position > cfg.position_ignore_threshold)
    pos_target = (dist_position < cfg.position_threshold).to(conf.dtype)
    loss = _bce(conf[:, 0], pos_target, pos_idx, cfg.reduction)
    ang_idx = (angle_diff < cfg.angle_diff_threshold) | (
        angle_diff > cfg.angle_diff_ignore_threshold)
    ang_target = (angle_diff < cfg.angle_diff_threshold).to(conf.dtype)
    loss = loss + _bce(conf[:, 1], ang_target, ang_idx, cfg.reduction)
    return loss + _bce(conf[:, 2], pos_target * ang_target,
                       pos_idx & ang_idx, cfg.reduction)


def cos2_loss(y, y_pred, cfg: LossConfig, **_):
    """The default training loss: position MSE, 2 x (1 - cosine) over the
    7-vector (quaternion MSE without position), optional confidences."""
    loss = 0.0
    if not cfg.disable_position:
        loss = _mse(y[:, :3], y_pred[:, :3], cfg.reduction)
    if not cfg.disable_orientation:
        if not cfg.disable_position:
            rot = _reduce(1.0 - _cossim(y[:, :7], y_pred[:, :7]),
                          cfg.reduction)
        else:
            rot = _mse(y[:, 3:7], y_pred[:, 3:7], cfg.reduction)
        loss = rot * 2.0 + loss
    if cfg.compute_confidence:
        loss = loss + _confidence_loss(y[:, :7], y_pred[:, :7],
                                       y_pred[:, 7:10], cfg)
    return loss


_FLIP_Q = {"x": (0.0, 1.0, 0.0, 0.0),
           "y": (0.0, 0.0, 1.0, 0.0),
           "z": (0.0, 0.0, 0.0, 1.0)}


def _symmetry_label(y_q, q_pred, axis):
    """Per item, the better of the label and its 180-degree body-frame flip
    about ``axis``: argmax over {y_q, y_q * flip} of |<., q_pred>|."""
    flip = torch.tensor(_FLIP_Q[axis], dtype=y_q.dtype,
                        device=y_q.device).expand_as(y_q)
    y_flip = qmul(y_q, flip)
    i0 = (y_q * q_pred).sum(-1, keepdim=True).abs()
    i1 = (y_flip * q_pred).sum(-1, keepdim=True).abs()
    return torch.where(i1 > i0, y_flip, y_q)


def cos2_6d_loss(y, y_pred, cfg: LossConfig, **_):
    """cos2 with a continuous 6D rotation head: ``y_pred`` is [pos(3),
    6d(6), conf(3)?]; the rotation term is 2 x (1 - |<q_label, q_pred>|).
    The symmetry branch choice carries no gradient (``stop_gradient``)."""
    q_pred = rot6d_to_quat(y_pred[:, 3:9])
    y_q = qnormalize(y[:, 3:7])
    if cfg.symmetry_flip_axis is not None:
        y_q = _symmetry_label(y_q, q_pred, cfg.symmetry_flip_axis).detach()
    loss = 0.0
    if not cfg.disable_position:
        loss = _mse(y[:, :3], y_pred[:, :3], cfg.reduction)
    if not cfg.disable_orientation:
        inner = (y_q * q_pred).sum(-1).abs()
        loss = 2.0 * _reduce(1.0 - inner, cfg.reduction) + loss
    if cfg.compute_confidence:
        y_sym = (y[:, :7] if cfg.symmetry_flip_axis is None
                 else torch.cat([y[:, :3], y_q], -1))
        loss = loss + _confidence_loss(
            y_sym, torch.cat([y_pred[:, :3], q_pred], -1), y_pred[:, 9:12],
            cfg)
    return loss


def _geodesic_rot(y, y_pred, cfg):
    """arccos(clip((<q, q_pred> - 1) / 2)) of the normalised quaternions,
    as the reference writes it."""
    inner = (qnormalize(y[:, 3:7]) * qnormalize(y_pred[:, 3:7])).sum(-1)
    return _reduce(torch.acos(torch.clamp((inner - 1.0) * 0.5, -1.0, 1.0)),
                   cfg.reduction)


def wgeodesic_loss(y, y_pred, cfg: LossConfig, **_):
    loss_coor = 0.0 if cfg.disable_position else _mse(
        y[:, :3], y_pred[:, :3], cfg.reduction)
    loss_rot = 0.0 if cfg.disable_orientation else _geodesic_rot(y, y_pred,
                                                                 cfg)
    return loss_rot + loss_coor


def smoothl1_loss(y, y_pred, cfg: LossConfig, **_):
    """Huber position term plus the geodesic rotation term."""
    loss_coor = 0.0
    if not cfg.disable_position:
        d = y[:, :3] - y_pred[:, :3]
        ad = d.abs()
        loss_coor = _reduce(torch.where(ad < 1.0, 0.5 * d ** 2, ad - 0.5),
                            cfg.reduction)
    loss_rot = 0.0 if cfg.disable_orientation else _geodesic_rot(y, y_pred,
                                                                 cfg)
    return loss_rot + loss_coor


def _items(per_item, reduction, batch):
    total = per_item.sum()
    if reduction != "mean":
        return total
    return total / global_count(batch, total.device)


def _rotated(y, y_pred, coords):
    """coords rotated by the label's and the prediction's (unnormalised)
    quaternions: ``(yt, pt)`` [B, N, 3]."""
    rot = quat_to_matrix(y[:, 3:7], normalize=False)
    rot_pred = quat_to_matrix(y_pred[:, 3:7], normalize=False)
    return (torch.einsum("bij,bnj->bni", rot, coords),
            torch.einsum("bij,bnj->bni", rot_pred, coords))


def _valid_mean(values, coords_valid, scale):
    """Per item: sum of ``values`` over valid rows / (scale x count)."""
    v = coords_valid.to(values.dtype)
    n = torch.clamp_min(v.sum(-1), 1.0)
    return (values * v).sum(-1) / (scale * n)


def pose_loss(y, y_pred, cfg: LossConfig, coords=None, coords_valid=None,
              **_):
    """Squared distance of the coords rotated by label vs prediction; x1e3
    under ``mean`` only (the reference's guard against NaN)."""
    yt, pt = _rotated(y, y_pred, coords)
    per_item = _valid_mean(((pt - yt) ** 2).sum(-1), coords_valid, 2.0)
    out = _items(per_item, cfg.reduction, y.shape[0])
    return out * 1e3 if cfg.reduction == "mean" else out


def shape_match_loss(y, y_pred, cfg: LossConfig, coords=None,
                     coords_valid=None, **_):
    """Chamfer-style min match of the two rotated clouds; O(N^2) per item."""
    yt, pt = _rotated(y, y_pred, coords)
    d2 = ((pt[:, :, None, :] - yt[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(coords_valid[:, None, :], d2,
                     torch.full((), 1e30, dtype=d2.dtype, device=d2.device))
    per_item = _valid_mean(d2.amin(-1), coords_valid, 2.0)
    return _items(per_item, cfg.reduction, y.shape[0])


def pose_match_loss(y, y_pred, cfg: LossConfig, coords=None,
                    coords_valid=None, **_):
    """L1 distance of the fully posed clouds."""
    yt, pt = _rotated(y, y_pred, coords)
    yt = yt + y[:, None, :3]
    pt = pt + y_pred[:, None, :3]
    per_item = _valid_mean((pt - yt).abs().sum(-1), coords_valid, 1.0)
    return _items(per_item, cfg.reduction, y.shape[0])


def kp_pose_match_loss(y, y_pred, cfg: LossConfig, coords=None,
                       coords_valid=None, probs=None, **_):
    """Probability-weighted squared distance of the posed keypoints."""
    yt, pt = _rotated(y, y_pred, coords)
    norms = _norm((pt + y_pred[:, None, :3]) - (yt + y[:, None, :3]))
    if probs is None:
        probs = torch.ones_like(norms)
    per_item = _valid_mean((probs * norms) ** 2, coords_valid, 2.0)
    return _items(per_item, cfg.reduction, y.shape[0])


def segmentation_loss(logits, labels, valid, ignore_label=-100):
    """Mean cross-entropy over the valid voxels whose label is not
    ``ignore_label`` (``train_segmentation.py`` / ``robotnet_vote.py``);
    0 when there is none.  logits [B, N, C], labels [B, N] int, valid
    [B, N] bool."""
    keep = valid & (labels != ignore_label)
    safe = torch.where(keep, labels, 0).long()
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    ll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    m = keep.to(ll.dtype)
    return (ll * m).sum() / torch.clamp_min(global_count(m.sum()), 1.0)


_REGISTRY = {
    LossType.MSE: mse_loss,
    LossType.COS: cos_loss,
    LossType.ANGLE: default_loss,
    LossType.COS2: cos2_loss,
    LossType.COS2_6D: cos2_6d_loss,
    LossType.WGEODESIC: wgeodesic_loss,
    LossType.SMOOTHL1: smoothl1_loss,
    LossType.POSE: pose_loss,
    LossType.SHAPE_MATCH: shape_match_loss,
    LossType.POSE_MATCH: pose_match_loss,
    LossType.KP_POSE_MATCH: kp_pose_match_loss,
}


def get_criterion(cfg: LossConfig = None):
    """The criterion of ``cfg.loss_type`` with ``cfg`` bound."""
    cfg = cfg or LossConfig()
    return partial(_REGISTRY[LossType(cfg.loss_type)], cfg=cfg)
