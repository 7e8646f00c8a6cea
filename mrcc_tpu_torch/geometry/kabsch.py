"""Kabsch rigid alignment with the reflection fix (port of
``mrcc_tpu/geometry/kabsch.py``), masked by weights and batched."""

from __future__ import annotations

import torch

from .transform import matrix_to_quat


def kabsch(reference, target, weights=None):
    """Weighted least-squares rigid transform with ``R @ ref + t ~ target``.

    Args:
      reference, target: (..., N, 3).
      weights: optional (..., N) non-negative weights (0 masks a row).
    Returns ``(R (..., 3, 3), t (..., 3))``; det(R) = +1 (the last column of
    V flips when V U^T is a reflection).
    """
    if weights is None:
        weights = torch.ones(reference.shape[:-1], dtype=reference.dtype,
                             device=reference.device)
    weights = weights.to(reference.dtype)
    wsum = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-12)
    w = (weights / wsum)[..., None]
    centroid_a = (reference * w).sum(dim=-2, keepdim=True)
    centroid_b = (target * w).sum(dim=-2, keepdim=True)
    am = reference - centroid_a
    bm = target - centroid_b
    h = torch.einsum("...ni,...nj->...ij", am * w, bm)
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    flip = torch.where(det < 0, -1.0, 1.0).to(v.dtype)
    v = torch.cat([v[..., :, :2], v[..., :, 2:] * flip[..., None, None]],
                  dim=-1)
    r = v @ ut
    t = centroid_b[..., 0, :] - torch.einsum("...ij,...j->...i", r,
                                             centroid_a[..., 0, :])
    return r, t


def kabsch_pose(reference, target, weights=None):
    """Kabsch solve as a 7-vector pose [x, y, z, qw, qx, qy, qz]."""
    r, t = kabsch(reference, target, weights=weights)
    return torch.cat([t, matrix_to_quat(r)], dim=-1)
