"""Batched point-to-point ICP (port of ``mrcc_tpu/solve/icp.py``).

A fixed number of iterations of brute-force nearest neighbour (one
distance-matrix product) then a trimmed Kabsch.  The template is the
synthetic EE surface with the reference's x > 0 visibility mask.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.synthetic import ee_template_points
from ..geometry.kabsch import kabsch
from ..geometry.transform import matrix_to_pose, pose_to_matrix


def default_template(n=2048, seed=7):
    """CAD-replacement template cloud [n, 3] in the canonical EE frame."""
    rng = np.random.default_rng(seed)
    pts = ee_template_points(rng, n * 2)
    pts = pts[pts[:, 0] > 0.0]
    if len(pts) >= n:
        pts = pts[:n]
    else:
        pts = np.tile(pts, (int(np.ceil(n / len(pts))), 1))[:n]
    return pts.astype(np.float32)


def _nn_correspondences(src, target, target_mask):
    """Nearest valid target point of each src point, and its distance.

    src [B, M, 3], target [B, N, 3], target_mask [B, N]."""
    sq_s = (src * src).sum(dim=-1, keepdim=True)
    sq_t = (target * target).sum(dim=-1)[:, None, :]
    d2 = sq_s + sq_t - torch.bmm(2.0 * src, target.transpose(1, 2))
    d2 = torch.where(target_mask[:, None, :], d2,
                     torch.full((), 1e30, dtype=d2.dtype, device=d2.device))
    idx = torch.argmin(d2, dim=-1)
    dmin = d2.gather(-1, idx[..., None])[..., 0]
    match = target.gather(1, idx[..., None].expand(-1, -1, 3))
    return match, torch.sqrt(torch.clamp_min(dmin, 0.0))


def icp_refine(template, ee_points, ee_mask, init_pose, iterations=30,
               threshold=0.1):
    """Refine ``init_pose [B, 7]`` so the template [M, 3] (EE frame) matches
    the observed points ``ee_points [B, N, 3]`` (mask [B, N]).

    Correspondences beyond ``threshold`` are dropped; an iteration with at
    most 3 kept matches keeps the previous transform.  Items with at most 3
    valid points return ``init_pose``.
    """
    b = ee_points.shape[0]
    init_mat = pose_to_matrix(init_pose)
    r, t = init_mat[:, :3, :3], init_mat[:, :3, 3]
    tmpl = template.expand(b, -1, -1)
    for _ in range(iterations):
        src = torch.matmul(tmpl, r.transpose(1, 2)) + t[:, None, :]
        match, dist = _nn_correspondences(src, ee_points, ee_mask)
        w = (dist < threshold).to(template.dtype)
        keep = w.sum(dim=-1) > 3
        r_new, t_new = kabsch(tmpl, match,
                              weights=torch.where(keep[:, None], w, 1.0))
        r = torch.where(keep[:, None, None], r_new, r)
        t = torch.where(keep[:, None], t_new, t)
    mat = torch.eye(4, dtype=init_mat.dtype, device=init_mat.device)
    mat = mat.expand(b, 4, 4).clone()
    mat[:, :3, :3] = r
    mat[:, :3, 3] = t
    has_points = ee_mask.sum(dim=-1) > 3
    return torch.where(has_points[:, None], matrix_to_pose(mat), init_pose)
