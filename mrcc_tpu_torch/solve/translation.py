"""Geometric EE translation, the reference's "magic point" (port of
``mrcc_tpu/solve/translation.py``)."""

from __future__ import annotations

import torch

from ..geometry.preprocess import center_at_origin
from ..geometry.transform import quat_to_matrix


def predict_translation(ee_points, mask, q, magic_x=-0.015,
                        z_percentile=None):
    """EE position from points and predicted orientation, batched.

    Rotate the points into the predicted frame, centre them at the bbox,
    take ``[magic_x, 0, z]`` plus the centring offset, rotate back.  ``z``
    is the minimum of the rotated-frame z (the reference's quirk) or, with
    ``z_percentile`` p, its nearest-rank p-th percentile over each item's
    valid count: padding sorts last, and a count of 0 takes index 0 as the
    minimum does.

    Args: ee_points [B, P, 3], mask [B, P], q [B, 4] WXYZ.
    Returns ``([B, 3] position, [B, 3] origin offset in the rotated frame)``.
    """
    rot = quat_to_matrix(q)                                  # [B, 3, 3]
    local = torch.matmul(ee_points, rot)                     # rot^T p
    centered, offset = center_at_origin(local, mask=mask)
    big = torch.full((), torch.finfo(centered.dtype).max,
                     dtype=centered.dtype, device=centered.device)
    z = torch.where(mask, centered[..., 2], big)
    if z_percentile is None:
        min_z = z.amin(dim=-1)
    else:
        cnt = mask.sum(dim=-1)
        rank = torch.round(z_percentile / 100.0 * (cnt - 1).to(z.dtype))
        j = torch.clamp(rank, 0, z.shape[-1] - 1).long()
        min_z = torch.sort(z, dim=-1).values.gather(-1, j[:, None])[:, 0]
    magic = torch.stack([torch.full_like(min_z, magic_x),
                         torch.zeros_like(min_z), min_z], dim=-1)
    pos = torch.matmul(rot, (magic + offset)[..., None])[..., 0]
    return pos, offset
