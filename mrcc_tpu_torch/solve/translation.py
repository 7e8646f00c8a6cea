"""Geometric EE translation, the reference's "magic point" (port of
``mrcc_tpu/solve/translation.py``, min-z form)."""

from __future__ import annotations

import torch

from ..geometry.preprocess import center_at_origin
from ..geometry.transform import quat_to_matrix


def predict_translation(ee_points, mask, q, magic_x=-0.015):
    """EE position from points and predicted orientation, batched.

    Rotate the points into the predicted frame, centre them at the bbox,
    take ``[magic_x, 0, min z]`` plus the centring offset, rotate back.

    Args: ee_points [B, P, 3], mask [B, P], q [B, 4] WXYZ.
    Returns ``([B, 3] position, [B, 3] origin offset in the rotated frame)``.
    """
    rot = quat_to_matrix(q)                                  # [B, 3, 3]
    local = torch.matmul(ee_points, rot)                     # rot^T p
    centered, offset = center_at_origin(local, mask=mask)
    big = torch.full((), torch.finfo(centered.dtype).max,
                     dtype=centered.dtype, device=centered.device)
    min_z = torch.where(mask, centered[..., 2], big).amin(dim=-1)
    magic = torch.stack([torch.full_like(min_z, magic_x),
                         torch.zeros_like(min_z), min_z], dim=-1)
    pos = torch.matmul(rot, (magic + offset)[..., None])[..., 0]
    return pos, offset
