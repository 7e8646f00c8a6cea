"""Point-cloud preprocessing (port of ``mrcc_tpu/geometry/preprocess.py``):
masked bbox centering and the reference's colour normalisation."""

from __future__ import annotations

import torch


def _full(ref, value):
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


def center_at_origin(points, mask=None):
    """Shift so the axis-aligned bbox centre sits at the origin.

    Returns ``(points - offset, offset)`` with offset = (max + min) / 2 over
    the rows of ``mask`` (padding rows are shifted too; mask them later).
    """
    if mask is None:
        mx = points.amax(dim=-2)
        mn = points.amin(dim=-2)
    else:
        m = mask[..., None]
        big = torch.finfo(points.dtype).max
        mx = torch.where(m, points, _full(points, -big)).amax(dim=-2)
        mn = torch.where(m, points, _full(points, big)).amin(dim=-2)
    offset = (mx + mn) / 2
    return points - offset[..., None, :], offset


def normalize_colors(rgb, mask=None):
    """Normalise RGB to [-0.5, 0.5] with the reference's rescue path: values
    over 2 are 0-255, negative channels are min-max rescaled, colours in
    [0, 1] shift by -0.5.  The branch decisions are over the whole batch,
    as in the JAX function."""
    valid = (torch.ones(rgb.shape[:-1], dtype=torch.bool, device=rgb.device)
             if mask is None else mask)
    v = valid[..., None]
    big = _full(rgb, 1e30)
    gmax = torch.where(v, rgb, -big).amax()
    rgb = torch.where(gmax > 2.0, rgb / _full(rgb, 255.0), rgb)

    cmin = torch.where(v, rgb, big).amin(dim=-2, keepdim=True)
    cmax = torch.where(v, rgb, -big).amax(dim=-2, keepdim=True)
    gmin = torch.where(v, rgb, big).amin()
    scaled = (rgb - cmin) / torch.clamp_min(cmax - cmin, 1e-12)
    rgb = torch.where(gmin < 0.0, scaled, rgb)

    gmin2 = torch.where(v, rgb, big).amin()
    gmax2 = torch.where(v, rgb, -big).amax()
    in_unit = (gmin2 > -1e-6) & (gmax2 < 1.0 + 1e-6)
    return torch.where(in_unit, rgb - 0.5, rgb)
