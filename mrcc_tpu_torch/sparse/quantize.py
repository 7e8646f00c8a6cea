"""Voxel quantization: points -> sparse voxels (port of
``mrcc_tpu/sparse/quantize.py``).

``floor(points / quantization_size)`` integer coords (the division is an f32
division, as in JAX: a reciprocal multiply moves boundary points), packed
30-bit keys, one stable key sort per item, segment reductions over the
sorted runs.  Features are averaged per voxel, labels merge to their
common value or ``ignore_label`` on conflict; the inverse point -> voxel
map lets per-voxel outputs be sliced back onto the points.  Points outside
the 1024^3 window, masked points and runs beyond the capacity go to the
dump row ``capacity``, which is dropped.
"""

from __future__ import annotations

import torch

from ..tracing import span
from .sorting import argsort_keys
from .types import (COORD_OFFSET, COORD_RANGE, KEY_PAD, SparseVoxels,
                    pack_key, unpack_key)


def run_ids(skey):
    """0-based run index of each entry of sorted keys ``[B, N]``."""
    first = torch.ones_like(skey, dtype=torch.int32)
    first[:, 1:] = (skey[:, 1:] != skey[:, :-1]).to(torch.int32)
    return torch.cumsum(first, dim=1, dtype=torch.int32) - 1


def segment_ids(seg, capacity):
    """Flatten per-item segment ids ``[B, N]`` in ``[0, capacity]`` to
    ``[B * (capacity + 1)]`` slots (slot ``capacity`` of each item = dump)."""
    b = seg.shape[0]
    base = torch.arange(b, device=seg.device, dtype=torch.int64)[:, None]
    return (seg.to(torch.int64) + base * (capacity + 1)).reshape(-1)


def segment_sum(values, flat, b, capacity):
    """Sum ``values [B, N, ...]`` into ``[B, capacity, ...]`` (dump dropped).

    Deterministic on both devices: on the card ``index_add_`` adds with
    float atomics in an order that changes from run to run, so the card
    takes ``index_put_(accumulate=True)``, which sorts the indices and sums
    each segment in order, one thread per segment; there every dump entry
    gets a slot of its own, or the padding rows would make one long serial
    segment.  On the CPU ``index_add_`` is sequential."""
    tail = values.shape[2:]
    rows = b * (capacity + 1)
    values = values.reshape((-1,) + tail)
    if not values.is_cuda:
        out = torch.zeros((rows,) + tail, dtype=values.dtype,
                          device=values.device)
        out.index_add_(0, flat, values)
        return out.reshape((b, capacity + 1) + tail)[:, :capacity]
    n = flat.shape[0]
    own = rows + torch.arange(n, device=flat.device)
    flat = torch.where(flat % (capacity + 1) == capacity, own, flat)
    out = torch.zeros((rows + n,) + tail, dtype=values.dtype,
                      device=values.device)
    out.index_put_((flat,), values, accumulate=True)
    return out[:rows].reshape((b, capacity + 1) + tail)[:, :capacity]


def _segment_reduce(values, flat, b, capacity, reduce):
    out = torch.zeros(b * (capacity + 1), dtype=values.dtype,
                      device=values.device)
    out.scatter_reduce_(0, flat, values.reshape(-1), reduce=reduce,
                        include_self=False)
    return out.reshape(b, capacity + 1)[:, :capacity]


def segment_min(values, flat, b, capacity):
    """Min of ``values [B, N]`` into ``[B, capacity]``; empty segments 0."""
    return _segment_reduce(values, flat, b, capacity, "amin")


def segment_max(values, flat, b, capacity):
    """Max of ``values [B, N]`` into ``[B, capacity]``; empty segments 0."""
    return _segment_reduce(values, flat, b, capacity, "amax")


def f32_div(x, s: float):
    """``x / s`` as a true f32 division by a device tensor (a Python scalar
    divisor becomes a reciprocal multiply on the card)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


@span("sparse.voxelize")
def voxelize(points, feats, mask, quantization_size, capacity,
             labels=None, ignore_label=-100):
    """Batched voxelization.

    Args:
      points: [B, P, 3] f32 points (metres).
      feats:  [B, P, C] per-point features.
      mask:   [B, P] validity of input points.
      quantization_size: voxel edge length.
      capacity: per-item voxel capacity N.
      labels: optional [B, P] per-point labels (cast to int32).
      ignore_label: the label of a voxel whose points disagree, and of
        empty voxels.

    Returns ``(SparseVoxels, point_to_voxel [B, P] int32)``, and the voxel
    labels ``[B, N] int32`` as a third value when ``labels`` is given;
    points without a voxel map to ``capacity``.
    """
    b, p, c = feats.shape
    coords = torch.floor(f32_div(points, quantization_size)).to(torch.int32)
    off = coords + COORD_OFFSET
    in_range = ((off >= 0) & (off < COORD_RANGE)).all(dim=-1)
    ok = in_range & mask
    key = torch.where(ok, pack_key(off), KEY_PAD)
    skey, order = argsort_keys(key)
    sfeats = feats.gather(1, order.long()[..., None].expand(b, p, c))

    run_id = run_ids(skey)
    vid = torch.where((skey < KEY_PAD) & (run_id < capacity), run_id, capacity)
    flat = segment_ids(vid, capacity)
    cnt = segment_sum(torch.ones((b, p), dtype=feats.dtype,
                                 device=feats.device), flat, b, capacity)
    fsum = segment_sum(sfeats, flat, b, capacity)
    vvalid = cnt > 0
    fmean = fsum / torch.clamp_min(cnt, 1.0)[..., None]

    ukey = segment_min(skey, flat, b, capacity)
    ukey = torch.where(vvalid, ukey, KEY_PAD)
    uoff = torch.where(vvalid[..., None], unpack_key(ukey), 0)

    # point -> voxel in original point order (order is a permutation)
    pv = torch.zeros((b, p), dtype=torch.int32, device=points.device)
    pv.scatter_(1, order.long(), vid)
    voxels = SparseVoxels(
        off=uoff, key=ukey,
        feats=torch.where(vvalid[..., None], fmean, 0.0),
        valid=vvalid, count=vvalid.sum(dim=1, dtype=torch.int32))
    if labels is None:
        return voxels, pv
    slab = labels.gather(1, order.long()).to(torch.int32)
    lmin = segment_min(slab, flat, b, capacity)
    lmax = segment_max(slab, flat, b, capacity)
    ulab = torch.where(vvalid & (lmin == lmax), lmin, ignore_label)
    return voxels, pv, ulab.to(torch.int32)


def slice_to_points(voxel_values, point_to_voxel, fill_value=0.0):
    """Map per-voxel values ``[B, N, C]`` back onto points via
    ``point_to_voxel [B, P]`` (== N: no voxel -> ``fill_value``)."""
    b, _, c = voxel_values.shape
    padded = torch.cat([voxel_values,
                        voxel_values.new_full((b, 1, c), fill_value)], dim=1)
    idx = point_to_voxel.long()[..., None].expand(-1, -1, c)
    return padded.gather(1, idx)
