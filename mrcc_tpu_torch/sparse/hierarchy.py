"""Coordinate hierarchy for sparse U-Nets (port of
``mrcc_tpu/sparse/hierarchy.py``, the self-keyed path of inference and
training).

Per stride level: the unique voxel set (sorted packed keys), parent links
into the next-coarser level (``parent_idx``, ``parent_ok``, ``octant``) for
the transpose convs, the k=2 s=2 child map built by scatter through the
downsample sort (``child_idx``/``child_hit``, stored on the coarser level),
and the k=3 validity bitmap ``kbits`` that the self-keyed conv reads
(port of ``ops/rank_pallas.py::sk_bits``; plain tensor code, no kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .quantize import run_ids, segment_ids, segment_min, segment_sum
from .sorting import argsort_keys
from .types import (COORD_BITS, COORD_RANGE, KEY_PAD, SparseVoxels,
                    pack_key, unpack_key)

# K3_OFFSETS: z fastest, offset 13 the identity.  K2_OFFSETS enumerates
# k = dx*4 + dy*2 + dz, which equals the octant code of a child.
K3_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32)
K2_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
    dtype=np.int32)


def pack_deltas(offsets) -> np.ndarray:
    """Arithmetic key deltas of coordinate offsets [K, 3] (signed)."""
    offsets = np.asarray(offsets)
    return (offsets[:, 0] * (1 << (2 * COORD_BITS))
            + offsets[:, 1] * (1 << COORD_BITS) + offsets[:, 2]).astype(np.int32)


def k3_bits(off, valid):
    """Per-row k=3 query-validity bitmap ``[B, N]`` int32: bit k is set iff
    the row is valid and ``off + K3_OFFSETS[k]`` lies inside the coordinate
    window (``rank_pallas.sk_bits`` over ``_border_qvalid``)."""
    ax = [off[..., i] for i in range(3)]
    lo = [ax[i] >= 1 for i in range(3)]                  # d = -1 stays >= 0
    hi = [ax[i] < COORD_RANGE - 1 for i in range(3)]     # d = +1 stays < 1024
    bits = torch.zeros_like(off[..., 0], dtype=torch.int32)
    for k, d in enumerate(K3_OFFSETS):
        m = valid
        for i in range(3):
            if d[i] < 0:
                m = m & lo[i]
            elif d[i] > 0:
                m = m & hi[i]
        bits = bits | (m.to(torch.int32) << k)
    return bits


@dataclasses.dataclass(frozen=True)
class Level:
    """One stride level of the coordinate hierarchy.

    off/key/valid/count: the voxel set ([B, N, 3], [B, N], [B, N], [B]).
    parent_idx: [B, N] slot of the parent in the next-coarser level.
    parent_ok:  [B, N] whether that parent made the coarser capacity.
    row_ok:     [B, N] ``valid & parent_ok``: the rows the up map and its
      dW read, and the data-cotangent mask of the down conv.
    octant:     [B, N] which of the 8 children of its parent this voxel is.
    child_idx/child_hit: [8, B, N] on the COARSER level: per voxel and
      octant, the index of its child in the finer level.
    kbits: [B, N] int32 k=3 validity bitmap (self-keyed convs).
    """

    off: torch.Tensor
    key: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    parent_idx: Optional[torch.Tensor] = None
    parent_ok: Optional[torch.Tensor] = None
    row_ok: Optional[torch.Tensor] = None
    octant: Optional[torch.Tensor] = None
    child_idx: Optional[torch.Tensor] = None
    child_hit: Optional[torch.Tensor] = None
    kbits: Optional[torch.Tensor] = None


def downsample(off, valid, capacity):
    """Stride-2 parents of one level (``_downsample_sort`` +
    ``_downsample_one(child_table=True)``, batched).

    One stable sort of the parent keys does everything: the sorted run id of
    a child is its parent's slot, scattered back through the permutation,
    and ``(run_id, octant)`` addresses the child map (each slot/octant pair
    holds at most one child).  Returns ``(coarse Level, parent_idx,
    parent_ok, octant)``.
    """
    b, n = valid.shape
    p_key = torch.where(valid, pack_key(off // 2), KEY_PAD)
    skey, order = argsort_keys(p_key)
    order_l = order.long()
    run_id = run_ids(skey)
    ok = (skey < KEY_PAD) & (run_id < capacity)
    vid = torch.where(ok, run_id, capacity)
    flat = segment_ids(vid, capacity)
    ukey = segment_min(skey, flat, b, capacity)
    cnt = segment_sum(torch.ones((b, n), dtype=torch.int32,
                                 device=off.device), flat, b, capacity)
    uvalid = cnt > 0
    ukey = torch.where(uvalid, ukey, KEY_PAD)
    uoff = torch.where(uvalid[..., None], unpack_key(ukey), 0)

    # child -> parent link scattered back through the sort; parent_ok marks
    # children whose parent made the capacity (overflowed ones alias slot
    # capacity - 1)
    parent_idx = torch.zeros((b, n), dtype=torch.int32, device=off.device)
    parent_idx.scatter_(1, order_l, torch.clamp_max(run_id, capacity - 1))
    parent_ok = torch.zeros((b, n), dtype=torch.bool, device=off.device)
    parent_ok.scatter_(1, order_l, ok)
    octant = (((off[..., 0] % 2) << 2) | ((off[..., 1] % 2) << 1)
              | (off[..., 2] % 2))
    octant = torch.where(valid, octant, 0).to(torch.int32)

    oct_s = octant.gather(1, order_l)
    slot = torch.where(ok, run_id * 8 + oct_s, capacity * 8).long()
    cidx = torch.zeros((b, capacity * 8 + 1), dtype=torch.int32,
                       device=off.device)
    cidx.scatter_(1, slot, order)
    chit = torch.zeros((b, capacity * 8 + 1), dtype=torch.bool,
                       device=off.device)
    chit.scatter_(1, slot, ok)
    child_idx = cidx[:, :capacity * 8].reshape(b, capacity, 8).permute(2, 0, 1)
    child_hit = chit[:, :capacity * 8].reshape(b, capacity, 8).permute(2, 0, 1)
    coarse = Level(off=uoff, key=ukey, valid=uvalid,
                   count=uvalid.sum(dim=1, dtype=torch.int32),
                   child_idx=child_idx.contiguous(),
                   child_hit=child_hit.contiguous())
    return coarse, parent_idx, parent_ok, octant


def hierarchy_caps(voxel_capacity: int) -> Tuple[int, ...]:
    """Default level 1..4 capacities of a depth-4 hierarchy: the level-0
    capacity, then halving, floor 64 (``trainer.py:200-202``)."""
    return (voxel_capacity, max(voxel_capacity // 2, 64),
            max(voxel_capacity // 4, 64), max(voxel_capacity // 8, 64))


def build_hierarchy(voxels: SparseVoxels, depth: int,
                    capacities: Optional[Tuple[int, ...]] = None,
                    build_k3: bool = True) -> Tuple[Level, ...]:
    """Build ``depth + 1`` stride levels (stride 1, 2, ..., 2**depth).

    ``capacities``: per-level voxel capacities of levels 1..depth (default:
    the level-0 capacity halving, floor 64).  ``build_k3``: also build each
    level's k=3 bitmap (``False`` for occupancy probes).  Finest first.
    """
    n0 = voxels.key.shape[1]
    if capacities is None:
        capacities = tuple(max(n0 >> l, 64) for l in range(depth))
    if len(capacities) != depth:
        raise ValueError(f"{len(capacities)} capacities for depth {depth}")
    levels = []
    cur = Level(off=voxels.off, key=voxels.key, valid=voxels.valid,
                count=voxels.count)
    for cap in capacities:
        coarse, parent_idx, parent_ok, octant = downsample(cur.off, cur.valid,
                                                           cap)
        cur = dataclasses.replace(
            cur, parent_idx=parent_idx, parent_ok=parent_ok,
            row_ok=cur.valid & parent_ok, octant=octant,
            kbits=k3_bits(cur.off, cur.valid) if build_k3 else None)
        levels.append(cur)
        cur = coarse
    if build_k3:
        cur = dataclasses.replace(cur, kbits=k3_bits(cur.off, cur.valid))
    levels.append(cur)
    return tuple(levels)
