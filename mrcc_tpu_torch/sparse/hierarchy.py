"""Coordinate hierarchy for sparse U-Nets (port of
``mrcc_tpu/sparse/hierarchy.py``: the self-keyed and the k3-table routes of
inference, the self-keyed route of training).

Per stride level: the unique voxel set (sorted packed keys), parent links
into the next-coarser level (``parent_idx``, ``parent_ok``, ``octant``) for
the transpose convs, the k=2 s=2 child map built by scatter through the
downsample sort (``child_idx``/``child_hit``, stored on the coarser level),
the k=3 validity bitmap ``kbits`` that the self-keyed conv and the rank
kernel read (port of ``ops/rank_pallas.py::sk_bits``; plain tensor code,
no kernel), and on the levels :func:`uses_k3_tables` names, the 27-offset
neighbour tables ``nbr_idx``/``nbr_hit`` built by the rank kernel
(:func:`neighbor_tables`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.rank import rank_lookup
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

# The TPU's VMEM table budget (bytes), which decides the JAX engine's k3
# route and its int8 channel groups.
TABLE_BUDGET = 5 * 1024 * 1024


def pack_deltas(offsets) -> np.ndarray:
    """Arithmetic key deltas of coordinate offsets [K, 3] (signed)."""
    offsets = np.asarray(offsets)
    return (offsets[:, 0] * (1 << (2 * COORD_BITS))
            + offsets[:, 1] * (1 << COORD_BITS) + offsets[:, 2]).astype(np.int32)


# Packed key deltas of K3_OFFSETS (delta(26 - k) == -delta(k)).
K3_DELTAS = tuple(int(d) for d in pack_deltas(K3_OFFSETS))


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
    kbits: [B, N] int32 k=3 validity bitmap (self-keyed convs, rank
      kernel).
    nbr_idx/nbr_hit: [27, B, N] k=3 neighbour tables (int32 / bool) on the
      levels that take the table route, else None.
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
    nbr_idx: Optional[torch.Tensor] = None
    nbr_hit: Optional[torch.Tensor] = None


def uses_k3_tables(n: int, conv_impl: str = "pallas",
                   compute_dtype: str = "bfloat16",
                   k3_self_keyed: bool = True) -> bool:
    """Whether an ``n``-row level of an inference stage takes the k3-table
    route (rank-kernel tables and the table conv) instead of the
    self-keyed conv.

    This reproduces the JAX engine's route: tables where the JAX engine on
    a TPU builds them (``inference_engine.py::_k3_sk`` and
    ``sparse/hierarchy.py::_use_self_keyed``), that is where
    ``k3_self_keyed`` is off, where the compute dtype is f32, or where the
    level fails ``conv_pallas.sk_pack(n, itemsize) == 1`` (n a multiple of
    128 whose 128-lane table fits the 5 MiB VMEM budget: 20480 rows in
    bf16, 40960 in int8).  ``conv_impl`` is the stage's: ``"pallas-int8"``
    tables are int8 (itemsize 1), every other impl counts as the TPU's
    ``"pallas"`` (itemsize 2).  On the card both routes run at any N: this
    is a choice of route, not a capacity limit.
    """
    if not k3_self_keyed or compute_dtype == "float32":
        return True
    itemsize = 1 if conv_impl == "pallas-int8" else 2
    return not (n % 128 == 0 and n >= 128
                and n * 128 * itemsize <= TABLE_BUDGET)


def neighbor_tables(level: Level):
    """The level's 27-offset neighbour tables ``(idx [27, B, N] int32,
    hit [27, B, N] bool)`` through the rank kernel (port of
    ``rank_pallas.neighbor_tables`` for K3_OFFSETS): the ranks of
    ``key + delta_k`` in the level's sorted keys, gated by ``kbits``."""
    return rank_lookup(level.key, level.key, K3_DELTAS, level.kbits)


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
                    build_k3: bool = True,
                    k3_tables: Optional[Sequence[bool]] = None
                    ) -> Tuple[Level, ...]:
    """Build ``depth + 1`` stride levels (stride 1, 2, ..., 2**depth).

    ``capacities``: per-level voxel capacities of levels 1..depth (default:
    the level-0 capacity halving, floor 64).  ``build_k3``: also build each
    level's k=3 bitmap (``False`` for occupancy probes).  ``k3_tables``:
    per level (``depth + 1`` flags, finest first), whether to build its
    neighbour tables for the table conv (:func:`uses_k3_tables`); None
    builds none (every level self-keyed).  Finest first.
    """
    n0 = voxels.key.shape[1]
    if capacities is None:
        capacities = tuple(max(n0 >> l, 64) for l in range(depth))
    if len(capacities) != depth:
        raise ValueError(f"{len(capacities)} capacities for depth {depth}")
    tables = tuple(k3_tables) if k3_tables is not None else (False,) * (
        depth + 1)
    if len(tables) != depth + 1 or (any(tables) and not build_k3):
        raise ValueError(f"k3_tables {k3_tables}: need {depth + 1} flags "
                         "and build_k3")

    def with_k3(level, table):
        if not build_k3:
            return level
        level = dataclasses.replace(level, kbits=k3_bits(level.off,
                                                         level.valid))
        if not table:
            return level
        idx, hit = neighbor_tables(level)
        return dataclasses.replace(level, nbr_idx=idx, nbr_hit=hit)

    levels = []
    cur = Level(off=voxels.off, key=voxels.key, valid=voxels.valid,
                count=voxels.count)
    for cap, table in zip(capacities, tables):
        coarse, parent_idx, parent_ok, octant = downsample(cur.off, cur.valid,
                                                           cap)
        cur = with_k3(dataclasses.replace(
            cur, parent_idx=parent_idx, parent_ok=parent_ok,
            row_ok=cur.valid & parent_ok, octant=octant), table)
        levels.append(cur)
        cur = coarse
    levels.append(with_k3(cur, tables[-1]))
    return tuple(levels)
