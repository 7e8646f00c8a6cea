"""The plain reference's sparse core: voxels, stride levels and the maps of
every conv, derived from the points alone.

Rows are the valid voxels of the whole batch, flattened and sorted by the
64-bit key ``item << 30 | x << 20 | y << 10 | z`` of their offset
coordinates (coordinate + 512, 10 bits per axis), so each item's voxels
are contiguous and in ascending packed order.  A level keeps, per item,
the ``capacity`` smallest keys; a voxel whose parent did not make the
coarser level's capacity has no parent and takes part in neither the down
nor the up conv.  Maps are index pairs per kernel offset: ``k3[k] =
(out_rows, in_rows)`` for the 27 offsets (z fastest, offset 13 the
identity), ``oct[o] = (fine_rows, coarse_rows)`` for the 8 octants
``(x % 2) << 2 | (y % 2) << 1 | z % 2``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

COORD_BITS = 10
COORD_RANGE = 1 << COORD_BITS
COORD_OFFSET = COORD_RANGE // 2
ITEM_SHIFT = 3 * COORD_BITS
K3_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
              for dz in (-1, 0, 1)]


def pack(off: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
    off = off.long()
    return ((item.long() << ITEM_SHIFT) | (off[:, 0] << 20)
            | (off[:, 1] << 10) | off[:, 2])


@dataclasses.dataclass
class Level:
    """One stride level: ``key [M]`` sorted, ``off [M, 3]``, ``item [M]``,
    ``count [B]`` voxels per item, and its k3 map."""

    key: torch.Tensor
    off: torch.Tensor
    item: torch.Tensor
    count: torch.Tensor
    k3: List[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def rows(self) -> int:
        return int(self.key.shape[0])


def _keep_smallest(ukey: torch.Tensor, capacity: int) -> torch.Tensor:
    """Mask of the keys (sorted, unique) within the first ``capacity`` of
    their item."""
    item = ukey >> ITEM_SHIFT
    first = torch.searchsorted(ukey, item << ITEM_SHIFT)
    rank = torch.arange(ukey.shape[0], device=ukey.device) - first
    return rank < capacity


def _counts(item: torch.Tensor, batch: int) -> torch.Tensor:
    return torch.bincount(item, minlength=batch)[:batch]


def voxelize(points, feats, mask, labels, voxel_size: float, capacity: int,
             ignore_label: int = -100):
    """``(Level, voxel feats [M, C] f32, voxel labels [M] int64)``.

    Coordinates are ``floor(points / voxel_size)`` by a true f32 division;
    points outside the 1024^3 window or masked out are dropped.  A voxel's
    features are the mean of its points' (summed in float64), its label the
    points' common label, else ``ignore_label``."""
    b, p, c = feats.shape
    dev = points.device
    size = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    off = torch.floor(points.float() / size).long() + COORD_OFFSET
    ok = mask.bool() & ((off >= 0) & (off < COORD_RANGE)).all(-1)
    item = torch.arange(b, device=dev)[:, None].expand(b, p)[ok]
    key = pack(off[ok], item)
    ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
    m = ukey.shape[0]
    cnt = torch.bincount(inv, minlength=m).double()
    fsum = torch.zeros((m, c), dtype=torch.float64, device=dev)
    fsum.index_add_(0, inv, feats[ok].double())
    fmean = (fsum / cnt[:, None]).float()
    lab = labels[ok].long()
    lmin = torch.full((m,), 1 << 40, dtype=torch.long, device=dev)
    lmax = torch.full((m,), -(1 << 40), dtype=torch.long, device=dev)
    lmin.scatter_reduce_(0, inv, lab, "amin")
    lmax.scatter_reduce_(0, inv, lab, "amax")
    vlab = torch.where(lmin == lmax, lmin, ignore_label)
    keep = _keep_smallest(ukey, capacity)
    ukey = ukey[keep]
    level = _level(ukey, b)
    return level, fmean[keep], vlab[keep]


def _level(ukey: torch.Tensor, batch: int) -> Level:
    mask = COORD_RANGE - 1
    off = torch.stack([(ukey >> 20) & mask, (ukey >> 10) & mask, ukey & mask],
                      dim=-1)
    item = ukey >> ITEM_SHIFT
    return Level(key=ukey, off=off, item=item, count=_counts(item, batch))


def coarser(fine: Level, capacity: int, batch: int):
    """The stride-2 parents of ``fine`` within ``capacity`` per item:
    ``(coarse Level, oct map)`` with ``oct[o] = (fine rows, their parents'
    coarse rows)`` for the fine voxels of octant ``o`` whose parent made
    the capacity."""
    pkey = pack(fine.off // 2, fine.item)
    ukey, inv = torch.unique(pkey, sorted=True, return_inverse=True)
    keep = _keep_smallest(ukey, capacity)
    new = torch.cumsum(keep.long(), 0) - 1
    parent = torch.where(keep[inv], new[inv], -1)
    coarse = _level(ukey[keep], batch)
    octant = (((fine.off[:, 0] % 2) << 2) | ((fine.off[:, 1] % 2) << 1)
              | (fine.off[:, 2] % 2))
    maps = []
    for o in range(8):
        rows = torch.nonzero((octant == o) & (parent >= 0))[:, 0]
        maps.append((rows, parent[rows]))
    return coarse, maps


def k3_map(level: Level):
    """Per offset k: ``(out rows, in rows)`` where the voxel at
    ``off + K3_OFFSETS[k]`` exists in the same item."""
    out = []
    for d in K3_OFFSETS:
        q = level.off + torch.tensor(d, device=level.off.device)
        inwin = ((q >= 0) & (q < COORD_RANGE)).all(-1)
        qkey = pack(q.clamp(0, COORD_RANGE - 1), level.item)
        pos = torch.searchsorted(level.key, qkey).clamp_max(level.rows - 1)
        hit = inwin & (level.key[pos] == qkey)
        rows = torch.nonzero(hit)[:, 0]
        out.append((rows, pos[rows]))
    return out


def hierarchy(level0: Level, capacities, batch: int):
    """``depth + 1`` levels (finest first, each with its k3 map) and the
    ``depth`` oct maps between neighbours; ``capacities`` are levels
    1..depth's."""
    levels, octs = [level0], []
    for cap in capacities:
        coarse, maps = coarser(levels[-1], cap, batch)
        levels.append(coarse)
        octs.append(maps)
    for lv in levels:
        lv.k3 = k3_map(lv)
    return levels, octs


def hierarchy_caps(voxel_capacity: int):
    """Levels 1..4's capacities of a training step: the level-0 capacity,
    then halving, floor 64."""
    return (voxel_capacity, max(voxel_capacity // 2, 64),
            max(voxel_capacity // 4, 64), max(voxel_capacity // 8, 64))
