"""Coordinate hierarchy for sparse U-Nets (port of
``mrcc_tpu/sparse/hierarchy.py``: the self-keyed and the k3-table routes of
inference and of training, and the strided pyramid of the sparse ResNets,
:func:`downsample_level`).

Per stride level: the unique voxel set (sorted packed keys), parent links
into the next-coarser level (``parent_idx``, ``parent_ok``, ``octant``) for
the transpose convs, the k=2 s=2 child map built by scatter through the
downsample sort (``child_idx``/``child_hit``, stored on the coarser level),
the k=3 validity bitmap ``kbits`` that the self-keyed conv and the rank
kernel read (port of ``ops/rank_pallas.py::sk_bits``; plain tensor code,
no kernel), and on the levels :func:`uses_k3_tables` (inference) or
:func:`train_uses_k3_tables` (training) names, the 27-offset neighbour
tables ``nbr_idx``/``nbr_hit`` built by the rank kernel
(:func:`neighbor_tables`), and on the card each level's k3 order
(``ops.k3_order``: the schedule of the k3 convs' tile, rows grouped by
their neighbour masks in three offset segments), which every k3 conv on
the level reads but an int8 one (:func:`with_k3_order`).  :func:`downsample_level` builds one coarser
level for any (kernel size, stride): parents by floor division and a
strided child map from the rank kernel's child-table mode
(``ops.rank.child_tables``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.k3_order import K3Order, level_order
from ..ops.rank import border_bits, child_tables, rank_lookup
from ..tracing import span
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
    return border_bits(off, valid, K3_OFFSETS)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Offsets of a strided conv's kernel: K2_OFFSETS for k=2, else the
    k^3 cube centred on ``parent * stride`` (z fastest; K3_OFFSETS for
    k=3), as ``downsample_level`` enumerates them."""
    if kernel_size == 2:
        return K2_OFFSETS
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return np.array([[dx, dy, dz] for dx in r for dy in r for dz in r],
                    dtype=np.int32)


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
    k3_order: the level's k3 order (``ops.k3_order.K3Order``) where
      ``build_hierarchy`` built it (levels on the card), else None.
    lists: the hit lists (``ops.hit_lists.HitLists``) of the level's maps
      by kind: its k3 map ("sk" or "k3map"), its parent map ("up") and, on
      the coarser level of a pair, its child map ("down").  On the card
      ``sparse/conv.py`` adds each at the first conv over its map; every
      other conv over the map reads it, for the level's life.  A level
      made by ``dataclasses.replace`` starts with none.
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
    k3_order: Optional[K3Order] = None
    lists: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)


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


def train_uses_k3_tables(n: int, k3_self_keyed: bool = True) -> bool:
    """Whether an ``n``-row level of a train step takes the k3-table route.

    This reproduces the JAX train step's gate
    (``mrcc_tpu/sparse/hierarchy.py:78-95``, ``_use_self_keyed`` under the
    ``"pallas"`` impl, which both JAX steps pass ``k3_self_keyed`` to):
    tables where ``k3_self_keyed`` is off, or where the level fails
    ``conv_pallas.sk_pack(n, itemsize=2) == 1``, that is where n is not a
    multiple of 128 or its 128-lane bf16 table exceeds the 5 MiB budget
    (20480 rows).  The itemsize is 2 whatever the step's dtype: unlike
    :func:`uses_k3_tables`, f32 alone does not put a level on tables.
    """
    return not k3_self_keyed or not (n % 128 == 0 and n >= 128
                                     and n * 128 * 2 <= TABLE_BUDGET)


def _pick_tile(n: int) -> int:
    """The JAX conv's output row tile (``conv_pallas._pick_tile``)."""
    return next((t for t in (256, 128, 64, 32, 16, 8)
                 if n % t == 0 and n >= t), 0)


def q8_supported(n_in: int, n_out: int, itemsize: int) -> bool:
    """Whether the JAX int8 route accepts one conv on a map of ``n_out``
    output rows over an ``n_in``-row input table whose features have
    ``itemsize`` bytes (``sparse/conv.py::_pallas_route_tiled`` under
    ``"pallas-int8"``): ``n_in`` a multiple of 32, then
    ``conv_pallas.supported_dims(n_in, n_out, itemsize)``, whose
    ``_table_fits`` accepts every 32-aligned table whatever ``itemsize``
    (the HBM-streamed route is on), so only the output tile is left."""
    del itemsize
    return n_in % 32 == 0 and n_in > 0 and _pick_tile(n_out) >= 8


def _ranked(*ns) -> bool:
    # the JAX hierarchy builds tiled maps through the rank kernel only on
    # 128-aligned levels (hierarchy._use_rank_kernel)
    return all(n % 128 == 0 and n >= 128 for n in ns)


def q8_route(kind: str, n_fine: int, n_coarse: int, itemsize: int) -> bool:
    """Whether an int8 stage's ``kind`` conv (``"k3"`` on a table level
    of ``n_fine`` rows, ``"down"`` from ``n_fine`` to ``n_coarse`` rows,
    ``"up"`` from ``n_coarse`` to ``n_fine``) runs in int8 on the JAX
    engine: the level carries the tiled map that ``build_hierarchy`` gives
    it under ``"pallas-int8"`` (k3 and down: every level the map spans is
    128-aligned; up: the fine level a multiple of 8) and
    :func:`q8_supported` accepts the conv.  Elsewhere the JAX convs fall
    through to ``conv_kernel_map`` in the features' dtype.  A self-keyed
    int8 level needs no gate: it is built only where ``sk_pack(n, 1) == 1``
    (:func:`uses_k3_tables`)."""
    if kind == "k3":
        return _ranked(n_fine) and q8_supported(n_fine, n_fine, itemsize)
    if kind == "down":
        return (_ranked(n_fine, n_coarse)
                and q8_supported(n_fine, n_coarse, itemsize))
    if kind == "up":
        return n_fine % 8 == 0 and q8_supported(n_coarse, n_fine, itemsize)
    raise ValueError(f"q8_route: kind {kind!r}")


def k3_takes_q8(level: Level, itemsize: int) -> bool:
    """Whether an int8 stage's k3 conv on ``level`` (features of
    ``itemsize`` bytes) runs in int8 (B6 / B7): always on a self-keyed
    level, where :func:`q8_route` accepts it on a table level."""
    n = level.key.shape[1]
    return level.nbr_idx is None or q8_route("k3", n, n, itemsize)


def with_k3_order(level: Level,
                  q8_dtype: Optional[torch.dtype] = None) -> Level:
    """``level`` with its k3 order (``Level.k3_order``, built by
    ``ops.k3_order``) where its k3 convs run the ordered tile: on the card,
    on a level with a k3 bitmap, and not where they run in int8
    (``q8_dtype``: the features' dtype of a stage whose convs take the
    int8 route, else None).  The plain twins of the CPU need no order."""
    if (level.kbits is None or not level.key.is_cuda
            or (q8_dtype is not None
                and k3_takes_q8(level, q8_dtype.itemsize))):
        return level
    return dataclasses.replace(level, k3_order=level_order(level))


def neighbor_tables(level: Level):
    """The level's 27-offset neighbour tables ``(idx [27, B, N] int32,
    hit [27, B, N] bool)`` through the rank kernel (port of
    ``rank_pallas.neighbor_tables`` for K3_OFFSETS): the ranks of
    ``key + delta_k`` in the level's sorted keys, gated by ``kbits``."""
    return rank_lookup(level.key, level.key, K3_DELTAS, level.kbits)


def downsample(off, valid, capacity, stride=2, child_table=True):
    """Stride-``stride`` parents of one level (``_downsample_sort`` +
    ``_downsample_one``, batched).

    One stable sort of the parent keys does everything: the sorted run id of
    a child is its parent's slot, scattered back through the permutation.
    With ``child_table`` (stride 2 only) ``(run_id, octant)`` also
    addresses the k=2 s=2 child map (each slot/octant pair holds at most
    one child).  ``octant`` packs ``off % stride`` per axis into bits 2, 1
    and 0 as JAX does: for stride 3 the fields overlap (ROADMAP C24) and no
    conv reads them.  Returns ``(coarse Level, parent_idx, parent_ok,
    octant)``.
    """
    if child_table and stride != 2:
        raise ValueError(f"child_table by scatter needs stride 2, not "
                         f"{stride}")
    b, n = valid.shape
    p_key = torch.where(valid, pack_key(off // stride), KEY_PAD)
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
    octant = (((off[..., 0] % stride) << 2) | ((off[..., 1] % stride) << 1)
              | (off[..., 2] % stride))
    octant = torch.where(valid, octant, 0).to(torch.int32)
    count = uvalid.sum(dim=1, dtype=torch.int32)
    if not child_table:
        return (Level(off=uoff, key=ukey, valid=uvalid, count=count),
                parent_idx, parent_ok, octant)

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
    coarse = Level(off=uoff, key=ukey, valid=uvalid, count=count,
                   child_idx=child_idx.contiguous(),
                   child_hit=child_hit.contiguous())
    return coarse, parent_idx, parent_ok, octant


def hierarchy_caps(voxel_capacity: int) -> Tuple[int, ...]:
    """Default level 1..4 capacities of a depth-4 hierarchy: the level-0
    capacity, then halving, floor 64 (``trainer.py:200-202``)."""
    return (voxel_capacity, max(voxel_capacity // 2, 64),
            max(voxel_capacity // 4, 64), max(voxel_capacity // 8, 64))


@span("sparse.build_hierarchy")
def build_hierarchy(voxels: SparseVoxels, depth: int,
                    capacities: Optional[Tuple[int, ...]] = None,
                    build_k3: bool = True,
                    k3_tables: Optional[Sequence[bool]] = None,
                    q8_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Level, ...]:
    """Build ``depth + 1`` stride levels (stride 1, 2, ..., 2**depth).

    ``capacities``: per-level voxel capacities of levels 1..depth (default:
    the level-0 capacity halving, floor 64).  ``build_k3``: also build each
    level's k=3 bitmap (``False`` for occupancy probes).  ``k3_tables``:
    per level (``depth + 1`` flags, finest first), whether to build its
    neighbour tables for the table conv (:func:`uses_k3_tables`); None
    builds none (every level self-keyed).  With ``build_k3``, each level
    gets its k3 order where :func:`with_k3_order` (given ``q8_dtype``)
    says its k3 convs read one.  Finest first.
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
        if table:
            idx, hit = neighbor_tables(level)
            level = dataclasses.replace(level, nbr_idx=idx, nbr_hit=hit)
        return with_k3_order(level, q8_dtype)

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


def child_table_plain(parent_off, parent_valid, child_key, offsets, stride=2):
    """Plain twin of ``ops.rank.child_tables`` (JAX ``_child_table_one``,
    batched): per offset d, the coordinates ``parent * stride + d`` packed
    and searched in the sorted child keys.  Returns ``(idx [K, B, Np]
    int32 clamped to N - 1, hit [K, B, Np] bool)``."""
    n = child_key.shape[1]
    key = child_key.contiguous()
    idx, hit = [], []
    for d in np.asarray(offsets):
        q_off = parent_off.to(torch.int32) * stride + torch.as_tensor(
            d, dtype=torch.int32, device=parent_off.device)
        in_range = ((q_off >= 0) & (q_off < COORD_RANGE)).all(dim=-1)
        q = torch.where(parent_valid & in_range, pack_key(q_off), KEY_PAD)
        i = torch.searchsorted(key, q.contiguous()).clamp_max(n - 1)
        idx.append(i.to(torch.int32))
        hit.append((key.gather(1, i) == q) & (q < KEY_PAD))
    return torch.stack(idx), torch.stack(hit)


def downsample_level(level: Level, capacity: int, stride: int = 2,
                     kernel_size: int = 2, build_k3: bool = True,
                     q8_dtype: Optional[torch.dtype] = None):
    """The next-coarser level for a (kernel_size, stride) conv (port of
    ``mrcc_tpu/sparse/hierarchy.py::downsample_level``), the sparse ResNet's
    pyramid: its k=3 s=2 stem, k=2 s=2 pools and stages, k=3 s=3 conv5.

    Parents are the unique ``off // stride`` within ``capacity`` (children
    of parents past it get ``parent_ok`` False and no entry in any map).
    The coarse level carries the strided kernel map ``child_idx`` /
    ``child_hit`` [K, B, Np] (K = 8 for k=2, 27 for k=3, offsets centred on
    ``parent * stride``) from the rank kernel's child-table mode, and with
    ``build_k3`` its ``kbits`` and 27-offset neighbour tables (the JAX
    function always builds tables here, never a self-keyed pack) and its k3
    order as :func:`build_hierarchy` gives one (``q8_dtype``).
    Returns ``(fine level with parent links, coarse level)``.
    """
    coarse, parent_idx, parent_ok, octant = downsample(
        level.off, level.valid, capacity, stride=stride, child_table=False)
    child_idx, child_hit = child_tables(
        coarse.off, coarse.key, coarse.valid, level.key,
        kernel_offsets(kernel_size), stride=stride)
    fine = dataclasses.replace(level, parent_idx=parent_idx,
                               parent_ok=parent_ok,
                               row_ok=level.valid & parent_ok, octant=octant)
    coarse = dataclasses.replace(coarse, child_idx=child_idx,
                                 child_hit=child_hit)
    if build_k3:
        coarse = dataclasses.replace(coarse, kbits=k3_bits(coarse.off,
                                                           coarse.valid))
        idx, hit = neighbor_tables(coarse)
        coarse = with_k3_order(dataclasses.replace(coarse, nbr_idx=idx,
                                                   nbr_hit=hit), q8_dtype)
    return fine, coarse
