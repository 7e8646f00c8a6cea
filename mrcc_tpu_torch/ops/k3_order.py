"""A level's k3 order: the schedule of the k3 convs' ordered tile
(``csrc/k3_order.cu``, read by ``csrc/gather_mma.cuh``).

The one-pass k3 tile takes 64 consecutive rows in key order and runs a ring
stage per offset that any of them hits; 64 neighbouring rows together hit
nearly all 27 offsets although each hits a few, so a tile runs 2-4x the
stages its rows' hits need.  The order cuts the 27 offsets into ``S``
segments of ``27 / S`` (``K3_OFFSETS`` order: segment s holds offsets
``s * 27 / S ...``) and sorts each segment's rows stably by their hit mask
in it, so a tile of one segment takes 64 rows that share their offsets.
Each tile's list (its rows with their flags, their neighbours in the
segment's offsets and the offsets some row hits, with 16-row group masks)
is resolved once per level here and read by every k3 conv on the level,
forward and data cotangent, on both k3 routes: the self-keyed conv reads
the key search's neighbours, the table conv the rank kernel's tables, and
both find the same ones.

The list layout (``order_list_ints(ks)`` int32 a tile, ``ks = 27 / S``):
``nbr[j * 64 + r]`` (the input row of the segment's offset j for tile row
r, -1 for a miss or no row), ``rows[64]`` (the tile row's output row with
``ROW_LOAD``: an earlier segment hits it, and ``ROW_FINAL``: no later one
does; -1 for no row), ``klist[ks]`` (``j | group_mask << 8`` of each offset
some row hits, ascending; 0 after), the count of those offsets and the
number of rows.  Segment 0 also holds every row with no hit at all, so that
it is stored as zeros.

:func:`build_k3_order` runs the card's three stages for CUDA tensors (the
rows kernel, K1, the lists kernel) and :func:`build_k3_order_plain` for CPU
tensors.  Every level takes ``SEGMENTS``; the keywords ``segments`` and
``sort`` build other schedules for the tests, ``segments=1, sort=False``
the identity order, the one-pass tile's own schedule, which the ordered
tile is held to bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, stream_ptr
from .sort import argsort

LIB = KernelLibrary("k3_order", {
    "mrcc_k3_order_rows_keys": (P, P, P, P, P, I, I, I, P),
    "mrcc_k3_order_rows_table": (P, P, P, P, P, I, I, I, P),
    "mrcc_k3_order_lists": (P, P, P, P, P, P, I, I, I, P),
})
K3_ORDER = LaunchCounter("k3_order")  # the rows and the lists kernels

ROWS = 64                 # BM of csrc/gather_mma.cuh
ROW_LOAD = 1 << 30        # ROW_LOAD, ROW_FINAL, ROW_INDEX of gather_mma.cuh
ROW_FINAL = 1 << 29
ROW_INDEX = ROW_FINAL - 1
SEGMENTS = 3              # the segments of a level's order


def order_list_ints(ks: int) -> int:
    """int32 of one tile's list for segments of ``ks`` offsets."""
    return ks * ROWS + ROWS + ks + 2


@dataclasses.dataclass(frozen=True)
class K3Order:
    """A level's k3 order.

    lists:  int32 [S, B, tiles, order_list_ints(27 / S)], the tiles' lists.
    counts: int32 [S, B], the tiles of each (segment, item) that hold rows
      (they come first; the ordered tile runs those alone).
    mask:   int32 [B, N], each row's hit mask (bit k: offset k hits).
    """

    lists: torch.Tensor
    counts: torch.Tensor
    mask: torch.Tensor

    @property
    def segments(self) -> int:
        return self.lists.shape[0]

    @property
    def offsets(self) -> int:
        """Offsets of a segment."""
        return 27 // self.segments

    def fields(self):
        """``(nbr [S, B, tiles, ks, 64], rows [S, B, tiles, 64], klist [S,
        B, tiles, ks], count [S, B, tiles], live [S, B, tiles])``: views of
        the lists."""
        ks = self.offsets
        nbr = self.lists[..., :ks * ROWS].unflatten(-1, (ks, ROWS))
        rows = self.lists[..., ks * ROWS:ks * ROWS + ROWS]
        klist = self.lists[..., ks * ROWS + ROWS:ks * ROWS + ROWS + ks]
        return (nbr, rows, klist, self.lists[..., -2], self.lists[..., -1])


def _check(key, kbits, nbr_idx, nbr_hit, segments, sort):
    if 27 % segments or (not sort and segments != 1):
        raise ValueError(f"k3 order: {segments} segments, sort={sort}: "
                         "segments must divide 27, and an unsorted order "
                         "has one")
    b, n = key.shape
    if kbits.shape != (b, n) or kbits.dtype != torch.int32 \
            or key.dtype != torch.int32:
        raise ValueError("k3 order: key / kbits must be int32 [B, N]")
    if (nbr_idx is None) != (nbr_hit is None) or (
            nbr_idx is not None and (nbr_idx.shape != (27, b, n)
                                     or nbr_hit.shape != (27, b, n)
                                     or nbr_idx.dtype != torch.int32
                                     or nbr_hit.dtype != torch.bool)):
        raise ValueError("k3 order: tables must be int32 / bool [27, B, N]")
    if n > ROW_INDEX:
        raise ValueError(f"k3 order: {n} rows exceed {ROW_INDEX}")
    return b, n


def _sort_keys(mask, segments):
    """[S, B, N] int32: the segments' sub-masks, 0 for a row with no hit in
    segment 0, else 1 << ks (no part in the segment)."""
    ks = 27 // segments
    subs = []
    for s in range(segments):
        sub = (mask >> (s * ks)) & ((1 << ks) - 1)
        none = 0 if s == 0 else 1 << ks
        subs.append(torch.where(sub != 0, sub,
                                torch.where(mask == 0, none, 1 << ks)))
    return torch.stack(subs).to(torch.int32)


def build_k3_order_plain(key, kbits, nbr_idx=None, nbr_hit=None, *,
                         segments: int = SEGMENTS, sort: bool = True
                         ) -> K3Order:
    """Plain twin of :func:`build_k3_order`."""
    from ..sparse.hierarchy import K3_DELTAS

    b, n = _check(key, kbits, nbr_idx, nbr_hit, segments, sort)
    dev = key.device
    if nbr_idx is None:
        key = key.contiguous()
        idx, hit = [], []
        for k, d in enumerate(K3_DELTAS):
            q = key + d
            i = torch.searchsorted(key, q).clamp_max(max(n - 1, 0))
            idx.append(i)
            hit.append((((kbits >> k) & 1) != 0) & (key.gather(1, i) == q))
        nbr_idx, nbr_hit = torch.stack(idx), torch.stack(hit)
    nbr = torch.where(nbr_hit, nbr_idx.long(), -1)           # [27, B, N]
    bits = torch.tensor([1 << k for k in range(27)], device=dev)
    mask = (nbr_hit.long() * bits[:, None, None]).sum(0).to(torch.int32)
    ks = 27 // segments
    tiles = -(-n // ROWS)
    pad = tiles * ROWS - n
    if sort:
        skey, perm = torch.sort(_sort_keys(mask, segments), dim=-1,
                                stable=True)
        row = torch.where(skey != 1 << ks, perm, -1)          # [S, B, N]
    else:
        row = torch.arange(n, device=dev).expand(1, b, n)
    row = torch.nn.functional.pad(row, (0, pad), value=-1)
    row = row.reshape(segments, b, tiles, ROWS)
    ok = row >= 0
    safe = row.clamp_min(0)
    m = mask.long().gather(1, safe.reshape(segments, b, -1).permute(1, 0, 2)
                           .reshape(b, -1)).reshape(b, segments, tiles, ROWS)
    m = m.permute(1, 0, 2, 3)
    seg = torch.arange(segments, device=dev)[:, None, None, None]
    flags = (torch.where((m & ((1 << (seg * ks)) - 1)) != 0, ROW_LOAD, 0)
             | torch.where((m >> ((seg + 1) * ks)) == 0, ROW_FINAL, 0))
    rows = torch.where(ok, safe | flags, -1)
    # neighbours of each tile row in the segment's offsets
    nb = nbr.permute(1, 2, 0)                                 # [B, N, 27]
    g = nb.gather(1, safe.permute(1, 0, 2, 3).reshape(b, -1, 1)
                  .expand(-1, -1, 27))                        # [B, S*T*64, 27]
    g = g.reshape(b, segments, tiles, ROWS, segments, ks)
    g = torch.stack([g[:, s, :, :, s] for s in range(segments)])
    g = torch.where(ok[..., None], g, -1)                     # [S,B,T,64,ks]
    g = g.transpose(-1, -2)                                   # [S,B,T,ks,64]
    groups = (g >= 0).reshape(*g.shape[:-1], 4, 16).any(-1)
    gmask = (groups.long() * torch.tensor([1, 2, 4, 8], device=dev)).sum(-1)
    hit_any = gmask != 0                                      # [S,B,T,ks]
    j = torch.arange(ks, device=dev)
    entry = torch.where(hit_any, j | (gmask << 8), 0)
    # compact: hit offsets first, ascending
    order = torch.sort((~hit_any).long() * ks + j, dim=-1).indices
    klist = torch.where(hit_any.gather(-1, order), entry.gather(-1, order), 0)
    count = hit_any.sum(-1, keepdim=True)
    live = ok.sum(-1, keepdim=True)
    lists = torch.cat([g.flatten(-2), rows, klist, count, live], dim=-1)
    return K3Order(lists=lists.to(torch.int32).contiguous(),
                   counts=(live[..., 0] > 0).sum(-1).to(torch.int32),
                   mask=mask)


def build_k3_order(key, kbits, nbr_idx=None, nbr_hit=None, *,
                   segments: int = SEGMENTS, sort: bool = True) -> K3Order:
    """The k3 order of one level.

    Args:
      key, kbits: int32 [B, N], the level's sorted keys and k3 bitmap.
      nbr_idx, nbr_hit: the level's neighbour tables (int32 / bool [27, B,
        N]) where it takes the table route, else None (the key search).
      segments: S, a divisor of 27; sort: sort each segment's rows by their
        hit mask in it (else the identity order, S = 1).  Both are for
        tests; the levels take the defaults.
    Returns a :class:`K3Order`.  CUDA tensors run the kernels (two launches
    on ``K3_ORDER`` and one K1 sort), CPU tensors the plain twin.
    """
    if not key.is_cuda:
        return build_k3_order_plain(key, kbits, nbr_idx, nbr_hit,
                                    segments=segments, sort=sort)
    b, n = _check(key, kbits, nbr_idx, nbr_hit, segments, sort)
    ks = 27 // segments
    tiles = -(-n // ROWS)
    dev = key.device
    nbr_rows = torch.empty((b, n, 27), dtype=torch.int32, device=dev)
    mask = torch.empty((b, n), dtype=torch.int32, device=dev)
    keys = (torch.empty((segments, b, n), dtype=torch.int32, device=dev)
            if sort else None)
    lists = torch.empty((segments, b, tiles, order_list_ints(ks)),
                        dtype=torch.int32, device=dev)
    counts = torch.empty((segments, b), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return K3Order(lists=lists, counts=counts.zero_(), mask=mask)
    stream = stream_ptr(key)
    if nbr_idx is None:
        LIB.call("mrcc_k3_order_rows_keys", ptr(key.contiguous()),
                 ptr(kbits.contiguous()), ptr(nbr_rows), ptr(mask), ptr(keys),
                 b, n, segments, stream)
    else:
        LIB.call("mrcc_k3_order_rows_table", ptr(nbr_idx.contiguous()),
                 ptr(nbr_hit.contiguous()), ptr(nbr_rows), ptr(mask),
                 ptr(keys), b, n, segments, stream)
    skey = perm = None
    if sort:
        skey, perm = argsort(keys.view(segments * b, n))
    LIB.call("mrcc_k3_order_lists", ptr(nbr_rows), ptr(mask), ptr(skey),
             ptr(perm), ptr(lists), ptr(counts), b, n, segments, stream)
    K3_ORDER.launches += 2
    return K3Order(lists=lists, counts=counts, mask=mask)


def tile_stages(order: K3Order):
    """``(tile-offset pairs with a hit, 16-row MMA groups with a hit)``
    that the ordered tile runs over ``order``: the ring stages of one
    32-channel chunk and the MMA slots, each a 64- or 16-row unit."""
    _, _, klist, _, _ = order.fields()
    groups = (klist >> 8) & 0xF
    bits = sum(((groups >> i) & 1) for i in range(4))
    return int((groups != 0).sum()), int(bits.sum())


def key_order_stages(mask: torch.Tensor):
    """:func:`tile_stages` of the one-pass tile, from the hit masks
    ``mask`` [B, N] alone: 64 consecutive rows a tile, all 27 offsets."""
    b, n = mask.shape
    tiles = -(-n // ROWS)
    m = torch.nn.functional.pad(mask.long(), (0, tiles * ROWS - n))
    bits = (m[..., None] >> torch.arange(27, device=m.device)) & 1
    groups = bits.reshape(b, tiles * 4, 16, 27).any(2)
    pairs = groups.reshape(b, tiles, 4, 27).any(2)
    return int(pairs.sum()), int(groups.sum())


def hits(order: K3Order) -> int:
    """The level's (row, offset) hits."""
    m = order.mask.long()
    return int(sum(((m >> k) & 1).sum() for k in range(27)))


def level_order(level) -> Optional[K3Order]:
    """:func:`build_k3_order` of a level (its tables where it has them),
    None for an empty one."""
    b, n = level.key.shape
    if b == 0 or n == 0:
        return None
    return build_k3_order(level.key, level.kbits, level.nbr_idx,
                          level.nbr_hit)
