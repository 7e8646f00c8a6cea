"""Hit lists: the per-offset hits of a gather map in row order, listed once
a map and read by every conv that gathers over it.

K3's down and up convs (``ops/conv.py``), their int8 counterparts
(``ops/conv_q8.py``), the data cotangents of the down and up convs and the
four dW kernels read a map through its lists: for each offset k, in row
order ``r = b * n_rows + i``, every row whose source ``j`` is a hit gives
the pair ``(b * n_in + j, r)``, and ``count[k]`` is the number of hits of
k.  The maps, by kind (each with the tensors it is read from):

- ``"sk"``: a level's k3 map by the self-keyed search (``key``, ``kbits``
  int32 [B, n]); ``"k3map"``: the same map by the level's neighbour tables
  (``nbr_idx`` int32, ``nbr_hit`` bool [27, B, n]).  Both give the same
  lists, which the k3 dW kernels read.
- ``"down"``: a coarse level's child map (``child_idx`` int32,
  ``child_hit`` bool [8, B, n_out]) into the fine level's ``n_in`` rows:
  the down conv and its dW, the up conv's data cotangent.
- ``"up"``: a fine level's parent map (``parent_idx`` int32, ``row_ok``
  bool, ``octant`` int32 [B, n_out]) into the coarse level's ``n_in``
  rows: the up conv and its dW, the down conv's data cotangent.

A :class:`HitLists` lists its map at the first read of ``lists`` or
``count`` and holds them after: on the card one launch of
``csrc/hit_lists.cu`` (a memset and the list kernel, counted by
:data:`LISTS`), on the CPU the plain twin :func:`hit_lists_plain`.
``sparse/conv.py`` keeps one a map on each card level, so that a step
lists each map once, whoever reads it first.  A reader given no lists
makes its own.  This module imports nothing from ``sparse``.
"""

from __future__ import annotations

import torch

from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, route, stream_ptr

LIB = KernelLibrary("hit_lists", {
    "mrcc_hit_lists_sk": (P, P, P, P, P, I, I, P),
    "mrcc_hit_lists_k3map": (P, P, P, P, P, I, I, P),
    "mrcc_hit_lists_down": (P, P, P, P, P, I, I, I, P),
    "mrcc_hit_lists_up": (P, P, P, P, P, P, I, I, I, P),
})
LISTS = LaunchCounter("hit_lists")  # every list launch, whatever the map

TAPS = {"sk": 27, "k3map": 27, "down": 8, "up": 8}
_MAPS = {"sk": (torch.int32, torch.int32),
         "k3map": (torch.int32, torch.bool),
         "down": (torch.int32, torch.bool),
         "up": (torch.int32, torch.bool, torch.int32)}
_TILE = 2048  # TILE of csrc/hit_lists.cu

# Packed key deltas of the 27 k3 offsets, x slowest, z fastest, 10 bits an
# axis (``sparse/types.py``): ``sparse.hierarchy.K3_DELTAS``, computed as the
# card's ``k3_delta`` (``csrc/gather_gemm.cuh``) does.
K3_DELTAS = tuple(((k // 9 - 1) << 20) + (((k // 3) % 3 - 1) << 10)
                  + (k % 3 - 1) for k in range(27))


def _sk_neighbours(key, kbits, k, d):
    """(row index, hit) of offset k for every row: searchsorted in the
    sorted key row, gated by the offset bit."""
    q = key + d
    idx = torch.searchsorted(key, q).clamp_max(key.shape[1] - 1)
    hit = (((kbits >> k) & 1) != 0) & (key.gather(1, idx) == q)
    return idx, hit


def _list_sources(kind, maps):
    """``(hit [K, B, N] bool, source row j [K, B, N])`` of a map."""
    if kind == "sk":
        key, kbits = maps
        pairs = [_sk_neighbours(key.contiguous(), kbits, k, d)
                 for k, d in enumerate(K3_DELTAS)]
        return (torch.stack([hit for _, hit in pairs]),
                torch.stack([idx for idx, _ in pairs]))
    if kind in ("down", "k3map"):
        idx, hit = maps
        return hit, idx
    parent_idx, row_ok, octant = maps
    return (torch.stack([row_ok & (octant == k) for k in range(8)]),
            parent_idx.expand(8, -1, -1))


def hit_lists_plain(kind, n_in, *maps):
    """The lists of a map on any device: ``(fidx, gidx, count)``, int32
    [K, B * n_rows] feature rows ``b * n_in + j`` and g rows ``r`` of the
    hits of offset k in ``[:count[k]]``, -1 after; count int32 [K]."""
    hit, j = _list_sources(kind, maps)
    k_taps, b, n = hit.shape
    hit = hit.reshape(k_taps, b * n)
    base = n_in * torch.arange(b, device=hit.device)[:, None]
    src = (j.long() + base).reshape(k_taps, b * n)
    fidx = torch.full((k_taps, b * n), -1, dtype=torch.int32,
                      device=hit.device)
    gidx = fidx.clone()
    for k in range(k_taps):
        rows = torch.nonzero(hit[k]).flatten()
        fidx[k, :len(rows)] = src[k, rows].int()
        gidx[k, :len(rows)] = rows.int()
    return fidx, gidx, hit.sum(1).int()


def _launch(kind, n_in, maps):
    """One list launch on checked, contiguous CUDA maps: ``(lists [2, K,
    B * n_rows] int32, count [K] int32)``, the entries past ``count[k]``
    unwritten."""
    b, n = maps[0].shape[-2:]
    k_taps, rows = TAPS[kind], b * n
    lists = torch.empty((2, k_taps, rows), dtype=torch.int32,
                        device=maps[0].device)
    count = torch.empty(k_taps, dtype=torch.int32, device=maps[0].device)
    status = torch.empty(k_taps * -(-rows // _TILE) + 1, dtype=torch.int64,
                         device=maps[0].device)
    sizes = (b, n) if kind in ("sk", "k3map") else (b, n_in, n)
    LIB.call(f"mrcc_hit_lists_{kind}", *map(ptr, maps), ptr(lists),
             ptr(status), ptr(count), *sizes, stream_ptr(maps[0]))
    LISTS.launches += 1
    return lists, count


class HitLists:
    """The hit lists of one map (module docstring): ``lists`` int32 [2, K,
    B * n_rows] (``lists[0]`` the gathered rows ``b * n_in + j``,
    ``lists[1]`` the map rows ``r``; on the card the entries past
    ``count[k]`` are unwritten) and ``count`` int32 [K], listed at the first
    read of either and held after.

    Args:
      kind: "sk", "k3map", "down" or "up".
      n_in: rows of the gathered level (the fine level for "down", the
        coarse one for "up", the level itself for "sk" and "k3map").
      maps: the kind's tensors, as the conv wrappers take them.
    """

    def __init__(self, kind, n_in, *maps):
        if kind not in TAPS:
            raise ValueError(f"HitLists: unknown kind {kind!r}")
        if len(maps) != len(_MAPS[kind]) or any(
                m.dtype != d for m, d in zip(maps, _MAPS[kind])):
            raise ValueError(f"HitLists: {kind} maps must be {_MAPS[kind]}")
        if any(m.shape != maps[0].shape for m in maps) or maps[0].dim() != (
                2 if kind in ("sk", "up") else 3) or (
                maps[0].dim() == 3 and maps[0].shape[0] != TAPS[kind]):
            raise ValueError(f"HitLists: {kind} map shapes "
                             f"{[tuple(m.shape) for m in maps]}")
        if kind in ("sk", "k3map") and n_in != maps[0].shape[-1]:
            raise ValueError(f"HitLists: {kind} gathers its own level")
        self.kind, self.n_in, self.rows = kind, n_in, maps[0].shape[-2:]
        self._maps, self._held = maps, None

    def _get(self):
        if self._held is None:
            if route(*self._maps):
                self._held = _launch(self.kind, self.n_in,
                                     [m.contiguous() for m in self._maps])
            else:
                fidx, gidx, count = hit_lists_plain(self.kind, self.n_in,
                                                    *self._maps)
                self._held = torch.stack((fidx, gidx)), count
            self._maps = None
        return self._held

    @property
    def lists(self):
        return self._get()[0]

    @property
    def count(self):
        return self._get()[1]

    def entries(self):
        """``(fidx, gidx, count)`` as :func:`hit_lists_plain` gives them:
        -1 past ``count[k]``."""
        lists, count = self._get()
        listed = (torch.arange(lists.shape[2], device=count.device)[None]
                  < count[:, None])
        return (torch.where(listed, lists[0], -1),
                torch.where(listed, lists[1], -1), count)

    def check(self, name, kinds, n_in, rows):
        """Raise unless these lists are of a map of ``kinds`` over ``n_in``
        gathered rows and ``rows`` ([B, n]) map rows."""
        if (self.kind not in kinds or self.n_in != n_in
                or tuple(self.rows) != tuple(rows)):
            raise ValueError(
                f"{name}: lists of a {self.kind} map of {tuple(self.rows)} "
                f"rows over {self.n_in}, need {kinds} of {tuple(rows)} over "
                f"{n_in}")
