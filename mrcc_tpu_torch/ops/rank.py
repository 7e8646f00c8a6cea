"""B8 — rank lookup of shifted queries in sorted keys (``csrc/rank.cu``).

Replaces ``mrcc_tpu/ops/rank_pallas.py::_rank_call`` (called through its
``rank_lookup``): the neighbour tables of a level are the ranks of
``key + delta_k`` in the level's own sorted keys.  The TPU kernel's window
boundaries, 128-row tiles and delta runs of at most 3 serve its VMEM lane
slices; the function is

    idx[k, b, i] = min(#{j : keys[b, j] < qbase[b, i] + delta_k}, N - 1)
    hit[k, b, i] = bit_k(qbits[b, i]) and qbase[b, i] + delta_k in keys[b]

at any N and Nq.  Query validity travels as the per-row int32 bitmap of
``sparse.hierarchy.k3_bits`` (``rank_pallas._border_qvalid`` packed), so
K <= 32.  :func:`child_tables` is the kernel's child-table mode
(``rank_pallas.child_tables``): the strided kernel maps of
``hierarchy.downsample_level``, queries ``pack(parent * stride) + delta_k``
in the finer level's keys.  A miss's ``idx`` is its query's clamped rank;
nothing reads it.  The card kernel searches each block of ``RANK_ROWS``
query rows inside the windows of keys its ranks can take
(:func:`rank_windows`), staged side by side in shared memory while they
fit in ``RANK_WINDOW`` keys.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, stream_ptr

LIB = KernelLibrary("rank", {
    "mrcc_rank_lookup": (P, P, P, P, P, P, I, I, I, I, I, I, P),
})
RANK = LaunchCounter("rank")
MAX_K = 32
RANK_ROWS = 256     # query rows a block (T)
RANK_WINDOW = 4096  # keys a block stages in shared memory (W)
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def rank_plan(deltas: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """The kernel's processing order: ``(offsets, deltas, chain)`` with the
    offsets sorted by delta and ``chain[j]`` 1 where ``deltas[j]`` is the
    previous delta plus 1 (its rank follows from the previous one)."""
    order = sorted(range(len(deltas)), key=lambda k: deltas[k])
    ds = [int(deltas[k]) for k in order]
    chain = [0] + [int(ds[j] == ds[j - 1] + 1) for j in range(1, len(ds))]
    return tuple(order), tuple(ds), tuple(chain)


def rank_groups(deltas: Sequence[int]):
    """The chained groups of :func:`rank_plan`: ``(j0, j1)`` plan positions
    of each run whose ranks follow from the first one's search."""
    chain = rank_plan(deltas)[2]
    starts = [j for j, c in enumerate(chain) if not c]
    return tuple(zip(starts, starts[1:] + [len(chain)]))


def rank_windows(keys, qbase, deltas):
    """The card kernel's key windows.  A block of ``RANK_ROWS`` query rows
    has two windows for each group of :func:`rank_groups`: set 0 for its
    rows under the block's largest base, set 1 for the rows at it.  Each
    holds the ranks ``[lo, hi]`` the set's searches stay in
    (``lower_bound`` of the set's smallest base plus the group's first
    delta, and of its largest base plus the last delta; the whole row where
    a query can wrap around int32; ``lo = hi = N`` for an empty set 0).
    ``wide``: the block searches global memory for the window.  A block
    stages its windows side by side, in (group, set) order, while their sum
    stays within ``RANK_WINDOW`` keys (a window over that is never staged).
    Returns ``(lo, hi, wide)``, each ``[G, 2, B, ceil(Nq / RANK_ROWS)]``."""
    rows = RANK_ROWS
    b, n = keys.shape
    nq = qbase.shape[1]
    nb = -(-nq // rows)
    pad = qbase[:, -1:].expand(b, nb * rows - nq)  # the kernel's dead rows
    blocks = torch.cat([qbase, pad], 1).reshape(b, nb, rows).long()
    qmin, qmax = blocks.amin(-1), blocks.amax(-1)
    below = blocks < qmax[..., None]
    top = torch.where(below, blocks, INT32_MIN).amax(-1)
    ds = rank_plan(deltas)[1]
    groups = rank_groups(deltas)
    q_lo = torch.stack([torch.stack([qmin + ds[j0], qmax + ds[j0]])
                        for j0, _ in groups])                 # [G, 2, B, nb]
    q_hi = torch.stack([torch.stack([top + ds[j1 - 1], qmax + ds[j1 - 1]])
                        for _, j1 in groups])
    wraps = (q_lo < INT32_MIN) | (q_hi > INT32_MAX)
    empty = torch.stack([~below.any(-1), torch.zeros_like(qmax, dtype=bool)])

    def lower_bound(q):
        q = q.clamp(INT32_MIN, INT32_MAX).to(torch.int32)
        flat = q.permute(2, 0, 1, 3).reshape(b, -1).contiguous()
        return torch.searchsorted(keys.contiguous(), flat).reshape(
            b, len(groups), 2, nb).permute(1, 2, 0, 3)

    lo = torch.where(wraps, 0, lower_bound(q_lo)).masked_fill(empty, n)
    hi = torch.where(wraps, n, lower_bound(q_hi)).masked_fill(empty, n)
    length = hi.clamp_max(n - 1) - lo + 1
    fits = length <= RANK_WINDOW
    end = torch.where(fits, length, 0).flatten(0, 1).cumsum(0).view_as(lo)
    return lo, hi, ~(fits & (end <= RANK_WINDOW))


@functools.lru_cache(maxsize=16)
def _device_plan(deltas, device):
    """:func:`rank_plan` as an int32 [3, K] tensor on ``device``, copied
    once per delta set (not on every launch)."""
    return torch.tensor(rank_plan(deltas), dtype=torch.int32, device=device)


def rank_lookup_plain(keys, qbase, deltas, qbits):
    """Plain twin of :func:`rank_lookup`: ``torch.searchsorted`` (left)
    clamped to N - 1, then a gather-compare."""
    b, n = keys.shape
    nq = qbase.shape[1]
    k = len(deltas)
    d = torch.tensor(deltas, dtype=torch.int32, device=keys.device)
    q = qbase[None] + d[:, None, None]                        # [K, B, Nq]
    flat = q.permute(1, 0, 2).reshape(b, k * nq)
    rank = torch.searchsorted(keys.contiguous(), flat.contiguous())
    idx = rank.clamp_max(n - 1).to(torch.int32)
    found = keys.gather(1, idx.long()) == flat
    idx = idx.reshape(b, k, nq).permute(1, 0, 2).contiguous()
    found = found.reshape(b, k, nq).permute(1, 0, 2)
    shift = torch.arange(k, dtype=torch.int32, device=keys.device)
    bit = ((qbits[None] >> shift[:, None, None]) & 1) != 0
    return idx, (found & bit).contiguous()


def rank_lookup(keys, qbase, deltas, qbits):
    """Ranks and hits of ``qbase + delta_k`` in sorted ``keys``.

    Args:
      keys: int32 [B, N] ascending per item (KEY_PAD padding), N >= 1.
      qbase: int32 [B, Nq] query bases (a level's own keys for k3 tables).
      deltas: K <= 32 Python ints (packed key deltas of the offsets).
      qbits: int32 [B, Nq]; bit k set where offset k's query is valid.
    Returns ``(idx int32 [K, B, Nq], hit bool [K, B, Nq])``.
    """
    deltas = tuple(int(d) for d in deltas)
    k = len(deltas)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"rank_lookup: {k} deltas, need 1..{MAX_K}")
    if keys.dim() != 2 or keys.shape[1] < 1 or qbase.dim() != 2 \
            or qbase.shape[0] != keys.shape[0] or qbits.shape != qbase.shape:
        raise ValueError(f"rank_lookup: keys {tuple(keys.shape)}, qbase "
                         f"{tuple(qbase.shape)}, qbits {tuple(qbits.shape)} "
                         "do not fit [B, N>=1] / [B, Nq] / [B, Nq]")
    for t in (keys, qbase, qbits):
        if t.dtype != torch.int32:
            raise ValueError(f"rank_lookup: {t.dtype}, need int32")
    devices = {t.device for t in (keys, qbase, qbits)}
    if len(devices) != 1:
        raise ValueError(f"rank_lookup: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return rank_lookup_plain(keys, qbase, deltas, qbits)
    if dev.type != "cuda":
        raise ValueError(f"rank_lookup: unsupported device {dev}")
    b, n = keys.shape
    nq = qbase.shape[1]
    idx = torch.empty((k, b, nq), dtype=torch.int32, device=dev)
    hit = torch.empty((k, b, nq), dtype=torch.bool, device=dev)
    keys, qbase = keys.contiguous(), qbase.contiguous()
    qbits = qbits.contiguous()
    LIB.call("mrcc_rank_lookup", ptr(keys), ptr(qbase), ptr(qbits),
             ptr(_device_plan(deltas, dev)), ptr(idx), ptr(hit), b, n, nq, k,
             RANK_ROWS, RANK_WINDOW, stream_ptr(keys))
    RANK.launches += 1
    return idx, hit


@functools.lru_cache(maxsize=16)
def _device_offsets(offsets, device):
    """Kernel offsets ``[K, 3]`` as an int32 tensor on ``device``, copied
    once per offset set."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def border_bits(off, valid, offsets, scaled=1):
    """Per-row query-validity bitmap ``[B, N]`` int32 of ``offsets`` [K, 3]
    (K <= 32): bit k is set iff the row is valid and ``off * scaled +
    offsets[k]`` lies inside the coordinate window on every axis
    (``rank_pallas._border_qvalid(scaled=...)`` packed as ``sk_bits``
    packs it).  All K offsets in one pass of a few launches."""
    from ..sparse.types import COORD_RANGE

    d = _device_offsets(tuple(tuple(int(v) for v in o) for o in offsets),
                        off.device)
    q = (off * scaled)[None] + d[:, None, None, :]            # [K, B, N, 3]
    inside = ((q >= 0) & (q < COORD_RANGE)).all(dim=-1) & valid[None]
    shift = torch.arange(d.shape[0], device=off.device)[:, None, None]
    return (inside.long() << shift).sum(dim=0).to(torch.int32)


def child_query_base(parent_key, parent_valid, stride):
    """Query bases of the child-table mode: ``stride * parent_key`` on valid
    rows, ``KEY_PAD`` on padding rows (never a scaled ``KEY_PAD``)."""
    from ..sparse.types import KEY_PAD

    return (parent_key.masked_fill(~parent_valid, 0) * stride).masked_fill(
        ~parent_valid, KEY_PAD)


def child_tables(parent_off, parent_key, parent_valid, child_key, offsets,
                 stride=2):
    """Strided kernel maps through the rank kernel (port of
    ``rank_pallas.child_tables``): for each parent row and offset d, the
    row of the child level at ``parent * stride + d``.

    The query base is ``stride * parent_key``, which equals
    ``pack(parent_off * stride)``: a parent's coordinates times the stride
    stay under 1024 (at most 2 * 511 or 3 * 341), so no field carries.
    Padding rows take ``KEY_PAD`` and are never shifted or multiplied
    (ROADMAP C15: ``KEY_PAD << 1`` wraps to INT32_MIN).  The query bits are
    the scaled border masks of :func:`border_bits`.

    Args:
      parent_off: int32 [B, Np, 3]; parent_key: int32 [B, Np] (the coarse
        level's sorted keys, KEY_PAD padding); parent_valid: bool [B, Np].
      child_key: int32 [B, N] sorted keys of the finer level.
      offsets: [K, 3] kernel offsets (K2_OFFSETS, or the k=3 cube centred
        on ``parent * stride``).
    Returns ``(idx int32 [K, B, Np], hit bool [K, B, Np])``; a miss's
    ``idx`` is its query's clamped rank (compare ``idx`` where ``hit``).
    """
    from ..sparse.types import COORD_BITS

    offsets = [tuple(int(v) for v in d) for d in offsets]
    deltas = [(d[0] << (2 * COORD_BITS)) + (d[1] << COORD_BITS) + d[2]
              for d in offsets]
    qbase = child_query_base(parent_key, parent_valid, stride)
    qbits = border_bits(parent_off, parent_valid, offsets, scaled=stride)
    return rank_lookup(child_key, qbase, deltas, qbits)
