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
K <= 32.  A miss's ``idx`` is its query's clamped rank; nothing reads it.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .build import I, KernelLibrary, LaunchCounter, P, ptr, stream_ptr

LIB = KernelLibrary("rank", {
    "mrcc_rank_lookup": (P, P, P, P, P, P, I, I, I, I, P),
})
RANK = LaunchCounter("rank")
MAX_K = 32


def rank_plan(deltas: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """The kernel's processing order: ``(offsets, deltas, chain)`` with the
    offsets sorted by delta and ``chain[j]`` 1 where ``deltas[j]`` is the
    previous delta plus 1 (its rank follows from the previous one)."""
    order = sorted(range(len(deltas)), key=lambda k: deltas[k])
    ds = [int(deltas[k]) for k in order]
    chain = [0] + [int(ds[j] == ds[j - 1] + 1) for j in range(1, len(ds))]
    return tuple(order), tuple(ds), tuple(chain)


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
             stream_ptr(keys))
    RANK.launches += 1
    return idx, hit
