"""K1 — stable ascending argsort of int32 keys (``csrc/sort.cu``: an LSD
radix sort, three passes of 11-bit digits over tiles of 2048 entries).

Replaces ``mrcc_tpu/ops/sort_pallas.py::bitonic_argsort``; unlike it, and
like the JAX package's XLA fallback (``mrcc_tpu/sparse/sorting.py``), it
takes any row length.  The contract is stable order under duplicates:
voxelize passes many points per voxel key and every downsample many
children per parent key, plus KEY_PAD rows.
``sort_pallas.py`` documents "valid entries unique"; the callers never
guaranteed it, and neither kernel needs it.
"""

from __future__ import annotations

import torch

from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, stream_ptr

_TILE = 2048     # entries of one radix tile (csrc/sort.cu kTile)
_RADIX = 2048    # buckets of an 11-bit digit
_MAX_B = 65535   # grid.y

LIB = KernelLibrary("sort", {
    "mrcc_argsort_i32": (P, P, P, P, I, I, P),
})
SORT = LaunchCounter("argsort")


def argsort_plain(key: torch.Tensor):
    """Plain twin of :func:`argsort`: ``torch.sort(stable=True)``."""
    skey, order = torch.sort(key, dim=-1, stable=True)
    return skey, order.to(torch.int32)


def argsort(key: torch.Tensor):
    """Stable ascending argsort of int32 keys ``[B, N]``.

    Returns ``(sorted_key [B, N] int32, perm [B, N] int32)`` with
    ``sorted_key == key.gather(-1, perm)``; equal keys keep index order.
    CUDA tensors run the kernel (any N an int32 index reaches), CPU tensors
    the plain twin.
    """
    if key.device.type == "cpu":
        return argsort_plain(key)
    if not key.is_cuda:
        raise ValueError(f"argsort: unsupported device {key.device}")
    if key.dtype != torch.int32 or key.dim() != 2:
        raise ValueError(f"argsort: needs int32 [B, N], got {key.dtype} "
                         f"{tuple(key.shape)}")
    b, n = key.shape
    if b > _MAX_B:
        raise ValueError(f"argsort: B = {b} exceeds {_MAX_B}")
    key = key.contiguous()
    out = torch.empty((2, b, n), dtype=torch.int32, device=key.device)
    skey, perm = out[0], out[1]
    if b == 0 or n == 0:
        return skey, perm
    tiles = -(-n // _TILE)
    # ping-pong keys and indices, the three passes' tile histograms, one
    # pass's tile offsets and the row histograms (csrc/sort.cu)
    scratch = torch.empty(2 * b * n + 4 * b * tiles * _RADIX + 3 * b * _RADIX,
                          dtype=torch.int32, device=key.device)
    LIB.call("mrcc_argsort_i32", ptr(key), ptr(skey), ptr(perm),
             ptr(scratch), b, n, stream_ptr(key))
    SORT.launches += 1
    return skey, perm
