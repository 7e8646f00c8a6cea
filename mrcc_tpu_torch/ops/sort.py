"""K1 — stable ascending argsort of int32 keys (``csrc/sort.cu``).

Replaces ``mrcc_tpu/ops/sort_pallas.py::bitonic_argsort``.  The contract is
stable order under duplicates: voxelize passes many points per voxel key
and every downsample many children per parent key, plus KEY_PAD rows.
``sort_pallas.py`` documents "valid entries unique"; the callers never
guaranteed it, and neither kernel needs it.
"""

from __future__ import annotations

import torch

from .build import I, KernelLibrary, LaunchCounter, P, ptr, stream_ptr

MAX_N = 1 << 17          # the TPU kernel's range (sort_pallas.supported)
_CHUNK = 1 << 14         # entries one block sorts in shared memory

LIB = KernelLibrary("sort", {
    "mrcc_argsort_i32": (P, P, P, P, I, I, I, P),
})
SORT = LaunchCounter("argsort")


def _next_pow2(n: int) -> int:
    p = 2
    while p < n:
        p <<= 1
    return p


def argsort_plain(key: torch.Tensor):
    """Plain twin of :func:`argsort`: ``torch.sort(stable=True)``."""
    skey, order = torch.sort(key, dim=-1, stable=True)
    return skey, order.to(torch.int32)


def argsort(key: torch.Tensor):
    """Stable ascending argsort of int32 keys ``[B, N]``.

    Returns ``(sorted_key [B, N] int32, perm [B, N] int32)`` with
    ``sorted_key == key.gather(-1, perm)``; equal keys keep index order.
    CUDA tensors run the kernel (N <= 2**17), CPU tensors the plain twin.
    """
    if key.device.type == "cpu":
        return argsort_plain(key)
    if not key.is_cuda:
        raise ValueError(f"argsort: unsupported device {key.device}")
    if key.dtype != torch.int32 or key.dim() != 2:
        raise ValueError(f"argsort: needs int32 [B, N], got {key.dtype} "
                         f"{tuple(key.shape)}")
    b, n = key.shape
    if n > MAX_N:
        raise ValueError(f"argsort: N = {n} exceeds {MAX_N}")
    key = key.contiguous()
    skey = torch.empty_like(key)
    perm = torch.empty_like(key)
    if b == 0 or n == 0:
        return skey, perm
    n2 = _next_pow2(n)
    scratch = (torch.empty((b, n2), dtype=torch.int64, device=key.device)
               if n2 > _CHUNK else None)
    LIB.call("mrcc_argsort_i32", ptr(key), ptr(skey), ptr(perm), ptr(scratch),
             b, n, n2, stream_ptr(key))
    SORT.launches += 1
    return skey, perm
