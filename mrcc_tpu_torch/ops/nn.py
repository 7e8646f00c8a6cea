"""B10 — nearest valid target search (``csrc/nn_search.cu``).

Replaces ``mrcc_tpu/ops/nn_pallas.py::nn_search_pallas``, the fused
distance + argmin of ``icp_refine(use_pallas=True)``, batched over items.
Its formula, which is not the plain ICP's: invalid targets are zeroed and
get ``|b|^2 = 1e30``; ``d2 = (|a|^2 - 2 a.b) + |b|^2``; the index is the
smallest one among the minima.  The M x N distance matrix never reaches
device memory on the card.  The kernel and its twin round each product
and sum in one stated order, so they give the same bits.
"""

from __future__ import annotations

import torch

from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, stream_ptr

LIB = KernelLibrary("nn_search", {
    "mrcc_nn_search": (P, P, P, P, P, P, P, I, I, I, I, I, P),
})
NN = LaunchCounter("nn_search")
NN_THREADS = 128  # csrc/nn_search.cu THREADS
NN_POINTS = 4     # template points a thread (csrc/nn_search.cu POINTS)
NN_BLOCKS = 528   # blocks in flight at least: four an SM of an H100
NN_MIN_SPLIT = 32  # targets a split at least


def nn_splits(b, m, n):
    """The kernel's target splits ``(S, L)``: S splits of L targets (the
    last may be shorter), enough that the grid of (template tiles, splits,
    items) holds ``NN_BLOCKS`` blocks where N allows."""
    tiles = -(-m // (NN_THREADS * NN_POINTS))
    want = -(-NN_BLOCKS // (tiles * b))
    length = -(-n // max(1, min(want, n // NN_MIN_SPLIT)))
    return -(-n // length), length


def nn_search_plain(template, target, mask):
    """Plain twin of :func:`nn_search`: the kernel's expression element by
    element over the [B, M, N] distance matrix (broadcast products, no
    ``bmm``), so each value is rounded as the kernel rounds it."""
    tgt = torch.where(mask[..., None], target, 0.0)
    bx, by, bz = (c[:, None, :] for c in tgt.unbind(-1))      # [B, 1, N]
    ax, ay, az = (c[..., None] for c in template.unbind(-1))  # [B, M, 1]
    sqs = (ax * ax + ay * ay) + az * az
    sqt = torch.where(mask[:, None, :], (bx * bx + by * by) + bz * bz,
                      torch.full((), 1e30, dtype=torch.float32,
                                 device=target.device))
    st = (ax * bx + ay * by) + az * bz                        # [B, M, N]
    d2 = (sqs - 2.0 * st) + sqt
    dmin, idx = d2.min(dim=-1)
    return idx.to(torch.int32), dmin


def nn_search(template, target, mask):
    """For each template point, the nearest valid target point.

    Args:
      template: [B, M, 3] f32 query points; target: [B, N, 3] f32;
      mask: [B, N] bool target validity (M, N >= 1).
    Returns ``(idx [B, M] int32, d2 [B, M] f32)``.
    """
    if template.dim() != 3 or target.dim() != 3 or template.shape[-1] != 3 \
            or target.shape[-1] != 3 or mask.shape != target.shape[:2] \
            or template.shape[0] != target.shape[0] \
            or min(template.shape[1], target.shape[1]) < 1:
        raise ValueError(f"nn_search: template {tuple(template.shape)}, "
                         f"target {tuple(target.shape)}, mask "
                         f"{tuple(mask.shape)} do not fit [B, M>=1, 3] / "
                         "[B, N>=1, 3] / [B, N]")
    if template.dtype != torch.float32 or target.dtype != torch.float32 \
            or mask.dtype != torch.bool:
        raise ValueError("nn_search: needs f32 points and a bool mask")
    devices = {t.device for t in (template, target, mask)}
    if len(devices) != 1:
        raise ValueError(f"nn_search: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return nn_search_plain(template, target, mask)
    if dev.type != "cuda":
        raise ValueError(f"nn_search: unsupported device {dev}")
    b, m, _ = template.shape
    n = target.shape[1]
    splits, length = nn_splits(b, m, n)
    idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    # the splits' j and d2 ([2, S, B, M], d2's bits in the second half)
    # where there are several, merged by a second kernel
    part = None if splits == 1 else torch.empty(
        (2, splits, b, m), dtype=torch.int32, device=dev)
    part_idx, part_d2 = (ptr(idx), ptr(d2)) if part is None else (
        ptr(part), ptr(part) + 4 * splits * b * m)
    template, target, mask = (template.contiguous(), target.contiguous(),
                              mask.contiguous())
    LIB.call("mrcc_nn_search", ptr(template), ptr(target), ptr(mask),
             ptr(idx), ptr(d2), part_idx, part_d2, b, m, n, splits, length,
             stream_ptr(template))
    NN.launches += 1
    return idx, d2
