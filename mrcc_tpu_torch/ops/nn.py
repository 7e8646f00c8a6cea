"""B10 — nearest valid target search (``csrc/nn_search.cu``).

Replaces ``mrcc_tpu/ops/nn_pallas.py::nn_search_pallas``, the fused
distance + argmin of ``icp_refine(use_pallas=True)``, batched over items.
Its formula, which is not the plain ICP's: invalid targets are zeroed and
get ``|b|^2 = 1e30``; ``d2 = |a|^2 - 2 a.b + |b|^2``; the index is the
smallest one among the minima.  The M x N distance matrix never reaches
device memory on the card.
"""

from __future__ import annotations

import torch

from .build import I, KernelLibrary, LaunchCounter, P, ptr, stream_ptr

LIB = KernelLibrary("nn_search", {
    "mrcc_nn_search": (P, P, P, P, P, I, I, I, P),
})
NN = LaunchCounter("nn_search")


def nn_search_plain(template, target, mask):
    """Plain twin of :func:`nn_search` (the distance matrix in memory)."""
    tgt = torch.where(mask[..., None], target, 0.0)
    sqt = torch.where(mask, (target * target).sum(dim=-1),
                      torch.full((), 1e30, dtype=torch.float32,
                                 device=target.device))
    st = torch.bmm(template, tgt.transpose(1, 2))              # [B, M, N]
    sqs = (template * template).sum(dim=-1, keepdim=True)
    d2 = sqs - 2.0 * st + sqt[:, None, :]
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
    idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    template, target, mask = (template.contiguous(), target.contiguous(),
                              mask.contiguous())
    LIB.call("mrcc_nn_search", ptr(template), ptr(target), ptr(mask),
             ptr(idx), ptr(d2), b, m, n, stream_ptr(template))
    NN.launches += 1
    return idx, d2
