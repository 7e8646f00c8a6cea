"""Largest single-linkage cluster, exact (port of
``mrcc_tpu/solve/cluster.py``).

Connected components of {(i, j) : |p_i - p_j| < dist} over the first
``capacity`` masked points, by capped min-label propagation with pointer
jumping and an early exit at the fixed point.  The cap matters: a
union-find gives the same components only after convergence, so at the cap
it would be a different function.
"""

from __future__ import annotations

import torch


def largest_cluster_mask(points, mask, dist=0.06, capacity=2048,
                         iterations=16):
    """Boolean mask ``[B, P]`` of each item's largest cluster.

    Args:
      points: [B, P, 3]; mask: [B, P] (cluster over these points only).
      dist: linkage threshold; capacity: compaction capacity (the first
        ``capacity`` masked points in index order take part).
      iterations: cap on label-propagation sweeps.
    """
    b, p, _ = points.shape
    c = min(capacity, p)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[:, :c]
    pts = points.gather(1, order[..., None].expand(b, c, 3))
    ok = mask.gather(1, order)

    sq = (pts * pts).sum(dim=-1)
    g = torch.bmm(pts, pts.transpose(1, 2))
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * g
    adj = (d2 < dist * dist) & ok[:, :, None] & ok[:, None, :]

    ar = torch.arange(c, dtype=torch.int32, device=points.device)
    labels = torch.where(ok, ar, c)
    none = torch.full((), c, dtype=torch.int32, device=points.device)
    for _ in range(iterations):
        nbr_min = torch.where(adj, labels[:, None, :], none).amin(dim=-1)
        new = torch.minimum(labels, nbr_min)
        hop = new.gather(1, torch.clamp_max(new, c - 1).long())
        new = torch.minimum(new, torch.where(new < c, hop, none))
        # every item at its fixed point: later sweeps change nothing
        if torch.equal(new, labels):
            break
        labels = new

    sizes = torch.zeros((b, c + 1), dtype=torch.float32, device=points.device)
    sizes.scatter_add_(1, labels.long(), ok.to(torch.float32))
    score = torch.where(torch.arange(c + 1, device=points.device) < c, -sizes,
                        torch.full((), float("inf"), device=points.device))
    best = torch.argmin(score, dim=-1)
    in_best = (labels == best[:, None]) & ok
    out = torch.zeros((b, p), dtype=torch.bool, device=points.device)
    return out.scatter_(1, order, in_best)
