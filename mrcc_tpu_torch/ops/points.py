"""Dense point-cloud ops: FPS, ball query, grouping, 3-NN interpolation
(port of ``mrcc_tpu/ops/points.py``, which has no Pallas kernel: plain
PyTorch on every device, the JAX functions' formulas op for op).

- Distances are ``|a|^2 + |b|^2 - 2 a.b``; ball-query membership
  (``d2 > r^2``) reads those bits.  On the card the product is one
  ``einsum`` at full f32 precision whatever
  ``torch.backends.cuda.matmul.allow_tf32`` says (:func:`full_f32`).  On
  the CPU an f32 product is element-wise, the fused multiply-add chain of
  XLA's CPU dot (:func:`dot3`): a pair's distance then has the same bits
  whatever else is in the call (torch's CPU ``bmm`` takes another path for
  small shapes, which rounds otherwise); float64 (the train-mode parity
  tests) stays one ``einsum``.
- A sum over xyz is ``(x + y) + z`` written out (:func:`sum3`): the order
  of XLA's reduce and of torch's CPU ``sum(-1)``, and on the card too.
- FPS is the JAX ``fori_loop``: ``npoint`` serial steps over all clouds at
  once, the first maximum winning each step (``jnp.argmax``).
- The ball query takes the first ``nsample`` in-radius indices in index
  order, fills missing slots with the first hit and clamps an empty ball
  to ``N - 1`` (the JAX code's clamp; its comment says 0).
- The 3-NN picks the three smallest distances lowest index first among
  equal ones, as ``jax.lax.top_k`` orders ties.

Clouds are ``[B, N, C]`` channel-last with exactly N points.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run the matmuls inside at full f32 precision on the card (TF32 off),
    restoring the caller's setting after."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = prev


def sum3(v):
    """``(v[..., 0] + v[..., 1]) + v[..., 2]``: a sum over xyz in one
    order on every device."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def dot3(src, dst):
    """``src [B, N, 3] . dst [B, M, 3]`` -> ``[B, N, M]`` f32 as
    ``fma(x2, y2, fma(x1, y1, x0 * y0))``, element by element.  Each
    product of two f32 is exact in float64, so each step is the fused
    step but for a double rounding (float64, then f32), which differs only
    where the float64 sum lands on a midpoint of two f32."""
    a = src.double()[:, :, None, :]
    b = dst.double()[:, None, :, :]
    acc = (a[..., 0] * b[..., 0]).float()
    for c in (1, 2):
        acc = (a[..., c] * b[..., c] + acc).float()
    return acc


def square_distance(src, dst):
    """Pairwise squared distances ``[B, N, M]`` (``pointnet2_utils.py:21``)."""
    s2 = sum3(src ** 2)[..., None]                        # [B, N, 1]
    d2 = sum3(dst ** 2)[..., None, :]                     # [B, 1, M]
    if src.is_cuda or src.dtype != torch.float32:
        with full_f32():
            dot = torch.einsum("bnc,bmc->bnm", src, dst)
    else:
        dot = dot3(src, dst)
    return s2 + d2 - 2.0 * dot


def index_points(points, idx):
    """Rows of ``points [B, N, C]`` at ``idx [B, ...]`` -> ``[B, ..., C]``
    (``pointnet2_utils.py:45``)."""
    b, c = idx.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
    return points.gather(1, flat).reshape(idx.shape + (c,))


def farthest_point_sample(xyz, npoint, start_idx=0):
    """FPS indices ``[B, npoint]`` int32 (``pointnet2_utils.py:65``) from
    ``start_idx`` (a scalar or one per cloud).  With fewer than ``npoint``
    points the picks run on at index 0 once every distance is 0."""
    b, n, _ = xyz.shape
    farthest = torch.as_tensor(start_idx, dtype=torch.long,
                               device=xyz.device).expand(b).clone()
    dist = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    picks = []
    for _ in range(npoint):
        picks.append(farthest)
        centroid = xyz[rows, farthest][:, None, :]          # [B, 1, 3]
        d = sum3((xyz - centroid) ** 2)
        torch.minimum(dist, d, out=dist)
        farthest = torch.argmax(dist, dim=-1)
    return torch.stack(picks, dim=1).to(torch.int32)


def query_ball_point(radius, nsample, xyz, new_xyz):
    """Ball query ``[B, S, nsample]`` int32 (``pointnet2_utils.py:89``): the
    first ``nsample`` indices (in index order) whose squared distance to
    the query is at most ``radius**2``, missing slots filled with the
    group's first hit."""
    n = xyz.shape[1]
    d2 = square_distance(new_xyz, xyz)                    # [B, S, N]
    r2 = torch.tensor(radius ** 2, dtype=d2.dtype, device=d2.device)
    arange = torch.arange(n, dtype=torch.int32, device=xyz.device)
    cand = torch.where(d2 > r2, n, arange)
    # the smallest ``nsample`` in order (all N where N is smaller, as the
    # JAX slice of the sorted row)
    cand = torch.topk(cand, min(nsample, n), dim=-1, largest=False,
                      sorted=True).values
    first = cand[..., :1]
    group = torch.where(cand == n, first, cand)
    return torch.clamp_max(group, n - 1)


def sample_and_group(npoint, radius, nsample, xyz, points):
    """FPS + ball query + local-frame concat (``pointnet2_utils.py:112``):
    ``(new_xyz [B, S, 3], grouped [B, S, K, 3 + C])``."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        return new_xyz, grouped_xyz
    return new_xyz, torch.cat([grouped_xyz, index_points(points, idx)],
                              dim=-1)


def sample_and_group_all(xyz, points):
    """One global group (``pointnet2_utils.py:140``): the origin and every
    point, xyz not recentred."""
    b = xyz.shape[0]
    new_xyz = torch.zeros((b, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped


def three_nn(d2):
    """Indices ``[B, N, 3]`` of the three smallest entries of each row of
    ``d2 [B, N, M]``, ascending, the lower index first among equal values
    (``jax.lax.top_k`` of ``-d2``), with their values."""
    work = d2.clone()
    idx, vals = [], []
    for k in range(3):
        i = torch.argmin(work, dim=-1, keepdim=True)      # first minimum
        idx.append(i)
        vals.append(d2.gather(-1, i))
        if k < 2:
            work.scatter_(-1, i, float("inf"))
    return torch.cat(idx, -1), torch.cat(vals, -1)


def three_nn_interpolate(xyz_fine, xyz_coarse, feats_coarse):
    """Inverse-distance weighted 3-NN interpolation
    (``pointnet2_utils.py:292-306``): ``[B, N, C]`` from ``[B, M, C]``."""
    idx, d = three_nn(square_distance(xyz_fine, xyz_coarse))
    recip = 1.0 / (torch.clamp_min(d, 0.0) + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)
    gathered = index_points(feats_coarse, idx)            # [B, N, 3, C]
    return (gathered * weight[..., None]).sum(2)
