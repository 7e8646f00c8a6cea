"""Functional sparse convolutions and pools over a level hierarchy (port of
``mrcc_tpu/sparse/conv.py``).

Weight layout ``[K, Cin, Cout]`` with K = 27 (k=3 s=1), 8 (k=2 s=2) or 1.
Convs compute in the feature dtype with f32 accumulation; the bias is added
outside the kernel in the feature dtype and padding rows are zeroed, as in
``_with_bias``.  A k=3 conv runs on the route its level carries: over the
level's neighbour tables (``nbr_idx``/``nbr_hit``, built where
``hierarchy.uses_k3_tables`` says the JAX engine builds them) through the
k3-table conv, else the self-keyed kernel; both run at any N.  The table
route is inference only.  The self-keyed k3, down and up convs are
differentiable through the autograd Functions of ``ops/conv.py``, whose
backward passes run the same kernels over the reverse maps and the dW
kernels; where autograd records nothing (inference under ``no_grad``) they
call the forward wrappers directly.  ``q8=True`` routes the convs to the
int8 wrappers of ``ops/conv_q8.py`` (inference only), quantising with the
calibrated ``act_absmax`` when one is given, else the dynamic absmax.
"""

from __future__ import annotations

import torch

from ..ops.conv import (DownConvFn, SkConvFn, UpConvFn, gather_gemm_down,
                        gather_gemm_k3_map, gather_gemm_sk, gather_gemm_up)
from ..ops.conv_q8 import (gather_gemm_down_q8, gather_gemm_k3_map_q8,
                           gather_gemm_sk_q8, gather_gemm_up_q8)


def _with_bias(out, bias, valid):
    if bias is None:
        return out
    return torch.where(valid[..., None], out + bias.to(out.dtype), 0.0)


def _recorded(feats, weights):
    return torch.is_grad_enabled() and (feats.requires_grad
                                        or weights.requires_grad)


def conv_k3(feats, weights, level, bias=None, q8=False, act_absmax=None):
    """k=3 s=1 submanifold conv on one level: the k3-table conv (K3, B7)
    where the level carries tables, else the self-keyed one (K2; B6 with
    ``q8``)."""
    tables = level.nbr_idx is not None
    if q8:
        out = (gather_gemm_k3_map_q8(feats, weights, level.nbr_idx,
                                     level.nbr_hit, act_absmax) if tables
               else gather_gemm_sk_q8(feats, weights, level.key, level.kbits,
                                      act_absmax))
        return _with_bias(out, bias, level.valid)
    w = weights.to(feats.dtype)
    if tables:
        if _recorded(feats, w):
            raise NotImplementedError("k3-table convs are inference only: "
                                      "build training levels self-keyed")
        out = gather_gemm_k3_map(feats, w, level.nbr_idx, level.nbr_hit)
        return _with_bias(out, bias, level.valid)
    if _recorded(feats, w):
        out = SkConvFn.apply(feats, w, level.key, level.kbits, level.valid)
    else:
        out = gather_gemm_sk(feats, w, level.key, level.kbits)
    return _with_bias(out, bias, level.valid)


def conv_down(feats, weights, fine_level, coarse_level, bias=None,
              q8=False, act_absmax=None):
    """k=2 s=2 conv: fine level -> coarse level over the 8-child map (K3;
    B7 with ``q8``)."""
    maps = (coarse_level.child_idx, coarse_level.child_hit)
    if q8:
        out = gather_gemm_down_q8(feats, weights, *maps, act_absmax)
        return _with_bias(out, bias, coarse_level.valid)
    w = weights.to(feats.dtype)
    if _recorded(feats, w):
        out = DownConvFn.apply(feats, w, *maps, coarse_level.valid,
                               fine_level.parent_idx, fine_level.row_ok,
                               fine_level.octant)
    else:
        out = gather_gemm_down(feats, w, *maps)
    return _with_bias(out, bias, coarse_level.valid)


def conv_transpose_up(feats, weights, coarse_level, fine_level, bias=None,
                      q8=False, act_absmax=None):
    """k=2 s=2 transpose conv: coarse -> cached fine level (K3 up; B7 with
    ``q8``): ``out[c] = feats[parent(c)] @ W[octant(c)]`` for valid children
    whose parent made the coarse capacity."""
    maps = (fine_level.parent_idx, fine_level.row_ok, fine_level.octant)
    if q8:
        out = gather_gemm_up_q8(feats, weights, *maps, act_absmax)
        return _with_bias(out, bias, fine_level.valid)
    w = weights.to(feats.dtype)
    if _recorded(feats, w):
        out = UpConvFn.apply(feats, w, *maps, fine_level.valid,
                             coarse_level.child_idx, coarse_level.child_hit)
    else:
        out = gather_gemm_up(feats, w, *maps)
    return _with_bias(out, bias, fine_level.valid)


def conv1x1(feats, weights, valid, bias=None):
    """Pointwise conv: one matmul (f32 accumulation), cast to feats dtype."""
    w = (weights[0] if weights.dim() == 3 else weights).to(feats.dtype)
    out = torch.matmul(feats, w)
    if bias is not None:
        out = out + bias.to(feats.dtype)
    return torch.where(valid[..., None], out, 0.0)


def global_max_pool(feats, valid):
    """Per-item masked max over voxels: [B, N, C] -> [B, C] (0 if empty)."""
    m = torch.where(valid[..., None], feats,
                    torch.full((), float("-inf"), dtype=feats.dtype,
                               device=feats.device)).amax(dim=1)
    return torch.where(torch.isfinite(m), m, 0.0)


def global_avg_pool(feats, valid):
    """Per-item masked mean over voxels: [B, N, C] -> [B, C].

    Sums accumulate in f32 and round to the feature dtype, as ``jnp.sum``
    does for bf16."""
    v = valid[..., None].to(feats.dtype)
    s = (feats * v).float().sum(dim=1).to(feats.dtype)
    n = torch.clamp_min(v.float().sum(dim=1), 1.0).to(feats.dtype)
    return s / n


def cat(feats_a, feats_b, valid):
    """Channel concat of two feature sets on the same coords."""
    return torch.where(valid[..., None], torch.cat([feats_a, feats_b], -1), 0.0)
