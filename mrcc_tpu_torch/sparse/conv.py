"""Functional sparse convolutions and pools over a level hierarchy (port of
``mrcc_tpu/sparse/conv.py``).

Weight layout ``[K, Cin, Cout]`` with K = 27 (k=3 s=1), 8 (k=2 s=2) or 1.
Convs compute in the feature dtype with f32 accumulation; the bias is added
outside the kernel in the feature dtype and padding rows are zeroed, as in
``_with_bias``.  A k=3 conv runs on the route its level carries: over the
level's neighbour tables (``nbr_idx``/``nbr_hit``, built where
``hierarchy.uses_k3_tables`` says the JAX engine builds them) through the
k3-table conv, else the self-keyed kernel; both run at any N.  The k3
convs of both routes, the down and the up convs are differentiable
through the autograd Functions of ``ops/conv.py`` (``SkConvFn``,
``K3MapConvFn``, ``DownConvFn``, ``UpConvFn``), whose backward passes run
the same kernels over the reverse maps and the dW kernels; the trainers
build tables where ``hierarchy.train_uses_k3_tables`` says the JAX train
step does.  Where autograd records nothing (inference under ``no_grad``)
they call the forward wrappers directly.  The strided map conv of the
sparse ResNets (:func:`conv_kernel_map`) is inference only.  ``q8=True``
routes the convs to the int8 wrappers of ``ops/conv_q8.py`` (inference
only), quantising with the calibrated ``act_absmax`` when one is given,
else the dynamic absmax, on the convs where the JAX engine runs int8
(``hierarchy.q8_route``: the k3 convs of self-keyed levels always, table
levels, down and up convs where its tiled maps exist and
``_pallas_route_tiled`` accepts the shapes); the others run in the
features' dtype, as JAX's ``conv_kernel_map`` does.  The convs that read
a map through hit lists (the down and up convs, their data cotangents and
every dW kernel) read the lists its level holds (``Level.lists``): on the
card each map is listed once, at the first conv over it.
"""

from __future__ import annotations

import torch

from ..ops.conv import (DownConvFn, K3MapConvFn, SkConvFn, UpConvFn,
                        gather_gemm_down, gather_gemm_k3_map, gather_gemm_map,
                        gather_gemm_sk, gather_gemm_up)
from ..ops.conv_q8 import (gather_gemm_down_q8, gather_gemm_k3_map_q8,
                           gather_gemm_sk_q8, gather_gemm_up_q8)
from ..ops.hit_lists import HitLists
from .hierarchy import k3_takes_q8, q8_route


def _held(level, kind, n_in, *maps):
    """The hit lists of one of ``level``'s maps (kinds as
    ``ops.hit_lists``), held by the level: made at the first request,
    listed at the first read.  None on the CPU, whose plain twins read no
    lists."""
    if not level.key.is_cuda:
        return None
    if kind not in level.lists:
        level.lists[kind] = HitLists(kind, n_in, *maps)
    return level.lists[kind]


def _child_lists(fine_level, coarse_level):
    return _held(coarse_level, "down", fine_level.key.shape[1],
                 coarse_level.child_idx, coarse_level.child_hit)


def _parent_lists(fine_level, coarse_level):
    return _held(fine_level, "up", coarse_level.key.shape[1],
                 fine_level.parent_idx, fine_level.row_ok, fine_level.octant)


def _with_bias(out, bias, valid):
    if bias is None:
        return out
    return torch.where(valid[..., None], out + bias.to(out.dtype), 0.0)


def _recorded(feats, weights):
    return torch.is_grad_enabled() and (feats.requires_grad
                                        or weights.requires_grad)


def conv_k3(feats, weights, level, bias=None, q8=False, act_absmax=None):
    """k=3 s=1 submanifold conv on one level: the k3-table conv (K3; B7
    with ``q8`` where :func:`~.hierarchy.q8_route` accepts the level) where
    the level carries tables, else the self-keyed one (K2; B6 with
    ``q8``); K2 and K3 over the level's k3 order where it has one."""
    tables = level.nbr_idx is not None
    if q8 and k3_takes_q8(level, feats.element_size()):
        out = (gather_gemm_k3_map_q8(feats, weights, level.nbr_idx,
                                     level.nbr_hit, act_absmax) if tables
               else gather_gemm_sk_q8(feats, weights, level.key, level.kbits,
                                      act_absmax))
        return _with_bias(out, bias, level.valid)
    w = weights.to(feats.dtype)
    order = level.k3_order
    n = level.key.shape[1]
    if tables:
        maps = (level.nbr_idx, level.nbr_hit)
        out = (K3MapConvFn.apply(feats, w, *maps, level.valid, order,
                                 _held(level, "k3map", n, *maps))
               if _recorded(feats, w)
               else gather_gemm_k3_map(feats, w, *maps, order))
        return _with_bias(out, bias, level.valid)
    if _recorded(feats, w):
        out = SkConvFn.apply(feats, w, level.key, level.kbits, level.valid,
                             order, _held(level, "sk", n, level.key,
                                          level.kbits))
    else:
        out = gather_gemm_sk(feats, w, level.key, level.kbits, order)
    return _with_bias(out, bias, level.valid)


def conv_down(feats, weights, fine_level, coarse_level, bias=None,
              q8=False, act_absmax=None):
    """k=2 s=2 conv: fine level -> coarse level over the 8-child map (K3;
    B7 with ``q8`` where :func:`~.hierarchy.q8_route` accepts it)."""
    maps = (coarse_level.child_idx, coarse_level.child_hit)
    lists = _child_lists(fine_level, coarse_level)
    if q8 and q8_route("down", feats.shape[1], coarse_level.valid.shape[1],
                       feats.element_size()):
        out = gather_gemm_down_q8(feats, weights, *maps, act_absmax, lists)
        return _with_bias(out, bias, coarse_level.valid)
    w = weights.to(feats.dtype)
    if _recorded(feats, w):
        out = DownConvFn.apply(feats, w, *maps, coarse_level.valid,
                               fine_level.parent_idx, fine_level.row_ok,
                               fine_level.octant, lists,
                               _parent_lists(fine_level, coarse_level))
    else:
        out = gather_gemm_down(feats, w, *maps, lists)
    return _with_bias(out, bias, coarse_level.valid)


def conv_transpose_up(feats, weights, coarse_level, fine_level, bias=None,
                      q8=False, act_absmax=None):
    """k=2 s=2 transpose conv: coarse -> cached fine level (K3 up; B7 with
    ``q8`` where :func:`~.hierarchy.q8_route` accepts it):
    ``out[c] = feats[parent(c)] @ W[octant(c)]`` for valid children
    whose parent made the coarse capacity."""
    maps = (fine_level.parent_idx, fine_level.row_ok, fine_level.octant)
    lists = _parent_lists(fine_level, coarse_level)
    if q8 and q8_route("up", fine_level.valid.shape[1], feats.shape[1],
                       feats.element_size()):
        out = gather_gemm_up_q8(feats, weights, *maps, act_absmax, lists)
        return _with_bias(out, bias, fine_level.valid)
    w = weights.to(feats.dtype)
    if _recorded(feats, w):
        out = UpConvFn.apply(feats, w, *maps, fine_level.valid,
                             coarse_level.child_idx, coarse_level.child_hit,
                             lists, _child_lists(fine_level, coarse_level))
    else:
        out = gather_gemm_up(feats, w, *maps, lists)
    return _with_bias(out, bias, fine_level.valid)


def conv_kernel_map(feats, weights, nbr_idx, nbr_hit, out_valid,
                    bias=None):
    """Generic sparse conv over an explicit kernel map into another level:
    ``out[i] = sum_k hit[k, i] * feats[idx[k, i]] @ W[k]`` (the strided map
    conv, K3's map mode), then the bias in the feature dtype and the
    invalid output rows zeroed.

    Inference only, as the reference's ``gather_gemm_conv`` route (no
    VJP): a call that autograd would record raises ``ValueError``."""
    w = weights.to(feats.dtype)
    if _recorded(feats, w):
        raise ValueError("conv_kernel_map: the strided map conv has no "
                         "backward (inference only); run under no_grad")
    out = gather_gemm_map(feats, w, nbr_idx, nbr_hit)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return torch.where(out_valid[..., None], out, 0.0)


def max_pool_down(feats, fine_level, coarse_level):
    """Max pool over the coarse level's child map (fine -> coarse): the
    masked max over the hit children, 0 where none hit (``-inf`` -> 0) and
    on invalid coarse rows.  Plain tensor code, as in JAX (no kernel)."""
    del fine_level  # the child map lives on the coarse level
    neg = torch.full((), float("-inf"), dtype=feats.dtype,
                     device=feats.device)
    acc = None
    for idx, hit in zip(coarse_level.child_idx, coarse_level.child_hit):
        g = feats.gather(1, idx.long()[..., None].expand(
            -1, -1, feats.shape[-1]))
        g = torch.where(hit[..., None], g, neg)
        acc = g if acc is None else torch.maximum(acc, g)
    acc = torch.where(torch.isfinite(acc), acc, 0.0)
    return torch.where(coarse_level.valid[..., None], acc, 0.0)


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
