"""B6 and B7 — int8 gather-GEMM sparse convolutions and their plain twins.

``csrc/conv_sk_q8.cu`` (:func:`gather_gemm_sk_q8`) replaces
``conv_pallas._gather_gemm_call_sk_q8``: the self-keyed k=3 s=1 conv of K2
in int8.  ``csrc/conv_map_q8.cu`` (:func:`gather_gemm_down_q8`,
:func:`gather_gemm_up_q8`, :func:`gather_gemm_k3_map_q8`) replaces
``conv_pallas._gather_gemm_call_q8`` in its k2-down, broadcast-k up and
k3-table modes, over K3's maps and the rank kernel's neighbour tables; it
reads global memory at any N, so it also stands in for the streamed int8
variant of ``_gather_gemm_call_hbm``.

The function is the JAX wrappers' (``gather_gemm_conv_sk_q8``,
``gather_gemm_conv_tiled_q8``, ``gather_gemm_conv_streamed(q8=True)``), the
quantisation included, since it is part of the result.  On features ``x``
[B, N, Cin] (bf16 or f32) and f32 weights ``W`` [K, Cin, Cout]:

1. ``s_c = max(absmax_c, 1e-8) / 127`` per input channel, ``absmax`` the
   calibrated one when given, else ``|x|.max`` over every row, padding
   included; ``q = clip(round(x / s_c), -127, 127)`` as int8, rounding half
   to even (``torch.round`` as ``jnp.round``);
2. ``W' = W * s_c[cin]``;
3. ``W'`` splits into the channel groups of :func:`q8_channel_groups`;
4. each group is quantised with its own f32 column scale
   ``m = max(|W'_g|, 1e-12) / 127`` (k3 and down: one per output column;
   up: one per octant and output column): ``clip(round(W'_g / m))``;
5. per group: gather the int8 rows, multiply int8 x int8 into int32, then
   ``int32 -> f32 * m[col] -> feature dtype``; the groups are summed in the
   feature dtype in group order.

Bias and the validity mask stay outside (``sparse/conv.py``).  For CUDA
tensors every step runs the port's kernels: the quantisation pass
(:func:`quantize_operands`: ``csrc/q8_quantize.cuh``, a memset and two
launches with a calibrated absmax, three with the dynamic one) writes the operands in the
layout the int8 tensor-core tiles read (``csrc/q8_mma.cuh``): q [B, N,
cpad] and wq [K, Cout, cpad] int8, the channels of a row contiguous and
padded with zeros to ``cpad`` (Cin rounded up to 16).  The k3 convs run one
tile launch (a resolve launch before it where Cout > 128); down and up run
K3's decomposition in int8: the int8 list GEMM over the map's per-octant
hit lists (``ops/hit_lists.py``; the last argument, or listed here), then
the down conv's int32 child sum or the up conv's zero pass.  For CPU
tensors the plain twins run (a float64 emulation of the int32 sums, exact
below 2^53); :func:`quantize_operands_plain` is the quantisation's twin,
:func:`list_gemm_q8_plain` and :func:`child_sum_q8_plain` the stages'.

The two ``/ 127`` are what the JAX engine computes: it runs the wrappers
under ``jit``, where XLA folds a division by a constant into a product with
its f32 reciprocal, so ``/ 127`` is ``* f32(1 / 127)`` (one ulp from the
division in about 4 % of cases, enough to move a rounding of ``x / s_c``).
The other two divisions are true ones, by device tensors: CUDA computes
``x / python_scalar`` as ``x * (1 / scalar)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..sparse.hierarchy import TABLE_BUDGET as _TABLE_BUDGET
from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, stream_ptr
from .conv import _gather, _k3_lists, _lists, _route
from .hit_lists import K3_DELTAS as _K3_DELTAS
from .hit_lists import _sk_neighbours

_QUANTIZE = (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P)
_TILE = (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P)
SK_Q8_LIB = KernelLibrary("conv_sk_q8", {
    "mrcc_conv_sk_q8_f32": _TILE,
    "mrcc_conv_sk_q8_bf16": _TILE,
})
MAP_Q8_LIB = KernelLibrary("conv_map_q8", {
    "mrcc_quantize_q8_f32": _QUANTIZE,
    "mrcc_quantize_q8_bf16": _QUANTIZE,
    "mrcc_list_gemm_q8_f32": (P, P, P, P, P, P, P) + (I,) * 9 + (P,),
    "mrcc_list_gemm_q8_bf16": (P, P, P, P, P, P, P) + (I,) * 9 + (P,),
    "mrcc_child_sum_q8_f32": (P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_child_sum_q8_bf16": (P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_zero_rows_q8_f32": (P, P, P, I, I, P),
    "mrcc_zero_rows_q8_bf16": (P, P, P, I, I, P),
    "mrcc_conv_k3map_q8_f32": _TILE,
    "mrcc_conv_k3map_q8_bf16": _TILE,
})
LIBRARIES = (SK_Q8_LIB, MAP_Q8_LIB)
# the conv kernels, one launch a wrapper call each
SK_Q8 = LaunchCounter("conv_sk_q8")
DOWN_Q8 = LaunchCounter("conv_down_q8")
UP_Q8 = LaunchCounter("conv_up_q8")
K3MAP_Q8 = LaunchCounter("conv_k3map_q8")
# ... and their other stages: the quantisation pass's kernels (2, or 3 with
# the dynamic absmax), the down child sum (down / up read their map's lists,
# ``ops/hit_lists.py``)
Q8_QUANT = LaunchCounter("q8_quantize")
Q8_SUM = LaunchCounter("q8_child_sum")

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The JAX wrappers' int8 k-lane cap (2 * 3456).
_KG_LANES_Q8 = 2 * 3456
# Largest level an int8 table of 128 lanes fits: 40960 rows.
Q8_MAX_ROWS = _TABLE_BUDGET // 128


def _lanes(c: int) -> int:
    return max(128, -(-c // 128) * 128)


def _split_width(n: int, cin: int, k: int) -> int:
    """Group width of ``_split_plan(n, cin, k, kp, itemsize=1)`` in its
    interpret branch, unpacked: the k-lane cap ``6912 // k`` rounded down
    to 128 (at least 128) where ``k * cin > 6912``, then the table budget:
    ``(5 MiB // n)`` rounded down to 128 (at least 128) where
    ``n * round_up(width, 128) > 5 MiB``."""
    width = cin
    if k * width > _KG_LANES_Q8:
        width = min(width, max(128, (_KG_LANES_Q8 // k) // 128 * 128))
    if n * _lanes(width) > _TABLE_BUDGET:
        width = min(width, max(128, (_TABLE_BUDGET // n) // 128 * 128))
    return width


def q8_channel_groups(mode: str, n: int, cin: int):
    """Channel groups ``((start, end), ...)`` of one int8 conv.

    They define the quantisation groups (each group has its own weight
    scales and its own rounding to the feature dtype), not a tiling: the
    JAX wrappers' plan on the CPU, where no lane padding or packing applies.
    ``n`` is the rows of the conv's INPUT table.

    - ``"k3"`` (``_sk_plan``, pack 1): groups of ``min(round_up(cin, 128),
      128)`` channels; levels over 40960 rows need lane packing and raise
      (the route sends them to ``"k3_table"``).
    - ``"down"`` / ``"up"`` (:func:`_split_width` with k = 8: above 864
      channels the k-lane cap splits them 768 + ...).  A down conv whose
      128-lane table is over the budget runs the streamed wrapper:
      128-channel groups.  An up conv there runs ``_split_plan``'s
      lane-packed plan: the smallest pack p of (2, 4) whose packed table
      fits (``n % (32 p) == 0``, ``(n / p) * 128 <= 5 MiB``) and groups of
      ``128 / p`` channels; no such p raises.
    - ``"k3_table"`` (``gather_gemm_conv_tiled_q8`` over a 27-offset
      table): over the budget (n > 40960) the streamed wrapper's
      128-channel groups, else :func:`_split_width` with k = 27, whose
      k-lane cap is 256 channels (384 split 256 + 128).
    """
    over = n * 128 > _TABLE_BUDGET
    if mode == "k3":
        if over:
            raise ValueError(f"int8 k3 conv over {n} rows: levels over "
                             f"{Q8_MAX_ROWS} rows need lane packing")
        width = min(_lanes(cin), 128)
    elif over and mode == "up":
        packs = [p for p in (2, 4) if n % (32 * p) == 0 and n // p >= 128
                 and (n // p) * 128 <= _TABLE_BUDGET]
        if not packs:
            raise ValueError(f"int8 up conv over a {n}-row table: no lane "
                             "pack fits the table budget")
        width = 128 // packs[0]
    elif mode in ("down", "up", "k3_table"):
        width = (min(_lanes(cin), 128) if over
                 else _split_width(n, cin, 27 if mode == "k3_table" else 8))
    else:
        raise ValueError(f"q8_channel_groups: mode {mode!r}")
    return tuple((a, min(a + width, cin)) for a in range(0, cin, width))


def _over_127(x):
    """``x * f32(1 / 127)``: the jitted JAX wrappers' ``x / 127``."""
    return x * torch.full((), 1.0 / 127.0, dtype=torch.float32,
                          device=x.device)


def quantize_activations(feats, act_absmax=None):
    """``(q int8 [B, N, C], s_c f32 [C])``: per-channel scales from the
    calibrated ``act_absmax`` or the dynamic absmax over all rows."""
    f = feats.float()
    amax = (f.abs().amax(dim=(0, 1)) if act_absmax is None
            else act_absmax.float())
    s_c = _over_127(torch.clamp_min(amax, 1e-8))
    q = torch.clamp(torch.round(f / s_c), -127, 127).to(torch.int8)
    return q, s_c


def quantize_weights(weights, s_c, groups, per_octant=False):
    """``(wq int8 [K, Cin, Cout], m f32)``: ``W * s_c`` quantised per
    channel group with f32 column scales ``m`` of shape [G, Cout], or
    [G, K, Cout] with ``per_octant`` (the up conv: octants keep their own
    scales)."""
    w = weights.float() * s_c[None, :, None]
    wq = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scales = []
    for a, b in groups:
        wg = w[:, a:b]
        m = wg.abs().amax(dim=1 if per_octant else (0, 1), keepdim=True)
        m = _over_127(torch.clamp_min(m, 1e-12))
        wq[:, a:b] = torch.clamp(torch.round(wg / m), -127, 127).to(
            torch.int8)
        scales.append(m[:, 0] if per_octant else m[0, 0])
    return wq, torch.stack(scales)


def _cpad(cin: int) -> int:
    """Bytes of one operand row: Cin rounded up to whole 16-byte chunks."""
    return -(-cin // 16) * 16


def _over_127(x):
    """``x * f32(1 / 127)``: the jitted JAX wrappers' ``x / 127``."""
    return x * torch.full((), 1.0 / 127.0, dtype=torch.float32,
                          device=x.device)


def quantize_activations(feats, act_absmax=None):
    """``(q int8 [B, N, C], s_c f32 [C])``: per-channel scales from the
    calibrated ``act_absmax`` or the dynamic absmax over all rows."""
    f = feats.float()
    amax = (f.abs().amax(dim=(0, 1)) if act_absmax is None
            else act_absmax.float())
    s_c = _over_127(torch.clamp_min(amax, 1e-8))
    q = torch.clamp(torch.round(f / s_c), -127, 127).to(torch.int8)
    return q, s_c


def quantize_weights(weights, s_c, groups, per_octant=False):
    """``(wq int8 [K, Cin, Cout], m f32)``: ``W * s_c`` quantised per
    channel group with f32 column scales ``m`` of shape [G, Cout], or
    [G, K, Cout] with ``per_octant`` (the up conv: octants keep their own
    scales)."""
    w = weights.float() * s_c[None, :, None]
    wq = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scales = []
    for a, b in groups:
        wg = w[:, a:b]
        m = wg.abs().amax(dim=1 if per_octant else (0, 1), keepdim=True)
        m = _over_127(torch.clamp_min(m, 1e-12))
        wq[:, a:b] = torch.clamp(torch.round(wg / m), -127, 127).to(
            torch.int8)
        scales.append(m[:, 0] if per_octant else m[0, 0])
    return wq, torch.stack(scales)


def _quantize(mode, feats, weights, n_table, act_absmax, per_octant=False,
              groups=None):
    if groups is None:
        groups = q8_channel_groups(mode, n_table, feats.shape[-1])
    q, s_c = quantize_activations(feats, act_absmax)
    wq, m = quantize_weights(weights, s_c, groups, per_octant)
    return groups, q, wq, m


class Q8Operands(NamedTuple):
    """The int8 operands in the kernels' layout: ``q`` [B, N, cpad] and
    ``wq`` [K, Cout, cpad] int8 (zeros past Cin), ``m`` f32 [G, Cout] (or
    [G, K, Cout] per octant), the channel ``groups``; ``gw`` the width the
    kernels step groups by (the first group's, or cpad for one group)."""

    q: torch.Tensor
    wq: torch.Tensor
    m: torch.Tensor
    groups: Tuple[Tuple[int, int], ...]
    cpad: int
    gw: int


def _operands(q, wq, m, groups):
    cpad = _cpad(q.shape[-1])
    gw = cpad if len(groups) == 1 else groups[0][1] - groups[0][0]
    if gw % 16:
        raise ValueError(f"int8 channel groups {groups}: widths must be "
                         "whole 16-channel chunks")
    return Q8Operands(q, wq, m, tuple(groups), cpad, gw)


def quantize_operands_plain(mode, feats, weights, n_table, act_absmax=None,
                            per_octant=False, groups=None):
    """Plain twin of :func:`quantize_operands`: ``_quantize`` and the
    kernels' layout."""
    groups, q, wq, m = _quantize(mode, feats, weights, n_table, act_absmax,
                                 per_octant, groups)
    pad = _cpad(q.shape[-1]) - q.shape[-1]
    return _operands(F.pad(q, (0, pad)).contiguous(),
                     F.pad(wq.transpose(1, 2), (0, pad)).contiguous(),
                     m.contiguous(), groups)


def quantize_operands(mode, feats, weights, n_table, act_absmax=None,
                      per_octant=False, groups=None):
    """The int8 convs' quantisation pass (steps 1-4 of the module doc) into
    the kernels' layout: :class:`Q8Operands`.

    Args:
      mode, n_table: the conv's :func:`q8_channel_groups` (``groups``, if
        given, instead); feats: [B, N, Cin] f32/bf16; weights: [K, Cin,
        Cout] f32; act_absmax: optional calibrated [Cin] f32 (else the
        dynamic absmax); per_octant: the up conv's scales [G, K, Cout].
    """
    if not _route(feats, weights, *(() if act_absmax is None
                                    else (act_absmax,))):
        return quantize_operands_plain(mode, feats, weights, n_table,
                                       act_absmax, per_octant, groups)
    if feats.dtype not in _SUFFIX or weights.dtype != torch.float32:
        raise ValueError(f"quantize_operands: feats {feats.dtype} / weights "
                         f"{weights.dtype}")
    b, n, cin = feats.shape
    k, _, cout = weights.shape
    if groups is None:
        groups = q8_channel_groups(mode, n_table, cin)
    dev = feats.device
    cpad = _cpad(cin)
    ops = _operands(torch.empty((b, n, cpad), dtype=torch.int8, device=dev),
                    torch.empty((k, cout, cpad), dtype=torch.int8,
                                device=dev),
                    torch.empty((len(groups),) + ((k,) if per_octant else ())
                                + (cout,), dtype=torch.float32, device=dev),
                    groups)
    # the dynamic absmax [cin], then the weights' column maxima
    scratch = torch.empty(cin + ops.m.numel(), dtype=torch.float32,
                          device=dev)
    cal = None if act_absmax is None else act_absmax.float().contiguous()
    MAP_Q8_LIB.call(
        f"mrcc_quantize_q8_{_SUFFIX[feats.dtype]}", ptr(feats.contiguous()),
        ptr(cal), ptr(weights.contiguous()), ptr(scratch), ptr(ops.q),
        ptr(ops.wq), ptr(ops.m), b * n, cin, cpad, k, cout, ops.gw,
        len(groups), int(per_octant), stream_ptr(feats))
    Q8_QUANT.launches += 2 if act_absmax is not None else 3
    return ops


def _dequant_sum(parts, dtype):
    """Group results (f64 integer sums, their f32 scales) -> ``int32 -> f32
    * m -> dtype``, summed in ``dtype`` in group order."""
    out = None
    for acc, m in parts:
        part = (acc.float() * m).to(dtype)
        out = part if out is None else out + part
    return out


def _check(name, feats, weights, k, index_tensors):
    if feats.dtype not in _SUFFIX:
        raise ValueError(f"{name}: feats dtype {feats.dtype} not in "
                         "(float32, bfloat16)")
    if weights.dtype != torch.float32:
        raise ValueError(f"{name}: weights {weights.dtype}, need float32")
    if feats.dim() != 3 or weights.dim() != 3 or weights.shape[0] != k \
            or weights.shape[1] != feats.shape[-1]:
        raise ValueError(f"{name}: feats {tuple(feats.shape)} / weights "
                         f"{tuple(weights.shape)} do not fit [B, N, Cin] / "
                         f"[{k}, Cin, Cout]")
    for t, dtype in index_tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: map dtype {t.dtype} != {dtype}")


def _tile_launch(lib, fname, feats, weights, maps, mode, act_absmax,
                 groups=None):
    """A k3 conv (B6, or B7's table mode) on checked CUDA operands: the
    quantisation pass, then the int8 tile (``maps`` contiguous)."""
    b, n, cin = feats.shape
    cout = weights.shape[-1]
    ops = quantize_operands(mode, feats, weights, n, act_absmax,
                            groups=groups)
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    lists = _k3_lists(b, n, cout, feats.device)
    lib.call(f"{fname}_{_SUFFIX[feats.dtype]}", ptr(ops.q), ptr(ops.wq),
             ptr(ops.m), *map(ptr, maps), ptr(lists), ptr(out), b, n, cin,
             ops.cpad, cout, ops.gw, len(ops.groups), stream_ptr(feats))
    return out


# ------------------------------------------------------------------- B6

def gather_gemm_sk_q8_plain(feats, weights, key, kbits, act_absmax=None):
    """Plain twin of :func:`gather_gemm_sk_q8`."""
    b, n, _ = feats.shape
    groups, q, wq, m = _quantize("k3", feats, weights, n, act_absmax)
    qd, wd = q.double(), wq.double()
    key = key.contiguous()
    nbrs = [_sk_neighbours(key, kbits, k, d) for k, d in enumerate(_K3_DELTAS)]
    parts = []
    for gi, (a, c) in enumerate(groups):
        acc = torch.zeros((b, n, wq.shape[-1]), dtype=torch.float64,
                          device=feats.device)
        for k, (idx, hit) in enumerate(nbrs):
            g = torch.where(hit[..., None], _gather(qd[..., a:c], idx), 0.0)
            acc = acc + g @ wd[k, a:c]
        parts.append((acc, m[gi]))
    return _dequant_sum(parts, feats.dtype)


def gather_gemm_sk_q8(feats, weights, key, kbits, act_absmax=None):
    """int8 self-keyed k=3 s=1 conv (neighbours as in
    ``conv.gather_gemm_sk``).

    Args:
      feats: [B, N, Cin] f32/bf16; weights: [27, Cin, Cout] f32.
      key, kbits: int32 [B, N] (sorted keys, per-row offset bitmap).
      act_absmax: optional calibrated [Cin] f32 (else dynamic).
    Returns [B, N, Cout] in the feature dtype (no bias, no mask).
    """
    if not _route(feats, weights, key, kbits):
        return gather_gemm_sk_q8_plain(feats, weights, key, kbits,
                                       act_absmax)
    _check("gather_gemm_sk_q8", feats, weights, 27,
           ((key, torch.int32), (kbits, torch.int32)))
    b, n, _ = feats.shape
    if key.shape != (b, n) or kbits.shape != (b, n):
        raise ValueError("gather_gemm_sk_q8: key/kbits must be [B, N]")
    out = _tile_launch(SK_Q8_LIB, "mrcc_conv_sk_q8", feats, weights,
                       (key.contiguous(), kbits.contiguous()), "k3",
                       act_absmax)
    SK_Q8.launches += 1
    return out


# ------------------------------------------------------------------- B7

def _map_conv_q8(mode, feats, weights, map_idx, map_hit, act_absmax):
    """The int8 conv over a K-offset map (down or k3 table), as the plain
    twins compute it."""
    b, n_in, _ = feats.shape
    n_out = map_idx.shape[2]
    groups, q, wq, m = _quantize(mode, feats, weights, n_in, act_absmax)
    qd, wd = q.double(), wq.double()
    parts = []
    for gi, (a, c) in enumerate(groups):
        acc = torch.zeros((b, n_out, wq.shape[-1]), dtype=torch.float64,
                          device=feats.device)
        for k in range(wq.shape[0]):
            g = torch.where(map_hit[k][..., None],
                            _gather(qd[..., a:c], map_idx[k]), 0.0)
            acc = acc + g @ wd[k, a:c]
        parts.append((acc, m[gi]))
    return _dequant_sum(parts, feats.dtype)


def gather_gemm_down_q8_plain(feats, weights, child_idx, child_hit,
                              act_absmax=None):
    """Plain twin of :func:`gather_gemm_down_q8`."""
    return _map_conv_q8("down", feats, weights, child_idx, child_hit,
                        act_absmax)


def gather_gemm_down_q8(feats, weights, child_idx, child_hit,
                        act_absmax=None, lists=None):
    """int8 k=2 s=2 down conv over the 8-child map (``conv.gather_gemm_down``).

    Args:
      feats: [B, N_fine, Cin] f32/bf16; weights: [8, Cin, Cout] f32.
      child_idx: int32 [8, B, N_coarse]; child_hit: bool [8, B, N_coarse].
      act_absmax: optional calibrated [Cin] f32.
      lists: the child map's ``HitLists`` ("down") or None (listed here).
    Returns [B, N_coarse, Cout] in the feature dtype.
    """
    if not _route(feats, weights, child_idx, child_hit):
        return gather_gemm_down_q8_plain(feats, weights, child_idx,
                                         child_hit, act_absmax)
    _check("gather_gemm_down_q8", feats, weights, 8,
           ((child_idx, torch.int32), (child_hit, torch.bool)))
    b, n_in, cin = feats.shape
    n_out = child_idx.shape[2]
    if child_idx.shape != (8, b, n_out) or child_hit.shape != (8, b, n_out):
        raise ValueError("gather_gemm_down_q8: maps must be [8, B, N_coarse]")
    lists = _lists("gather_gemm_down_q8", lists, "down", n_in,
                   (child_idx, child_hit))
    child_idx, child_hit = child_idx.contiguous(), child_hit.contiguous()
    ops = quantize_operands("down", feats, weights, n_in, act_absmax)
    cout = weights.shape[-1]
    ng = len(ops.groups)
    rows = b * n_out
    out = torch.empty((b, n_out, cout), dtype=feats.dtype,
                      device=feats.device)
    # y: each listed fine row's int32 product per group
    y = torch.empty((ng, b * n_in, cout), dtype=torch.int32,
                    device=feats.device)
    stream = stream_ptr(feats)
    sfx = _SUFFIX[feats.dtype]
    fidx = lists.lists[0]
    MAP_Q8_LIB.call(f"mrcc_list_gemm_q8_{sfx}", ptr(ops.q), ptr(ops.wq),
                    ptr(ops.m), ptr(fidx), ptr(fidx), ptr(lists.count),
                    ptr(y), 8, rows, b * n_in, cin, ops.cpad, cout, ops.gw,
                    ng, 0, stream)
    DOWN_Q8.launches += 1
    MAP_Q8_LIB.call(f"mrcc_child_sum_q8_{sfx}", ptr(y), ptr(ops.m),
                    ptr(child_idx), ptr(child_hit), ptr(out), b, n_in, n_out,
                    cout, ng, stream)
    Q8_SUM.launches += 1
    return out


def gather_gemm_up_q8_plain(feats, weights, parent_idx, row_ok, octant,
                            act_absmax=None):
    """Plain twin of :func:`gather_gemm_up_q8`."""
    groups, q, wq, m = _quantize("up", feats, weights, feats.shape[1],
                                 act_absmax, per_octant=True)
    qd, wd = q.double(), wq.double()
    sel = [(octant == k)[..., None] for k in range(8)]
    parts = []
    for gi, (a, c) in enumerate(groups):
        g = torch.where(row_ok[..., None], _gather(qd[..., a:c], parent_idx),
                        0.0)
        acc = torch.zeros(g.shape[:2] + (wq.shape[-1],), dtype=torch.float64,
                          device=feats.device)
        for k in range(8):
            acc = acc + torch.where(sel[k], g @ wd[k, a:c], 0.0)
        parts.append((acc, m[gi][octant.long()]))
    return _dequant_sum(parts, feats.dtype)


def gather_gemm_up_q8(feats, weights, parent_idx, row_ok, octant,
                      act_absmax=None, lists=None):
    """int8 k=2 s=2 transpose conv (``conv.gather_gemm_up``): one parent
    gather per output row, multiplied by its octant's weights and
    dequantised with that octant's column scales.

    Args:
      feats: [B, N_coarse, Cin] f32/bf16; weights: [8, Cin, Cout] f32.
      parent_idx, octant: int32 [B, N_fine]; row_ok: bool [B, N_fine].
      act_absmax: optional calibrated [Cin] f32.
      lists: the parent map's ``HitLists`` ("up") or None (listed here).
    Returns [B, N_fine, Cout] in the feature dtype.
    """
    if not _route(feats, weights, parent_idx, row_ok, octant):
        return gather_gemm_up_q8_plain(feats, weights, parent_idx, row_ok,
                                       octant, act_absmax)
    _check("gather_gemm_up_q8", feats, weights, 8,
           ((parent_idx, torch.int32), (row_ok, torch.bool),
            (octant, torch.int32)))
    b, n_in, cin = feats.shape
    n_out = parent_idx.shape[1]
    if (parent_idx.shape != (b, n_out) or row_ok.shape != (b, n_out)
            or octant.shape != (b, n_out)):
        raise ValueError("gather_gemm_up_q8: maps must be [B, N_fine]")
    lists = _lists("gather_gemm_up_q8", lists, "up", n_in,
                   (parent_idx, row_ok, octant))
    row_ok, octant = row_ok.contiguous(), octant.contiguous()
    ops = quantize_operands("up", feats, weights, n_in, act_absmax,
                            per_octant=True)
    cout = weights.shape[-1]
    rows = b * n_out
    out = torch.empty((b, n_out, cout), dtype=feats.dtype,
                      device=feats.device)
    stream = stream_ptr(feats)
    sfx = _SUFFIX[feats.dtype]
    # src: the coarse parent rows; dst: the fine rows
    fidx, gidx = lists.lists
    MAP_Q8_LIB.call(f"mrcc_list_gemm_q8_{sfx}", ptr(ops.q), ptr(ops.wq),
                    ptr(ops.m), ptr(fidx), ptr(gidx), ptr(lists.count),
                    ptr(out), 8, rows, rows, cin, ops.cpad, cout, ops.gw,
                    len(ops.groups), 1, stream)
    UP_Q8.launches += 1
    MAP_Q8_LIB.call(f"mrcc_zero_rows_q8_{sfx}", ptr(row_ok), ptr(octant),
                    ptr(out), rows, cout, stream)
    return out


def gather_gemm_k3_map_q8_plain(feats, weights, nbr_idx, nbr_hit,
                                act_absmax=None):
    """Plain twin of :func:`gather_gemm_k3_map_q8`."""
    return _map_conv_q8("k3_table", feats, weights, nbr_idx, nbr_hit,
                        act_absmax)


def gather_gemm_k3_map_q8(feats, weights, nbr_idx, nbr_hit, act_absmax=None):
    """int8 k=3 s=1 conv over a level's neighbour tables
    (``conv.gather_gemm_k3_map``), in the channel groups of
    ``q8_channel_groups("k3_table", N, Cin)``.

    Args:
      feats: [B, N, Cin] f32/bf16; weights: [27, Cin, Cout] f32.
      nbr_idx: int32 [27, B, N]; nbr_hit: bool [27, B, N].
      act_absmax: optional calibrated [Cin] f32.
    Returns [B, N, Cout] in the feature dtype.
    """
    if not _route(feats, weights, nbr_idx, nbr_hit):
        return gather_gemm_k3_map_q8_plain(feats, weights, nbr_idx, nbr_hit,
                                           act_absmax)
    _check("gather_gemm_k3_map_q8", feats, weights, 27,
           ((nbr_idx, torch.int32), (nbr_hit, torch.bool)))
    b, n, _ = feats.shape
    if nbr_idx.shape != (27, b, n) or nbr_hit.shape != (27, b, n):
        raise ValueError("gather_gemm_k3_map_q8: tables must be [27, B, N]")
    out = _tile_launch(MAP_Q8_LIB, "mrcc_conv_k3map_q8", feats, weights,
                       (nbr_idx.contiguous(), nbr_hit.contiguous()),
                       "k3_table", act_absmax)
    K3MAP_Q8.launches += 1
    return out


# ------------------------------------------- B7 down / up, by stages

def list_gemm_q8_plain(ops, src, dst, count, out_rows):
    """What the int8 list GEMM computes (``list_mma_q8_kernel``) on the
    operands ``ops`` (:class:`Q8Operands`, the kernels' layout): per group
    g, ``y[g, dst[k, e]] = q[src[k, e], group g] . wq[k, :, group g]`` for
    ``e < count[k]``, exact (float64), 0 in rows no list names.  The down
    conv keeps y for the child sum; the up conv dequantises it with the
    octants' scales.

    Args:
      ops: the operands, q's rows flattened; src, dst: int32 [K, L]; count:
        int32 [K].
    Returns float64 [G, out_rows, Cout].
    """
    qf = ops.q.reshape(-1, ops.cpad).double()
    wd = ops.wq.double()
    out = torch.zeros((len(ops.groups), out_rows, wd.shape[1]),
                      dtype=torch.float64, device=qf.device)
    for g, (a, c) in enumerate(ops.groups):
        for k, n in enumerate(count.tolist()):
            out[g, dst[k, :n].long()] = (qf[src[k, :n].long(), a:c]
                                         @ wd[k, :, a:c].T)
    return out


def child_sum_q8_plain(y, m, child_idx, child_hit, dtype):
    """What the down conv's child sum computes (``child_sum_q8_kernel``):
    per group, each coarse row's children of ``y`` [G, B, N_fine, Cout]
    summed exactly, then ``int32 -> f32 * m[g] -> dtype``, the groups added
    in ``dtype`` in group order.  Returns [B, N_coarse, Cout] in ``dtype``.
    """
    parts = []
    for g in range(y.shape[0]):
        acc = torch.zeros((y.shape[1], child_idx.shape[2], y.shape[-1]),
                          dtype=torch.float64, device=y.device)
        for k in range(8):
            acc = acc + torch.where(child_hit[k][..., None],
                                    _gather(y[g], child_idx[k]), 0.0)
        parts.append((acc, m[g]))
    return _dequant_sum(parts, dtype)
