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

Bias and the validity mask stay outside (``sparse/conv.py``).  The
quantisation is elementwise PyTorch on either device; for CUDA tensors the
integer part launches the kernel, for CPU tensors the plain twin (a float64
emulation of the int32 sums, exact below 2^53).

The two ``/ 127`` are what the JAX engine computes: it runs the wrappers
under ``jit``, where XLA folds a division by a constant into a product with
its f32 reciprocal, so ``/ 127`` is ``* f32(1 / 127)`` (one ulp from the
division in about 4 % of cases, enough to move a rounding of ``x / s_c``).
The other two divisions are true ones, by device tensors: CUDA computes
``x / python_scalar`` as ``x * (1 / scalar)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sparse.hierarchy import TABLE_BUDGET as _TABLE_BUDGET
from .build import I, KernelLibrary, LaunchCounter, P, ptr, stream_ptr
from .conv import _K3_DELTAS, _gather, _route, _sk_neighbours

SK_Q8_LIB = KernelLibrary("conv_sk_q8", {
    "mrcc_conv_sk_q8_f32": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_conv_sk_q8_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, P),
})
MAP_Q8_LIB = KernelLibrary("conv_map_q8", {
    "mrcc_conv_down_q8_f32": (P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "mrcc_conv_down_q8_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "mrcc_conv_up_q8_f32": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "mrcc_conv_up_q8_bf16": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "mrcc_conv_k3map_q8_f32": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_conv_k3map_q8_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, P),
})
LIBRARIES = (SK_Q8_LIB, MAP_Q8_LIB)
SK_Q8 = LaunchCounter("conv_sk_q8")
DOWN_Q8 = LaunchCounter("conv_down_q8")
UP_Q8 = LaunchCounter("conv_up_q8")
K3MAP_Q8 = LaunchCounter("conv_k3map_q8")

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


def _quantize(mode, feats, weights, n_table, act_absmax, per_octant=False):
    groups = q8_channel_groups(mode, n_table, feats.shape[-1])
    q, s_c = quantize_activations(feats, act_absmax)
    wq, m = quantize_weights(weights, s_c, groups, per_octant)
    return groups, q, wq, m


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


def _kernel_operands(q, wq, m, groups):
    """The kernels' layout: activations padded to whole 4-channel words
    (int8 [B, N, 4 * cw]), weights as int32 words of 4 consecutive input
    channels ([K, cw, Cout]), scales contiguous, the group width in words
    (every group but the last is a multiple of 128 channels)."""
    cin = q.shape[-1]
    cw = -(-cin // 4)
    if 4 * cw != cin:
        q = F.pad(q, (0, 4 * cw - cin))
        wq = F.pad(wq, (0, 0, 0, 4 * cw - cin))
    k, _, cout = wq.shape
    w32 = (wq.reshape(k, cw, 4, cout).permute(0, 1, 3, 2).contiguous()
           .view(torch.int32).reshape(k, cw, cout))
    gw = -(-(groups[0][1] - groups[0][0]) // 4)
    return q.contiguous(), w32, m.contiguous(), cw, gw, len(groups)


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
    groups, q, wq, m = _quantize("k3", feats, weights, n, act_absmax)
    q, w32, m, cw, gw, ng = _kernel_operands(q, wq, m, groups)
    cout = w32.shape[-1]
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    SK_Q8_LIB.call(f"mrcc_conv_sk_q8_{_SUFFIX[feats.dtype]}", ptr(q),
                   ptr(w32), ptr(m), ptr(key.contiguous()),
                   ptr(kbits.contiguous()), ptr(out), b, n, cw, cout, gw, ng,
                   stream_ptr(feats))
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
                        act_absmax=None):
    """int8 k=2 s=2 down conv over the 8-child map (``conv.gather_gemm_down``).

    Args:
      feats: [B, N_fine, Cin] f32/bf16; weights: [8, Cin, Cout] f32.
      child_idx: int32 [8, B, N_coarse]; child_hit: bool [8, B, N_coarse].
      act_absmax: optional calibrated [Cin] f32.
    Returns [B, N_coarse, Cout] in the feature dtype.
    """
    if not _route(feats, weights, child_idx, child_hit):
        return gather_gemm_down_q8_plain(feats, weights, child_idx,
                                         child_hit, act_absmax)
    _check("gather_gemm_down_q8", feats, weights, 8,
           ((child_idx, torch.int32), (child_hit, torch.bool)))
    b, n_in, _ = feats.shape
    n_out = child_idx.shape[2]
    if child_idx.shape != (8, b, n_out) or child_hit.shape != (8, b, n_out):
        raise ValueError("gather_gemm_down_q8: maps must be [8, B, N_coarse]")
    groups, q, wq, m = _quantize("down", feats, weights, n_in, act_absmax)
    q, w32, m, cw, gw, ng = _kernel_operands(q, wq, m, groups)
    cout = w32.shape[-1]
    out = torch.empty((b, n_out, cout), dtype=feats.dtype,
                      device=feats.device)
    MAP_Q8_LIB.call(f"mrcc_conv_down_q8_{_SUFFIX[feats.dtype]}", ptr(q),
                    ptr(w32), ptr(m), ptr(child_idx.contiguous()),
                    ptr(child_hit.contiguous()), ptr(out), b, n_in, n_out,
                    cw, cout, gw, ng, stream_ptr(feats))
    DOWN_Q8.launches += 1
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
                      act_absmax=None):
    """int8 k=2 s=2 transpose conv (``conv.gather_gemm_up``): one parent
    gather per output row, multiplied by its octant's weights and
    dequantised with that octant's column scales.

    Args:
      feats: [B, N_coarse, Cin] f32/bf16; weights: [8, Cin, Cout] f32.
      parent_idx, octant: int32 [B, N_fine]; row_ok: bool [B, N_fine].
      act_absmax: optional calibrated [Cin] f32.
    Returns [B, N_fine, Cout] in the feature dtype.
    """
    if not _route(feats, weights, parent_idx, row_ok, octant):
        return gather_gemm_up_q8_plain(feats, weights, parent_idx, row_ok,
                                       octant, act_absmax)
    _check("gather_gemm_up_q8", feats, weights, 8,
           ((parent_idx, torch.int32), (row_ok, torch.bool),
            (octant, torch.int32)))
    b, n_in, _ = feats.shape
    n_out = parent_idx.shape[1]
    if (parent_idx.shape != (b, n_out) or row_ok.shape != (b, n_out)
            or octant.shape != (b, n_out)):
        raise ValueError("gather_gemm_up_q8: maps must be [B, N_fine]")
    groups, q, wq, m = _quantize("up", feats, weights, n_in, act_absmax,
                                 per_octant=True)
    q, w32, m, cw, gw, ng = _kernel_operands(q, wq, m, groups)
    cout = w32.shape[-1]
    out = torch.empty((b, n_out, cout), dtype=feats.dtype,
                      device=feats.device)
    MAP_Q8_LIB.call(f"mrcc_conv_up_q8_{_SUFFIX[feats.dtype]}", ptr(q),
                    ptr(w32), ptr(m), ptr(parent_idx.contiguous()),
                    ptr(row_ok.contiguous()), ptr(octant.contiguous()),
                    ptr(out), b, n_in, n_out, cw, cout, gw, ng,
                    stream_ptr(feats))
    UP_Q8.launches += 1
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
    groups, q, wq, m = _quantize("k3_table", feats, weights, n, act_absmax)
    q, w32, m, cw, gw, ng = _kernel_operands(q, wq, m, groups)
    cout = w32.shape[-1]
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    MAP_Q8_LIB.call(f"mrcc_conv_k3map_q8_{_SUFFIX[feats.dtype]}", ptr(q),
                    ptr(w32), ptr(m), ptr(nbr_idx.contiguous()),
                    ptr(nbr_hit.contiguous()), ptr(out), b, n, cw, cout, gw,
                    ng, stream_ptr(feats))
    K3MAP_Q8.launches += 1
    return out
