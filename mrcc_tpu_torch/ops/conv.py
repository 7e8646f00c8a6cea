"""K2 and K3 — gather-GEMM sparse convolutions and their plain twins.

K2 (``csrc/conv_sk.cu``) replaces ``conv_pallas._gather_gemm_call_sk``: the
self-keyed k=3 s=1 conv that resolves neighbours from the level's sorted
keys and per-row validity bitmap, with no neighbour tables, on the
tensor-core tile of ``csrc/gather_mma.cuh``.

K3 (``csrc/conv_map.cu``) replaces ``conv_pallas._gather_gemm_call`` in its
k2-down and broadcast-k up modes, convs over the explicit stride-2 maps
that ``build_hierarchy`` scatters, in its k3-table mode
(:func:`gather_gemm_k3_map`), the k=3 s=1 conv over the rank kernel's
neighbour tables (K2's tile with a table load for the key search, so the
two k3 routes give the same bits), and in its generic strided-map mode
(:func:`gather_gemm_map`, K2's tile over a [K, B, N_out] map into another
level's rows: the sparse ResNet's stem and conv5); reading global memory
at any N, it also stands in for ``conv_pallas._gather_gemm_call_hbm``.  The down and up convs
are a list GEMM on tensor cores (``csrc/list_mma.cuh``) over the per-octant
hit lists of their map (``ops/hit_lists.py``): up stores each fine row's
parent times ``W[octant]`` in place, down stores each fine row's product
with its octant's slice in an f32 scratch and sums each coarse row's
children (:func:`list_gemm`, :func:`child_sum`).

The weight gradients: ``csrc/conv_dw.cu`` (:func:`dw_sk`, :func:`dw_down`,
:func:`dw_up`, :func:`dw_k3_map`) replaces ``conv_pallas._dw_call_sk`` and
``conv_pallas._dw_call`` in its down, up and k3-table modes
(``csrc/dw_gemm.cuh``): a tensor-core gather-GEMM over the map's hit lists
and a fixed-order sum of its partials.  Every wrapper that reads lists
takes a map's :class:`~.hit_lists.HitLists` as its last argument (a level
holds one a map, so that each map is listed once a step) and lists the map
itself where given none.  The autograd Functions
:class:`SkConvFn`, :class:`K3MapConvFn`, :class:`DownConvFn` and
:class:`UpConvFn` carry the JAX custom VJPs (``pallas_conv_sk_op``,
``pallas_conv_op``): data cotangents through the forward kernels over the
reverse maps (the k3 convs over their own level with ``W[26 - k]^T``),
weight cotangents through the dW kernels.  Both k3 routes train: the self-keyed one and the
table one.  Given a level's k3 order (``ops/k3_order.py``: rows grouped by
their neighbour masks, in three offset segments), both k3 convs run the
ordered tile over it instead of the one-pass tile, with the same bits; the
packed stem (Cin <= 8) keeps the one-pass tile.  :func:`k3_tile_stages`
counts the stages of both schedules on a level.

Each wrapper launches its kernel for CUDA tensors (f32 or bf16 features,
weights / gradients of the same dtype, f32 accumulation) and runs its plain
twin for CPU tensors.  The plain twins are the JAX ``"xla"`` formulation
(``mrcc_tpu/sparse/conv.py:60-96``): a loop over offsets of gather ->
mask -> matmul with f32 accumulation, cast back to the feature dtype (dW
stays f32).  They also take float64 (the parity tests' training steps):
each offset's product is then computed in float64 and rounded to f32
before the f32 sum, as XLA computes ``einsum(..., preferred_element_type=
float32)`` of float64 operands, and dW is float64.  Bias stays outside
(``sparse/conv.py``).
"""

from __future__ import annotations

import torch

from ..tracing import LaunchCounter
from . import k3_order as _order
from .build import I, KernelLibrary, P, ptr, route as _route, stream_ptr
from .hit_lists import K3_DELTAS as _K3_DELTAS
from .hit_lists import HitLists, _sk_neighbours

# The k3 data cotangent is the same self-keyed conv with W[26 - k]^T: a hit
# (i, k) exists iff the hit (i + delta_k, 26 - k) does.
if any(_K3_DELTAS[26 - k] != -d for k, d in enumerate(_K3_DELTAS)):
    raise AssertionError("K3_OFFSETS lost the negated-delta symmetry")

SK_LIB = KernelLibrary("conv_sk", {
    "mrcc_conv_sk_f32": (P, P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_sk_bf16": (P, P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_sk_ordered_f32": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_sk_ordered_bf16": (P, P, P, P, P, P, P, I, I, I, I, I, P),
})
MAP_LIB = KernelLibrary("conv_map", {
    "mrcc_list_gemm_f32": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_list_gemm_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_child_sum_f32": (P, P, P, P, I, I, I, I, P),
    "mrcc_child_sum_bf16": (P, P, P, P, I, I, I, I, P),
    "mrcc_zero_rows_f32": (P, P, P, I, I, P),
    "mrcc_zero_rows_bf16": (P, P, P, I, I, P),
    "mrcc_conv_k3map_f32": (P, P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_k3map_bf16": (P, P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_k3map_ordered_f32": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_k3map_ordered_bf16": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_map_f32": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_conv_map_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, P),
})
DW_LIB = KernelLibrary("conv_dw", {
    "mrcc_dw_f32": (P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_dw_bf16": (P, P, P, P, P, P, I, I, I, I, I, P),
})
LIBRARIES = (SK_LIB, MAP_LIB, DW_LIB)
SK = LaunchCounter("conv_sk")
DOWN = LaunchCounter("conv_down")
UP = LaunchCounter("conv_up")
K3MAP = LaunchCounter("conv_k3map")
MAP = LaunchCounter("conv_map")  # the strided map conv
DW_SK = LaunchCounter("dw_sk")
DW_DOWN = LaunchCounter("dw_down")
DW_UP = LaunchCounter("dw_up")
DW_K3MAP = LaunchCounter("dw_k3map")
K3_SUM = LaunchCounter("k3_child_sum")  # the down conv's child sum

_DW_MI_SPLIT = 128        # DW_MI_SPLIT of csrc/dw_gemm.cuh
_DW_RESIDENT = 2 * 132    # dW blocks resident at once (2 an SM, 132 SMs)
_DW_WAVES = 8             # waves of dW blocks a launch aims at
_DW_MIN_ROWS = 4096       # list rows of one slot at least

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_K3_KINDS = ("sk", "k3map")  # a level's k3 map: both give the same lists

_MMA_ROWS = 64     # BM of csrc/gather_mma.cuh
_MMA_COLS = 128    # BN
_MMA_LIST = 27 * 64 + 28  # LIST: one row tile's neighbours and offsets


def _check_types(name, feats, other, label, index_tensors):
    if feats.dtype not in _SUFFIX:
        raise ValueError(f"{name}: feats dtype {feats.dtype} not in "
                         "(float32, bfloat16)")
    if other.dtype != feats.dtype:
        raise ValueError(f"{name}: {label} {other.dtype} != feats "
                         f"{feats.dtype}")
    for t, dtype in index_tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: map dtype {t.dtype} != {dtype}")


def _check(name, feats, weights, k, index_tensors):
    _check_types(name, feats, weights, "weights", index_tensors)
    if feats.dim() != 3 or weights.dim() != 3 or weights.shape[0] != k \
            or weights.shape[1] != feats.shape[-1]:
        raise ValueError(f"{name}: feats {tuple(feats.shape)} / weights "
                         f"{tuple(weights.shape)} do not fit [B, N, Cin] / "
                         f"[{k}, Cin, Cout]")


def _check_dw(name, feats, g, index_tensors):
    _check_types(name, feats, g, "g", index_tensors)
    if feats.dim() != 3 or g.dim() != 3 or g.shape[0] != feats.shape[0]:
        raise ValueError(f"{name}: feats {tuple(feats.shape)} / g "
                         f"{tuple(g.shape)} do not fit [B, N, C]")


def _dw_slots(k, cin, cout, rows):
    """Slots of a dW launch (``csrc/dw_gemm.cuh``): at least one per offset,
    the rest spread over the offsets by their hits on the card.  Enough
    blocks for ``_DW_WAVES`` waves (blocks of about equal work, so that
    the last wave is short), at most one slot per ``_DW_MIN_ROWS`` list
    rows of an offset."""
    wide, narrow = max(cin, cout), min(cin, cout)
    block_m = 128 if wide > _DW_MI_SPLIT else 64
    tiles = -(-wide // block_m) * -(-narrow // 128)
    return max(k, min(_DW_WAVES * _DW_RESIDENT // tiles,
                      k * -(-rows // _DW_MIN_ROWS)))


def _scratch(device, nbytes):
    """One allocation carved into 256-byte aligned pieces of ``nbytes``:
    ``(the allocation, the pieces' addresses, None for an empty one)``."""
    starts = [0]
    for n in nbytes[:-1]:
        starts.append(starts[-1] + -(-n // 256) * 256)
    scratch = torch.empty(starts[-1] + nbytes[-1], dtype=torch.uint8,
                          device=device)
    return scratch, [scratch.data_ptr() + o if n else None
                     for o, n in zip(starts, nbytes)]


def _lists(name, lists, kind, n_in, maps, kinds=None):
    """A reader's hit lists: ``lists`` checked against the map it reads (of
    ``kinds``, default ``kind``), or where None the lists of ``maps``."""
    if lists is None:
        return HitLists(kind, n_in, *maps)
    lists.check(name, kinds or (kind,), n_in, maps[0].shape[-2:])
    return lists


def _dw_launch(feats, g, lists):
    """One dW launch on checked, contiguous CUDA operands over the map's
    ``lists`` (listed first where they are not yet), with the partial
    sums' scratch where there is more than one slot per offset.  Returns
    dW [K, cin, cout] f32."""
    k, cin, cout = lists.count.shape[0], feats.shape[-1], g.shape[-1]
    rows = g.shape[0] * g.shape[1]
    slots = _dw_slots(k, cin, cout, rows)
    out = torch.empty((k, cin, cout), dtype=torch.float32,
                      device=feats.device)
    part = (torch.empty((slots, cin, cout), dtype=torch.float32,
                        device=feats.device) if slots > k else None)
    DW_LIB.call(f"mrcc_dw_{_SUFFIX[feats.dtype]}", ptr(feats), ptr(g),
                ptr(lists.lists), ptr(lists.count), ptr(part), ptr(out), k,
                rows, cin, cout, slots, stream_ptr(feats))
    return out


def _k3_lists(b, n, cout, device):
    """Scratch of the k3 convs' resolved row tiles (``gather_mma.cuh``),
    used where Cout spans several column tiles."""
    if cout <= _MMA_COLS:
        return None
    return torch.empty(b * -(-n // _MMA_ROWS) * _MMA_LIST, dtype=torch.int32,
                       device=device)


def _ordered(order, feats, name):
    """Whether a k3 conv runs the ordered tile over ``order`` (given, and
    not the packed stem: Cin <= 8); raises if it is another level's."""
    if order is None or feats.shape[-1] * 4 <= 32:
        return False
    b, n = feats.shape[:2]
    if order.mask.shape != (b, n):
        raise ValueError(f"{name}: k3 order of {tuple(order.mask.shape)} "
                         f"rows, feats {tuple(feats.shape)}")
    return True


def _ordered_launch(lib, fname, feats, weights, order):
    """The ordered tile on checked, contiguous CUDA operands: its f32
    partial sums in out (f32) or in a scratch (bf16), its ticket and each
    (segment, item)'s count of finished tiles in a scratch of 1 + S * B
    ints."""
    b, n, cin = feats.shape
    cout = weights.shape[-1]
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    f32 = feats.dtype == torch.float32
    _, (part, sync) = _scratch(feats.device, (
        0 if f32 else 4 * b * n * cout, 4 * (1 + order.segments * b)))
    lib.call(fname, ptr(feats), ptr(weights), ptr(order.lists),
             ptr(order.counts), part, sync, ptr(out), order.segments, b, n,
             cin, cout, stream_ptr(feats))
    return out


def _wide(dtype):
    """The plain twins' operand dtype: f32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _gather(f, idx):
    """f [B, N, C], idx [B, M] -> [B, M, C]."""
    return f.gather(1, idx.long()[..., None].expand(-1, -1, f.shape[-1]))


def _outer_sum(a, g):
    """sum over rows of a [B, M, Cin]^T (x) g [B, M, Cout] -> [Cin, Cout]."""
    return a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])


# ------------------------------------------------------------------- K2

def gather_gemm_sk_plain(feats, weights, key, kbits):
    """Plain twin of :func:`gather_gemm_sk` (searchsorted neighbour maps)."""
    b, n, _ = feats.shape
    out = torch.zeros((b, n, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    if n == 0:
        return out.to(feats.dtype)
    f = feats.to(_wide(feats.dtype))
    w = weights.to(feats.dtype).to(f.dtype)
    key = key.contiguous()
    for k, d in enumerate(_K3_DELTAS):
        idx, hit = _sk_neighbours(key, kbits, k, d)
        g = torch.where(hit[..., None], _gather(f, idx), 0.0)
        out = out + (g @ w[k]).float()
    return out.to(feats.dtype)


def gather_gemm_sk(feats, weights, key, kbits, order=None):
    """Self-keyed k=3 s=1 conv.

    ``out[b, i] = sum_k bit_k(kbits[b, i]) * feats[b, j] @ W[k]`` with
    ``key[b, j] == key[b, i] + delta_k``.

    Args:
      feats: [B, N, Cin] f32/bf16; weights: [27, Cin, Cout] same dtype.
      key: int32 [B, N] sorted per item (KEY_PAD padding).
      kbits: int32 [B, N] per-row offset validity bitmap (0 at padding).
      order: the level's k3 order (``ops.k3_order``) or None; the card
        runs the ordered tile over it (the same bits).
    Returns [B, N, Cout] in the feature dtype (f32 accumulation).
    """
    if not _route(feats, weights, key, kbits):
        return gather_gemm_sk_plain(feats, weights, key, kbits)
    _check("gather_gemm_sk", feats, weights, 27,
           ((key, torch.int32), (kbits, torch.int32)))
    b, n, cin = feats.shape
    cout = weights.shape[-1]
    if key.shape != (b, n) or kbits.shape != (b, n):
        raise ValueError("gather_gemm_sk: key/kbits must be [B, N]")
    feats, weights = feats.contiguous(), weights.contiguous()
    if _ordered(order, feats, "gather_gemm_sk"):
        out = _ordered_launch(SK_LIB, "mrcc_conv_sk_ordered_"
                              f"{_SUFFIX[feats.dtype]}", feats, weights, order)
        SK.launches += 1
        return out
    key, kbits = key.contiguous(), kbits.contiguous()
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    lists = _k3_lists(b, n, cout, feats.device)
    SK_LIB.call(f"mrcc_conv_sk_{_SUFFIX[feats.dtype]}", ptr(feats),
                ptr(weights), ptr(key), ptr(kbits), ptr(lists), ptr(out), b, n,
                cin, cout, stream_ptr(feats))
    SK.launches += 1
    return out


# ------------------------------------------------------------------- K3

def _map_conv(feats, weights, map_idx, map_hit):
    """``sum_k map_hit[k] * feats[map_idx[k]] @ W[k]`` in f32, cast back."""
    b = feats.shape[0]
    n_out = map_idx.shape[2]
    f = feats.to(_wide(feats.dtype))
    w = weights.to(feats.dtype).to(f.dtype)
    out = torch.zeros((b, n_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for k in range(weights.shape[0]):
        g = torch.where(map_hit[k][..., None], _gather(f, map_idx[k]), 0.0)
        out = out + (g @ w[k]).float()
    return out.to(feats.dtype)


def gather_gemm_down_plain(feats, weights, child_idx, child_hit):
    """Plain twin of :func:`gather_gemm_down`."""
    return _map_conv(feats, weights, child_idx, child_hit)


def gather_gemm_down(feats, weights, child_idx, child_hit, lists=None):
    """k=2 s=2 down conv over the 8-child map.

    ``out[b, p] = sum_k child_hit[k, b, p] * feats[b, child_idx[k, b, p]] @ W[k]``

    Args:
      feats: [B, N_fine, Cin]; weights: [8, Cin, Cout] same dtype.
      child_idx: int32 [8, B, N_coarse]; child_hit: bool [8, B, N_coarse].
      lists: the child map's ``HitLists`` ("down") or None (listed here).
    Returns [B, N_coarse, Cout].
    """
    if not _route(feats, weights, child_idx, child_hit):
        return gather_gemm_down_plain(feats, weights, child_idx, child_hit)
    _check("gather_gemm_down", feats, weights, 8,
           ((child_idx, torch.int32), (child_hit, torch.bool)))
    b, n_in, _ = feats.shape
    n_out = child_idx.shape[2]
    if child_idx.shape != (8, b, n_out) or child_hit.shape != (8, b, n_out):
        raise ValueError("gather_gemm_down: maps must be [8, B, N_coarse]")
    lists = _lists("gather_gemm_down", lists, "down", n_in,
                   (child_idx, child_hit))
    out = _map_conv_launch("down", feats, weights,
                           (child_idx.contiguous(), child_hit.contiguous()),
                           n_out, lists)
    DOWN.launches += 1
    return out


def gather_gemm_k3_map_plain(feats, weights, nbr_idx, nbr_hit):
    """Plain twin of :func:`gather_gemm_k3_map` (the JAX ``"xla"``
    ``conv_kernel_map``)."""
    return _map_conv(feats, weights, nbr_idx, nbr_hit)


def gather_gemm_k3_map(feats, weights, nbr_idx, nbr_hit, order=None):
    """k=3 s=1 conv over a level's neighbour tables.

    ``out[b, i] = sum_k nbr_hit[k, b, i] * feats[b, nbr_idx[k, b, i]] @ W[k]``

    Args:
      feats: [B, N, Cin] f32/bf16; weights: [27, Cin, Cout] same dtype.
      nbr_idx: int32 [27, B, N]; nbr_hit: bool [27, B, N]
        (``sparse.hierarchy.neighbor_tables``).
      order: the level's k3 order or None, as for :func:`gather_gemm_sk`.
    Returns [B, N, Cout] in the feature dtype (f32 accumulation).
    """
    if not _route(feats, weights, nbr_idx, nbr_hit):
        return gather_gemm_k3_map_plain(feats, weights, nbr_idx, nbr_hit)
    _check("gather_gemm_k3_map", feats, weights, 27,
           ((nbr_idx, torch.int32), (nbr_hit, torch.bool)))
    b, n, _ = feats.shape
    cout = weights.shape[-1]
    if nbr_idx.shape != (27, b, n) or nbr_hit.shape != (27, b, n):
        raise ValueError("gather_gemm_k3_map: tables must be [27, B, N]")
    feats, weights = feats.contiguous(), weights.contiguous()
    if _ordered(order, feats, "gather_gemm_k3_map"):
        out = _ordered_launch(MAP_LIB, "mrcc_conv_k3map_ordered_"
                              f"{_SUFFIX[feats.dtype]}", feats, weights, order)
        K3MAP.launches += 1
        return out
    nbr_idx, nbr_hit = nbr_idx.contiguous(), nbr_hit.contiguous()
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    lists = _k3_lists(b, n, cout, feats.device)
    MAP_LIB.call(f"mrcc_conv_k3map_{_SUFFIX[feats.dtype]}", ptr(feats),
                 ptr(weights), ptr(nbr_idx), ptr(nbr_hit), ptr(lists),
                 ptr(out), b, n, feats.shape[-1], cout, stream_ptr(feats))
    K3MAP.launches += 1
    return out


def k3_tile_stages(level, order=None):
    """How far the k3 order cuts the k3 tile's work on one level: ring
    stages as 64 x the (tile, offset) pairs with a hit, and MMA slots as 16
    x the (16-row group, offset) pairs with a hit, each per (row, offset)
    hit, in key order (the one-pass tile: 64 consecutive rows, all 27
    offsets) and in ``order`` (default: the level's ``k3_order``, else built
    here).  Off the hot path: it reads the counts back to the host.

    Returns ``{"hits", "stages_row_order", "stages_ordered",
    "mma_row_order", "mma_ordered"}`` (per hit; 0 for a level with no
    hit)."""
    order = order or level.k3_order or _order.level_order(level)
    if order is None:
        return {"hits": 0, "stages_row_order": 0.0, "stages_ordered": 0.0,
                "mma_row_order": 0.0, "mma_ordered": 0.0}
    hits = _order.hits(order)
    per = max(hits, 1)
    pairs0, groups0 = _order.key_order_stages(order.mask)
    pairs1, groups1 = _order.tile_stages(order)
    return {"hits": hits, "stages_row_order": 64 * pairs0 / per,
            "stages_ordered": 64 * pairs1 / per,
            "mma_row_order": 16 * groups0 / per,
            "mma_ordered": 16 * groups1 / per}


def gather_gemm_map_plain(feats, weights, map_idx, map_hit):
    """Plain twin of :func:`gather_gemm_map` (the JAX ``"xla"``
    ``conv_kernel_map``)."""
    return _map_conv(feats, weights, map_idx, map_hit)


def gather_gemm_map(feats, weights, map_idx, map_hit):
    """Strided sparse conv over an explicit kernel map.

    ``out[b, i] = sum_k map_hit[k, b, i] * feats[b, map_idx[k, b, i]] @ W[k]``

    for K <= 27 offsets and an output level of its own (N_in != N_out): the
    sparse ResNet's k=3 s=2 stem and k=3 s=3 conv5 over the child maps of
    ``sparse.hierarchy.downsample_level``.  Inference only: no backward.

    Args:
      feats: [B, N_in, Cin] f32/bf16; weights: [K, Cin, Cout] same dtype.
      map_idx: int32 [K, B, N_out] (rows of feats where hit);
      map_hit: bool [K, B, N_out].
    Returns [B, N_out, Cout] in the feature dtype (f32 accumulation).
    """
    if not _route(feats, weights, map_idx, map_hit):
        return gather_gemm_map_plain(feats, weights, map_idx, map_hit)
    k = map_idx.shape[0] if map_idx.dim() == 3 else -1
    if not 1 <= k <= 27:
        raise ValueError(f"gather_gemm_map: map {tuple(map_idx.shape)}, "
                         "need [K <= 27, B, N_out]")
    _check("gather_gemm_map", feats, weights, k,
           ((map_idx, torch.int32), (map_hit, torch.bool)))
    b, n_in, cin = feats.shape
    n_out = map_idx.shape[2]
    cout = weights.shape[-1]
    if map_idx.shape != (k, b, n_out) or map_hit.shape != (k, b, n_out):
        raise ValueError("gather_gemm_map: maps must be [K, B, N_out]")
    feats, weights = feats.contiguous(), weights.contiguous()
    map_idx, map_hit = map_idx.contiguous(), map_hit.contiguous()
    out = torch.empty((b, n_out, cout), dtype=feats.dtype,
                      device=feats.device)
    lists = _k3_lists(b, n_out, cout, feats.device)
    MAP_LIB.call(f"mrcc_conv_map_{_SUFFIX[feats.dtype]}", ptr(feats),
                 ptr(weights), ptr(map_idx), ptr(map_hit), ptr(lists),
                 ptr(out), b, n_in, n_out, k, cin, cout, stream_ptr(feats))
    MAP.launches += 1
    return out


def gather_gemm_up_plain(feats, weights, parent_idx, row_ok, octant):
    """Plain twin of :func:`gather_gemm_up` (eight octant-masked products,
    as ``mrcc_tpu/sparse/conv.py:258-277``)."""
    f = feats.to(_wide(feats.dtype))
    w = weights.to(feats.dtype).to(f.dtype)
    g = torch.where(row_ok[..., None], _gather(f, parent_idx), 0.0)
    out = torch.zeros(g.shape[:2] + (weights.shape[-1],), dtype=torch.float32,
                      device=feats.device)
    for k in range(weights.shape[0]):
        out = out + torch.where((octant == k)[..., None],
                                (g @ w[k]).float(), 0.0)
    return out.to(feats.dtype)


def gather_gemm_up(feats, weights, parent_idx, row_ok, octant, lists=None):
    """k=2 s=2 transpose conv: one parent gather per output row.

    ``out[b, c] = row_ok[b, c] * feats[b, parent_idx[b, c]] @ W[octant[b, c]]``

    Args:
      feats: [B, N_coarse, Cin]; weights: [8, Cin, Cout] same dtype.
      parent_idx, octant: int32 [B, N_fine]; row_ok: bool [B, N_fine]
        (valid & parent_ok — overflowed parents alias slot capacity-1).
      lists: the parent map's ``HitLists`` ("up") or None (listed here).
    Returns [B, N_fine, Cout].
    """
    if not _route(feats, weights, parent_idx, row_ok, octant):
        return gather_gemm_up_plain(feats, weights, parent_idx, row_ok, octant)
    _check("gather_gemm_up", feats, weights, 8,
           ((parent_idx, torch.int32), (row_ok, torch.bool),
            (octant, torch.int32)))
    b = feats.shape[0]
    n_out = parent_idx.shape[1]
    if (parent_idx.shape != (b, n_out) or row_ok.shape != (b, n_out)
            or octant.shape != (b, n_out)):
        raise ValueError("gather_gemm_up: maps must be [B, N_fine]")
    maps = (parent_idx, row_ok, octant)
    lists = _lists("gather_gemm_up", lists, "up", feats.shape[1], maps)
    out = _map_conv_launch("up", feats, weights,
                           [m.contiguous() for m in maps], n_out, lists)
    UP.launches += 1
    return out


def _map_conv_launch(kind, feats, weights, maps, n_out, lists):
    """K3's down or up conv on checked CUDA operands (``maps`` contiguous,
    as the wrappers take them) over the map's ``lists`` (listed first where
    they are not yet), two launches: the list GEMM, and the down conv's
    child sum (over an f32 scratch of the fine rows' products) or the up
    conv's zero pass."""
    feats, weights = feats.contiguous(), weights.contiguous()
    b, n_in, cin = feats.shape
    cout = weights.shape[-1]
    rows = b * n_out
    down = kind == "down"
    fidx, gidx = lists.lists
    out = torch.empty((b, n_out, cout), dtype=feats.dtype, device=feats.device)
    y = (torch.empty((b * n_in, cout), dtype=torch.float32,
                     device=feats.device) if down else out)
    stream = stream_ptr(feats)
    sfx = _SUFFIX[feats.dtype]
    # down: src = dst = the fine row, into y; up: src the coarse parent,
    # dst the fine row, into out
    MAP_LIB.call(f"mrcc_list_gemm_{sfx}", ptr(feats), ptr(weights), ptr(fidx),
                 ptr(fidx if down else gidx), ptr(lists.count), ptr(y), 8,
                 rows, b * n_in if down else rows, cin, cout,
                 int(down or feats.dtype == torch.float32), stream)
    if down:
        MAP_LIB.call(f"mrcc_child_sum_{sfx}", ptr(y), *map(ptr, maps),
                     ptr(out), b, n_in, n_out, cout, stream)
        K3_SUM.launches += 1
    else:
        MAP_LIB.call(f"mrcc_zero_rows_{sfx}", ptr(maps[1]), ptr(maps[2]),
                     ptr(out), rows, cout, stream)
    return out


def list_gemm_plain(feats, weights, src, dst, count, out_rows):
    """Plain twin of :func:`list_gemm`."""
    f = feats.reshape(-1, feats.shape[-1]).float()
    w = weights.to(feats.dtype).float()
    out = torch.zeros((out_rows, w.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for k, c in enumerate(count.tolist()):
        out[dst[k, :c].long()] = f[src[k, :c].long()] @ w[k]
    return out


def list_gemm(feats, weights, src, dst, count, out_rows):
    """The list GEMM of K3's down and up convs, alone.

    ``out[dst[k, e]] = feats[src[k, e]] @ W[k]`` for ``e < count[k]``, in
    f32 (f32 accumulation); rows no list names are 0.

    Args:
      feats: [..., Cin] f32/bf16, its rows flattened; weights: [K, Cin,
        Cout] same dtype.
      src, dst: int32 [K, L] rows of the flattened feats and of out; each
        out row lies in at most one list (``dst``).  count: int32 [K].
      out_rows: rows of out.
    Returns [out_rows, Cout] f32.
    """
    if not _route(feats, weights, src, dst, count):
        return list_gemm_plain(feats, weights, src, dst, count, out_rows)
    _check_types("list_gemm", feats, weights, "weights",
                 ((src, torch.int32), (dst, torch.int32),
                  (count, torch.int32)))
    k, cin, cout = weights.shape
    if (feats.shape[-1] != cin or src.dim() != 2 or src.shape[0] != k
            or dst.shape != src.shape or count.shape != (k,)):
        raise ValueError(f"list_gemm: feats {tuple(feats.shape)}, weights "
                         f"{tuple(weights.shape)}, lists {tuple(src.shape)} "
                         f"/ {tuple(dst.shape)}, count {tuple(count.shape)}")
    feats, weights = feats.contiguous(), weights.contiguous()
    out = torch.zeros((out_rows, cout), dtype=torch.float32,
                      device=feats.device)
    MAP_LIB.call(f"mrcc_list_gemm_{_SUFFIX[feats.dtype]}", ptr(feats),
                 ptr(weights), ptr(src.contiguous()), ptr(dst.contiguous()),
                 ptr(count.contiguous()), ptr(out), k, src.shape[1],
                 out_rows, cin, cout, 1, stream_ptr(feats))
    return out


def child_sum_plain(y, child_idx, child_hit, dtype):
    """Plain twin of :func:`child_sum`."""
    out = torch.zeros((y.shape[0], child_idx.shape[2], y.shape[-1]),
                      dtype=torch.float32, device=y.device)
    for k in range(8):
        out = out + torch.where(child_hit[k][..., None],
                                _gather(y, child_idx[k]), 0.0)
    return out.to(dtype)


def child_sum(y, child_idx, child_hit, dtype):
    """The down conv's second pass, alone: ``out[b, p] = sum_k
    child_hit[k, b, p] * y[b, child_idx[k, b, p]]`` in f32, octant by
    octant, cast once to ``dtype`` (0 where no child hits).

    Args:
      y: [B, N_fine, C] f32 (each fine row's product with its octant's
        weight slice); child_idx: int32 [8, B, N_coarse]; child_hit: bool
        [8, B, N_coarse]; dtype: float32 or bfloat16.
    Returns [B, N_coarse, C] in ``dtype``.
    """
    if not _route(y, child_idx, child_hit):
        return child_sum_plain(y, child_idx, child_hit, dtype)
    b, n_in, c = y.shape
    n_out = child_idx.shape[2]
    if (y.dtype != torch.float32 or dtype not in _SUFFIX
            or child_idx.dtype != torch.int32
            or child_hit.dtype != torch.bool
            or child_idx.shape != (8, b, n_out)
            or child_hit.shape != child_idx.shape):
        raise ValueError(f"child_sum: y {y.dtype} {tuple(y.shape)}, maps "
                         f"{child_idx.dtype} {tuple(child_idx.shape)} / "
                         f"{child_hit.dtype}, out {dtype}")
    y = y.contiguous()
    out = torch.empty((b, n_out, c), dtype=dtype, device=y.device)
    MAP_LIB.call(f"mrcc_child_sum_{_SUFFIX[dtype]}", ptr(y),
                 ptr(child_idx.contiguous()), ptr(child_hit.contiguous()),
                 ptr(out), b, n_in, n_out, c, stream_ptr(y))
    K3_SUM.launches += 1
    return out


# ------------------------------------------------------ dW of K2 and K3

def dw_sk_plain(feats, g, key, kbits):
    """Plain twin of :func:`dw_sk`."""
    cin, cout = feats.shape[-1], g.shape[-1]
    out = torch.zeros((27, cin, cout), dtype=_wide(feats.dtype),
                      device=feats.device)
    if feats.shape[1] == 0:
        return out
    f = feats.to(out.dtype)
    gf = g.to(feats.dtype).to(out.dtype)
    key = key.contiguous()
    for k, d in enumerate(_K3_DELTAS):
        idx, hit = _sk_neighbours(key, kbits, k, d)
        out[k] = _outer_sum(torch.where(hit[..., None], _gather(f, idx), 0.0),
                            gf)
    return out


def dw_sk(feats, g, key, kbits, lists=None):
    """Weight gradient of :func:`gather_gemm_sk`.

    ``dW[k] = sum_{b, i} bit_k(kbits[b, i]) * feats[b, j]^T (x) g[b, i]``
    with ``key[b, j] == key[b, i] + delta_k``.

    Args:
      feats: [B, N, Cin] f32/bf16 (the conv's input); g: [B, N, Cout] same
        dtype, the output cotangent masked by the level's validity.
      key, kbits: int32 [B, N] as for :func:`gather_gemm_sk`.
      lists: the level's k3 ``HitLists`` ("sk" or "k3map": the same
        lists) or None (listed here).
    Returns [27, Cin, Cout] f32.
    """
    if not _route(feats, g, key, kbits):
        return dw_sk_plain(feats, g, key, kbits)
    _check_dw("dw_sk", feats, g, ((key, torch.int32), (kbits, torch.int32)))
    b, n = feats.shape[:2]
    if g.shape[1] != n or key.shape != (b, n) or kbits.shape != (b, n):
        raise ValueError("dw_sk: g must be [B, N, Cout], key/kbits [B, N]")
    lists = _lists("dw_sk", lists, "sk", n, (key, kbits), _K3_KINDS)
    out = _dw_launch(feats.contiguous(), g.contiguous(), lists)
    DW_SK.launches += 1
    return out


def _map_dw(feats, g, map_idx, map_hit):
    """``sum_{b, r} map_hit[k] * feats[map_idx[k]]^T (x) g`` per offset k,
    in f32 (float64 for float64 features)."""
    k_taps = map_idx.shape[0]
    out = torch.zeros((k_taps, feats.shape[-1], g.shape[-1]),
                      dtype=_wide(feats.dtype), device=feats.device)
    f = feats.to(out.dtype)
    gf = g.to(feats.dtype).to(out.dtype)
    for k in range(k_taps):
        out[k] = _outer_sum(torch.where(map_hit[k][..., None],
                                        _gather(f, map_idx[k]), 0.0), gf)
    return out


def dw_down_plain(feats, g, child_idx, child_hit):
    """Plain twin of :func:`dw_down`."""
    return _map_dw(feats, g, child_idx, child_hit)


def dw_down(feats, g, child_idx, child_hit, lists=None):
    """Weight gradient of :func:`gather_gemm_down`.

    ``dW[k] = sum_{b, p} child_hit[k, b, p] * feats[b, child_idx[k, b, p]]^T
    (x) g[b, p]``

    Args:
      feats: [B, N_fine, Cin] f32/bf16; g: [B, N_coarse, Cout] same dtype,
        masked by the coarse level's validity.
      child_idx: int32 [8, B, N_coarse]; child_hit: bool [8, B, N_coarse].
      lists: the child map's ``HitLists`` ("down") or None (listed here).
    Returns [8, Cin, Cout] f32.
    """
    if not _route(feats, g, child_idx, child_hit):
        return dw_down_plain(feats, g, child_idx, child_hit)
    _check_dw("dw_down", feats, g, ((child_idx, torch.int32),
                                    (child_hit, torch.bool)))
    b, n_in = feats.shape[:2]
    n_out = g.shape[1]
    if child_idx.shape != (8, b, n_out) or child_hit.shape != (8, b, n_out):
        raise ValueError("dw_down: maps must be [8, B, N_coarse]")
    lists = _lists("dw_down", lists, "down", n_in, (child_idx, child_hit))
    out = _dw_launch(feats.contiguous(), g.contiguous(), lists)
    DW_DOWN.launches += 1
    return out


def dw_k3_map_plain(feats, g, nbr_idx, nbr_hit):
    """Plain twin of :func:`dw_k3_map`."""
    return _map_dw(feats, g, nbr_idx, nbr_hit)


def dw_k3_map(feats, g, nbr_idx, nbr_hit, lists=None):
    """Weight gradient of :func:`gather_gemm_k3_map`.

    ``dW[k] = sum_{b, i} nbr_hit[k, b, i] * feats[b, nbr_idx[k, b, i]]^T
    (x) g[b, i]``

    Args:
      feats: [B, N, Cin] f32/bf16 (the conv's input); g: [B, N, Cout] same
        dtype, the output cotangent masked by the level's validity.
      nbr_idx: int32 [27, B, N]; nbr_hit: bool [27, B, N].
      lists: the level's k3 ``HitLists`` ("k3map" or "sk") or None.
    Returns [27, Cin, Cout] f32.
    """
    if not _route(feats, g, nbr_idx, nbr_hit):
        return dw_k3_map_plain(feats, g, nbr_idx, nbr_hit)
    _check_dw("dw_k3_map", feats, g, ((nbr_idx, torch.int32),
                                      (nbr_hit, torch.bool)))
    b, n = feats.shape[:2]
    if (g.shape[1] != n or nbr_idx.shape != (27, b, n)
            or nbr_hit.shape != (27, b, n)):
        raise ValueError("dw_k3_map: g must be [B, N, Cout], tables "
                         "[27, B, N]")
    lists = _lists("dw_k3_map", lists, "k3map", n, (nbr_idx, nbr_hit),
                   _K3_KINDS)
    out = _dw_launch(feats.contiguous(), g.contiguous(), lists)
    DW_K3MAP.launches += 1
    return out


def dw_up_plain(feats, g, parent_idx, row_ok, octant):
    """Plain twin of :func:`dw_up`."""
    out = torch.zeros((8, feats.shape[-1], g.shape[-1]),
                      dtype=_wide(feats.dtype), device=feats.device)
    a = torch.where(row_ok[..., None],
                    _gather(feats.to(out.dtype), parent_idx), 0.0)
    gf = g.to(feats.dtype).to(out.dtype)
    for k in range(8):
        out[k] = _outer_sum(torch.where((octant == k)[..., None], a, 0.0), gf)
    return out


def dw_up(feats, g, parent_idx, row_ok, octant, lists=None):
    """Weight gradient of :func:`gather_gemm_up` (the broadcast-k map).

    ``dW[k] = sum_{b, c} row_ok[b, c] * [octant[b, c] == k]
    * feats[b, parent_idx[b, c]]^T (x) g[b, c]``

    Args:
      feats: [B, N_coarse, Cin] f32/bf16; g: [B, N_fine, Cout] same dtype,
        masked by the fine level's validity.
      parent_idx, octant: int32 [B, N_fine]; row_ok: bool [B, N_fine].
      lists: the parent map's ``HitLists`` ("up") or None (listed here).
    Returns [8, Cin, Cout] f32.
    """
    if not _route(feats, g, parent_idx, row_ok, octant):
        return dw_up_plain(feats, g, parent_idx, row_ok, octant)
    _check_dw("dw_up", feats, g, ((parent_idx, torch.int32),
                                  (row_ok, torch.bool), (octant, torch.int32)))
    b, n_in = feats.shape[:2]
    n_out = g.shape[1]
    if (parent_idx.shape != (b, n_out) or row_ok.shape != (b, n_out)
            or octant.shape != (b, n_out)):
        raise ValueError("dw_up: maps must be [B, N_fine]")
    lists = _lists("dw_up", lists, "up", n_in, (parent_idx, row_ok, octant))
    out = _dw_launch(feats.contiguous(), g.contiguous(), lists)
    DW_UP.launches += 1
    return out


# ------------------------------------------------ differentiable convs
#
# The backward passes of the JAX custom VJPs (conv_pallas.py:1201-1215,
# 1865-1884), g masked by the output level first:
#   k3:   dfeats = sk (or table) conv of g with W[26 - k]^T over the same
#         level (and tables);
#   down: dfeats = up conv of g with W^T over the fine level's parent map;
#   up:   dfeats = down conv of g with W^T over the coarse level's child map;
#   dW from the dW kernels.  Both rest on the child map pointing back at c
#   at (oct(c), parent(c)) exactly where row_ok(c) = valid(c) & parent_ok(c),
#   which build_hierarchy's scatter guarantees.
# Each Function takes the hit lists of the maps it reads (None: each
# reader lists its map), so that a forward conv, its data cotangent and its
# dW read one listing of each map.

def _masked(g, valid, dtype):
    return torch.where(valid[..., None], g, 0.0).to(dtype)


class SkConvFn(torch.autograd.Function):
    """:func:`gather_gemm_sk` with the self-keyed conv's VJP.
    ``apply(feats, weights, key, kbits, valid, order=None, lists=None)``:
    the data cotangent runs over the same k3 order (the same hits), the dW
    over ``lists``, the level's k3 ``HitLists``."""

    @staticmethod
    def forward(ctx, feats, weights, key, kbits, valid, order=None,
                lists=None):
        ctx.save_for_backward(feats, weights, key, kbits, valid)
        ctx.order, ctx.lists = order, lists
        return gather_gemm_sk(feats, weights, key, kbits, order)

    @staticmethod
    def backward(ctx, g):
        feats, weights, key, kbits, valid = ctx.saved_tensors
        g_m = _masked(g, valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_sk(g_m, weights.flip(0).transpose(1, 2),
                                    key, kbits, ctx.order)
        if ctx.needs_input_grad[1]:
            dw = dw_sk(feats, g_m, key, kbits, ctx.lists).to(weights.dtype)
        return dfeats, dw, None, None, None, None, None


class K3MapConvFn(torch.autograd.Function):
    """:func:`gather_gemm_k3_map` with the table conv's VJP (the k3 mode of
    ``pallas_conv_op``).  ``apply(feats, weights, nbr_idx, nbr_hit,
    valid, order=None, lists=None)``.  The data cotangent runs the same
    tables: they are symmetric (``nbr(i, k) = j`` with a hit iff
    ``nbr(j, 26 - k) = i`` with a hit, the ``kbits`` gate holding both
    ways), and so does the k3 order; the dW runs over ``lists``."""

    @staticmethod
    def forward(ctx, feats, weights, nbr_idx, nbr_hit, valid, order=None,
                lists=None):
        ctx.save_for_backward(feats, weights, nbr_idx, nbr_hit, valid)
        ctx.order, ctx.lists = order, lists
        return gather_gemm_k3_map(feats, weights, nbr_idx, nbr_hit, order)

    @staticmethod
    def backward(ctx, g):
        feats, weights, nbr_idx, nbr_hit, valid = ctx.saved_tensors
        g_m = _masked(g, valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_k3_map(g_m, weights.flip(0).transpose(1, 2),
                                        nbr_idx, nbr_hit, ctx.order)
        if ctx.needs_input_grad[1]:
            dw = dw_k3_map(feats, g_m, nbr_idx, nbr_hit, ctx.lists).to(
                weights.dtype)
        return dfeats, dw, None, None, None, None, None


class DownConvFn(torch.autograd.Function):
    """:func:`gather_gemm_down` with its VJP.  ``apply(feats, weights,
    child_idx, child_hit, coarse_valid, parent_idx, row_ok, octant,
    child_lists=None, parent_lists=None)``: the coarse level's child map
    and validity, the fine level's parent map, and their ``HitLists``."""

    @staticmethod
    def forward(ctx, feats, weights, child_idx, child_hit, coarse_valid,
                parent_idx, row_ok, octant, child_lists=None,
                parent_lists=None):
        ctx.save_for_backward(feats, weights, child_idx, child_hit,
                              coarse_valid, parent_idx, row_ok, octant)
        ctx.lists = child_lists, parent_lists
        return gather_gemm_down(feats, weights, child_idx, child_hit,
                                child_lists)

    @staticmethod
    def backward(ctx, g):
        (feats, weights, child_idx, child_hit, coarse_valid, parent_idx,
         row_ok, octant) = ctx.saved_tensors
        child_lists, parent_lists = ctx.lists
        g_m = _masked(g, coarse_valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_up(g_m, weights.transpose(1, 2), parent_idx,
                                    row_ok, octant, parent_lists)
        if ctx.needs_input_grad[1]:
            dw = dw_down(feats, g_m, child_idx, child_hit, child_lists).to(
                weights.dtype)
        return (dfeats, dw) + (None,) * 8


class UpConvFn(torch.autograd.Function):
    """:func:`gather_gemm_up` with its VJP.  ``apply(feats, weights,
    parent_idx, row_ok, octant, fine_valid, child_idx, child_hit,
    parent_lists=None, child_lists=None)``: the fine level's parent map and
    validity, the coarse level's child map, and their ``HitLists``."""

    @staticmethod
    def forward(ctx, feats, weights, parent_idx, row_ok, octant, fine_valid,
                child_idx, child_hit, parent_lists=None, child_lists=None):
        ctx.save_for_backward(feats, weights, parent_idx, row_ok, octant,
                              fine_valid, child_idx, child_hit)
        ctx.lists = parent_lists, child_lists
        return gather_gemm_up(feats, weights, parent_idx, row_ok, octant,
                              parent_lists)

    @staticmethod
    def backward(ctx, g):
        (feats, weights, parent_idx, row_ok, octant, fine_valid, child_idx,
         child_hit) = ctx.saved_tensors
        parent_lists, child_lists = ctx.lists
        g_m = _masked(g, fine_valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_down(g_m, weights.transpose(1, 2), child_idx,
                                      child_hit, child_lists)
        if ctx.needs_input_grad[1]:
            dw = dw_up(feats, g_m, parent_idx, row_ok, octant,
                       parent_lists).to(weights.dtype)
        return (dfeats, dw) + (None,) * 8
