"""K2 and K3 — gather-GEMM sparse convolutions and their plain twins.

K2 (``csrc/conv_sk.cu``) replaces ``conv_pallas._gather_gemm_call_sk``: the
self-keyed k=3 s=1 conv that resolves neighbours from the level's sorted
keys and per-row validity bitmap, with no neighbour tables.

K3 (``csrc/conv_map.cu``) replaces ``conv_pallas._gather_gemm_call`` in its
k2-down and broadcast-k up modes, convs over the explicit stride-2 maps
that ``build_hierarchy`` scatters, and in its k3-table mode
(:func:`gather_gemm_k3_map`), the k=3 s=1 conv over the rank kernel's
neighbour tables; reading global memory at any N, it also stands in for
``conv_pallas._gather_gemm_call_hbm``.  The k3-table conv is inference
only (the trainer's levels stay self-keyed).

The weight gradients: ``csrc/conv_dw_sk.cu`` (:func:`dw_sk`) replaces
``conv_pallas._dw_call_sk`` and ``csrc/conv_dw_map.cu`` (:func:`dw_down`,
:func:`dw_up`) replaces ``conv_pallas._dw_call``.  The autograd Functions
:class:`SkConvFn`, :class:`DownConvFn` and :class:`UpConvFn` carry the JAX
custom VJPs (``pallas_conv_sk_op``, ``pallas_conv_op``): data cotangents
through the forward kernels over the reverse maps, weight cotangents
through the dW kernels.

Each wrapper launches its kernel for CUDA tensors (f32 or bf16 features,
weights / gradients of the same dtype, f32 accumulation) and runs its plain
twin for CPU tensors.  The plain twins are the JAX ``"xla"`` formulation
(``mrcc_tpu/sparse/conv.py:60-96``): a loop over offsets of gather ->
mask -> matmul with f32 accumulation, cast back to the feature dtype (dW
stays f32).  Bias stays outside (``sparse/conv.py``).
"""

from __future__ import annotations

import torch

from ..sparse.hierarchy import K3_DELTAS as _K3_DELTAS
from .build import I, KernelLibrary, LaunchCounter, P, ptr, stream_ptr

# The k3 data cotangent is the same self-keyed conv with W[26 - k]^T: a hit
# (i, k) exists iff the hit (i + delta_k, 26 - k) does.
if any(_K3_DELTAS[26 - k] != -d for k, d in enumerate(_K3_DELTAS)):
    raise AssertionError("K3_OFFSETS lost the negated-delta symmetry")

SK_LIB = KernelLibrary("conv_sk", {
    "mrcc_conv_sk_f32": (P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_sk_bf16": (P, P, P, P, P, I, I, I, I, P),
})
MAP_LIB = KernelLibrary("conv_map", {
    "mrcc_conv_down_f32": (P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_down_bf16": (P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_up_f32": (P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_up_bf16": (P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_k3map_f32": (P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_k3map_bf16": (P, P, P, P, P, I, I, I, I, P),
})
DW_SK_LIB = KernelLibrary("conv_dw_sk", {
    "mrcc_dw_sk_f32": (P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_dw_sk_bf16": (P, P, P, P, P, P, I, I, I, I, I, P),
})
DW_MAP_LIB = KernelLibrary("conv_dw_map", {
    "mrcc_dw_down_f32": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_dw_down_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_dw_up_f32": (P, P, P, P, P, P, P, I, I, I, I, I, I, P),
    "mrcc_dw_up_bf16": (P, P, P, P, P, P, P, I, I, I, I, I, I, P),
})
LIBRARIES = (SK_LIB, MAP_LIB, DW_SK_LIB, DW_MAP_LIB)
SK = LaunchCounter("conv_sk")
DOWN = LaunchCounter("conv_down")
UP = LaunchCounter("conv_up")
K3MAP = LaunchCounter("conv_k3map")
DW_SK = LaunchCounter("dw_sk")
DW_DOWN = LaunchCounter("dw_down")
DW_UP = LaunchCounter("dw_up")

_DW_TILE = 64           # DW_TILE of csrc/dw_gemm.cuh
_DW_TARGET_CTAS = 1056  # 8 CTAs per SM of an H100 (132 SMs)
_DW_MIN_ROWS = 2048     # rows of one slice at least

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _route(*tensors) -> bool:
    """True: launch the kernel (CUDA); False: plain twin (CPU); else raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"conv inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"conv: unsupported device {dev}")
    return True


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


def _dw_slices(k, cin, cout, rows):
    """Row slices of a dW launch: enough CTAs to fill the card, at least
    ``_DW_MIN_ROWS`` rows each."""
    tiles = -(-cin // _DW_TILE) * -(-cout // _DW_TILE)
    return max(1, min(-(-_DW_TARGET_CTAS // (k * tiles)),
                      -(-rows // _DW_MIN_ROWS)))


def _dw_buffers(k, cin, cout, rows, device):
    """``(slices, partial scratch or None, dW output)`` of one dW
    launch."""
    slices = _dw_slices(k, cin, cout, rows)
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=device)
    part = (torch.empty((slices, k, cin, cout), dtype=torch.float32,
                        device=device) if slices > 1 else None)
    return slices, part, out


def _gather(f, idx):
    """f [B, N, C], idx [B, M] -> [B, M, C]."""
    return f.gather(1, idx.long()[..., None].expand(-1, -1, f.shape[-1]))


def _outer_sum(a, g):
    """sum over rows of a [B, M, Cin]^T (x) g [B, M, Cout] -> [Cin, Cout]."""
    return a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])


def _sk_neighbours(key, kbits, k, d):
    """(row index, hit) of offset k for every row: searchsorted in the
    sorted key row, gated by the offset bit."""
    q = key + d
    idx = torch.searchsorted(key, q).clamp_max(key.shape[1] - 1)
    hit = (((kbits >> k) & 1) != 0) & (key.gather(1, idx) == q)
    return idx, hit


# ------------------------------------------------------------------- K2

def gather_gemm_sk_plain(feats, weights, key, kbits):
    """Plain twin of :func:`gather_gemm_sk` (searchsorted neighbour maps)."""
    b, n, _ = feats.shape
    out = torch.zeros((b, n, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    if n == 0:
        return out.to(feats.dtype)
    f = feats.float()
    w = weights.to(feats.dtype).float()
    key = key.contiguous()
    for k, d in enumerate(_K3_DELTAS):
        idx, hit = _sk_neighbours(key, kbits, k, d)
        g = torch.where(hit[..., None], _gather(f, idx), 0.0)
        out = out + g @ w[k]
    return out.to(feats.dtype)


def gather_gemm_sk(feats, weights, key, kbits):
    """Self-keyed k=3 s=1 conv.

    ``out[b, i] = sum_k bit_k(kbits[b, i]) * feats[b, j] @ W[k]`` with
    ``key[b, j] == key[b, i] + delta_k``.

    Args:
      feats: [B, N, Cin] f32/bf16; weights: [27, Cin, Cout] same dtype.
      key: int32 [B, N] sorted per item (KEY_PAD padding).
      kbits: int32 [B, N] per-row offset validity bitmap (0 at padding).
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
    key, kbits = key.contiguous(), kbits.contiguous()
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    SK_LIB.call(f"mrcc_conv_sk_{_SUFFIX[feats.dtype]}", ptr(feats),
                ptr(weights), ptr(key), ptr(kbits), ptr(out), b, n, cin, cout,
                stream_ptr(feats))
    SK.launches += 1
    return out


# ------------------------------------------------------------------- K3

def _map_conv(feats, weights, map_idx, map_hit):
    """``sum_k map_hit[k] * feats[map_idx[k]] @ W[k]`` in f32, cast back."""
    b = feats.shape[0]
    n_out = map_idx.shape[2]
    f = feats.float()
    w = weights.to(feats.dtype).float()
    out = torch.zeros((b, n_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for k in range(weights.shape[0]):
        g = torch.where(map_hit[k][..., None], _gather(f, map_idx[k]), 0.0)
        out = out + g @ w[k]
    return out.to(feats.dtype)


def gather_gemm_down_plain(feats, weights, child_idx, child_hit):
    """Plain twin of :func:`gather_gemm_down`."""
    return _map_conv(feats, weights, child_idx, child_hit)


def gather_gemm_down(feats, weights, child_idx, child_hit):
    """k=2 s=2 down conv over the 8-child map.

    ``out[b, p] = sum_k child_hit[k, b, p] * feats[b, child_idx[k, b, p]] @ W[k]``

    Args:
      feats: [B, N_fine, Cin]; weights: [8, Cin, Cout] same dtype.
      child_idx: int32 [8, B, N_coarse]; child_hit: bool [8, B, N_coarse].
    Returns [B, N_coarse, Cout].
    """
    if not _route(feats, weights, child_idx, child_hit):
        return gather_gemm_down_plain(feats, weights, child_idx, child_hit)
    _check("gather_gemm_down", feats, weights, 8,
           ((child_idx, torch.int32), (child_hit, torch.bool)))
    b, n_in, cin = feats.shape
    cout = weights.shape[-1]
    n_out = child_idx.shape[2]
    if child_idx.shape != (8, b, n_out) or child_hit.shape != (8, b, n_out):
        raise ValueError("gather_gemm_down: maps must be [8, B, N_coarse]")
    feats, weights = feats.contiguous(), weights.contiguous()
    child_idx, child_hit = child_idx.contiguous(), child_hit.contiguous()
    out = torch.empty((b, n_out, cout), dtype=feats.dtype, device=feats.device)
    MAP_LIB.call(f"mrcc_conv_down_{_SUFFIX[feats.dtype]}", ptr(feats),
                 ptr(weights), ptr(child_idx), ptr(child_hit), ptr(out), b,
                 n_in, n_out, cin, cout, stream_ptr(feats))
    DOWN.launches += 1
    return out


def gather_gemm_k3_map_plain(feats, weights, nbr_idx, nbr_hit):
    """Plain twin of :func:`gather_gemm_k3_map` (the JAX ``"xla"``
    ``conv_kernel_map``)."""
    return _map_conv(feats, weights, nbr_idx, nbr_hit)


def gather_gemm_k3_map(feats, weights, nbr_idx, nbr_hit):
    """k=3 s=1 conv over a level's neighbour tables (inference).

    ``out[b, i] = sum_k nbr_hit[k, b, i] * feats[b, nbr_idx[k, b, i]] @ W[k]``

    Args:
      feats: [B, N, Cin] f32/bf16; weights: [27, Cin, Cout] same dtype.
      nbr_idx: int32 [27, B, N]; nbr_hit: bool [27, B, N]
        (``sparse.hierarchy.neighbor_tables``).
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
    nbr_idx, nbr_hit = nbr_idx.contiguous(), nbr_hit.contiguous()
    out = torch.empty((b, n, cout), dtype=feats.dtype, device=feats.device)
    MAP_LIB.call(f"mrcc_conv_k3map_{_SUFFIX[feats.dtype]}", ptr(feats),
                 ptr(weights), ptr(nbr_idx), ptr(nbr_hit), ptr(out), b, n,
                 feats.shape[-1], cout, stream_ptr(feats))
    K3MAP.launches += 1
    return out


def gather_gemm_up_plain(feats, weights, parent_idx, row_ok, octant):
    """Plain twin of :func:`gather_gemm_up` (eight octant-masked products,
    as ``mrcc_tpu/sparse/conv.py:258-277``)."""
    f = feats.float()
    w = weights.to(feats.dtype).float()
    g = torch.where(row_ok[..., None], _gather(f, parent_idx), 0.0)
    out = torch.zeros(g.shape[:2] + (weights.shape[-1],), dtype=torch.float32,
                      device=feats.device)
    for k in range(weights.shape[0]):
        out = out + torch.where((octant == k)[..., None], g @ w[k], 0.0)
    return out.to(feats.dtype)


def gather_gemm_up(feats, weights, parent_idx, row_ok, octant):
    """k=2 s=2 transpose conv: one parent gather per output row.

    ``out[b, c] = row_ok[b, c] * feats[b, parent_idx[b, c]] @ W[octant[b, c]]``

    Args:
      feats: [B, N_coarse, Cin]; weights: [8, Cin, Cout] same dtype.
      parent_idx, octant: int32 [B, N_fine]; row_ok: bool [B, N_fine]
        (valid & parent_ok — overflowed parents alias slot capacity-1).
    Returns [B, N_fine, Cout].
    """
    if not _route(feats, weights, parent_idx, row_ok, octant):
        return gather_gemm_up_plain(feats, weights, parent_idx, row_ok, octant)
    _check("gather_gemm_up", feats, weights, 8,
           ((parent_idx, torch.int32), (row_ok, torch.bool),
            (octant, torch.int32)))
    b, n_in, cin = feats.shape
    cout = weights.shape[-1]
    n_out = parent_idx.shape[1]
    if (parent_idx.shape != (b, n_out) or row_ok.shape != (b, n_out)
            or octant.shape != (b, n_out)):
        raise ValueError("gather_gemm_up: maps must be [B, N_fine]")
    feats, weights = feats.contiguous(), weights.contiguous()
    parent_idx, row_ok = parent_idx.contiguous(), row_ok.contiguous()
    octant = octant.contiguous()
    out = torch.empty((b, n_out, cout), dtype=feats.dtype, device=feats.device)
    MAP_LIB.call(f"mrcc_conv_up_{_SUFFIX[feats.dtype]}", ptr(feats),
                 ptr(weights), ptr(parent_idx), ptr(row_ok), ptr(octant),
                 ptr(out), b, n_in, n_out, cin, cout, stream_ptr(feats))
    UP.launches += 1
    return out


# ------------------------------------------------------ dW of K2 and K3

def dw_sk_plain(feats, g, key, kbits):
    """Plain twin of :func:`dw_sk`."""
    cin, cout = feats.shape[-1], g.shape[-1]
    out = torch.zeros((27, cin, cout), dtype=torch.float32,
                      device=feats.device)
    if feats.shape[1] == 0:
        return out
    f = feats.float()
    gf = g.to(feats.dtype).float()
    key = key.contiguous()
    for k, d in enumerate(_K3_DELTAS):
        idx, hit = _sk_neighbours(key, kbits, k, d)
        out[k] = _outer_sum(torch.where(hit[..., None], _gather(f, idx), 0.0),
                            gf)
    return out


def dw_sk(feats, g, key, kbits):
    """Weight gradient of :func:`gather_gemm_sk`.

    ``dW[k] = sum_{b, i} bit_k(kbits[b, i]) * feats[b, j]^T (x) g[b, i]``
    with ``key[b, j] == key[b, i] + delta_k``.

    Args:
      feats: [B, N, Cin] f32/bf16 (the conv's input); g: [B, N, Cout] same
        dtype, the output cotangent masked by the level's validity.
      key, kbits: int32 [B, N] as for :func:`gather_gemm_sk`.
    Returns [27, Cin, Cout] f32.
    """
    if not _route(feats, g, key, kbits):
        return dw_sk_plain(feats, g, key, kbits)
    _check_dw("dw_sk", feats, g, ((key, torch.int32), (kbits, torch.int32)))
    b, n, cin = feats.shape
    cout = g.shape[-1]
    if g.shape[1] != n or key.shape != (b, n) or kbits.shape != (b, n):
        raise ValueError("dw_sk: g must be [B, N, Cout], key/kbits [B, N]")
    feats, g = feats.contiguous(), g.contiguous()
    key, kbits = key.contiguous(), kbits.contiguous()
    slices, part, out = _dw_buffers(27, cin, cout, b * n, feats.device)
    DW_SK_LIB.call(f"mrcc_dw_sk_{_SUFFIX[feats.dtype]}", ptr(feats), ptr(g),
                   ptr(key), ptr(kbits), ptr(part), ptr(out), b, n, cin, cout,
                   slices, stream_ptr(feats))
    DW_SK.launches += 1
    return out


def dw_down_plain(feats, g, child_idx, child_hit):
    """Plain twin of :func:`dw_down`."""
    k_taps = child_idx.shape[0]
    out = torch.zeros((k_taps, feats.shape[-1], g.shape[-1]),
                      dtype=torch.float32, device=feats.device)
    f = feats.float()
    gf = g.to(feats.dtype).float()
    for k in range(k_taps):
        out[k] = _outer_sum(torch.where(child_hit[k][..., None],
                                        _gather(f, child_idx[k]), 0.0), gf)
    return out


def dw_down(feats, g, child_idx, child_hit):
    """Weight gradient of :func:`gather_gemm_down`.

    ``dW[k] = sum_{b, p} child_hit[k, b, p] * feats[b, child_idx[k, b, p]]^T
    (x) g[b, p]``

    Args:
      feats: [B, N_fine, Cin] f32/bf16; g: [B, N_coarse, Cout] same dtype,
        masked by the coarse level's validity.
      child_idx: int32 [8, B, N_coarse]; child_hit: bool [8, B, N_coarse].
    Returns [8, Cin, Cout] f32.
    """
    if not _route(feats, g, child_idx, child_hit):
        return dw_down_plain(feats, g, child_idx, child_hit)
    _check_dw("dw_down", feats, g, ((child_idx, torch.int32),
                                    (child_hit, torch.bool)))
    b, n_in, cin = feats.shape
    n_out, cout = g.shape[1], g.shape[2]
    if child_idx.shape != (8, b, n_out) or child_hit.shape != (8, b, n_out):
        raise ValueError("dw_down: maps must be [8, B, N_coarse]")
    feats, g = feats.contiguous(), g.contiguous()
    child_idx, child_hit = child_idx.contiguous(), child_hit.contiguous()
    slices, part, out = _dw_buffers(8, cin, cout, b * n_out, feats.device)
    DW_MAP_LIB.call(f"mrcc_dw_down_{_SUFFIX[feats.dtype]}", ptr(feats), ptr(g),
                    ptr(child_idx), ptr(child_hit), ptr(part), ptr(out), b,
                    n_in, n_out, cin, cout, slices, stream_ptr(feats))
    DW_DOWN.launches += 1
    return out


def dw_up_plain(feats, g, parent_idx, row_ok, octant):
    """Plain twin of :func:`dw_up`."""
    out = torch.zeros((8, feats.shape[-1], g.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    a = torch.where(row_ok[..., None], _gather(feats.float(), parent_idx), 0.0)
    gf = g.to(feats.dtype).float()
    for k in range(8):
        out[k] = _outer_sum(torch.where((octant == k)[..., None], a, 0.0), gf)
    return out


def dw_up(feats, g, parent_idx, row_ok, octant):
    """Weight gradient of :func:`gather_gemm_up` (the broadcast-k map).

    ``dW[k] = sum_{b, c} row_ok[b, c] * [octant[b, c] == k]
    * feats[b, parent_idx[b, c]]^T (x) g[b, c]``

    Args:
      feats: [B, N_coarse, Cin] f32/bf16; g: [B, N_fine, Cout] same dtype,
        masked by the fine level's validity.
      parent_idx, octant: int32 [B, N_fine]; row_ok: bool [B, N_fine].
    Returns [8, Cin, Cout] f32.
    """
    if not _route(feats, g, parent_idx, row_ok, octant):
        return dw_up_plain(feats, g, parent_idx, row_ok, octant)
    _check_dw("dw_up", feats, g, ((parent_idx, torch.int32),
                                  (row_ok, torch.bool), (octant, torch.int32)))
    b, n_in, cin = feats.shape
    n_out, cout = g.shape[1], g.shape[2]
    if (parent_idx.shape != (b, n_out) or row_ok.shape != (b, n_out)
            or octant.shape != (b, n_out)):
        raise ValueError("dw_up: maps must be [B, N_fine]")
    feats, g = feats.contiguous(), g.contiguous()
    parent_idx, row_ok = parent_idx.contiguous(), row_ok.contiguous()
    octant = octant.contiguous()
    slices, part, out = _dw_buffers(8, cin, cout, b * n_out, feats.device)
    DW_MAP_LIB.call(f"mrcc_dw_up_{_SUFFIX[feats.dtype]}", ptr(feats), ptr(g),
                    ptr(parent_idx), ptr(row_ok), ptr(octant), ptr(part),
                    ptr(out), b, n_in, n_out, cin, cout, slices,
                    stream_ptr(feats))
    DW_UP.launches += 1
    return out


# ------------------------------------------------ differentiable convs
#
# The backward passes of the JAX custom VJPs (conv_pallas.py:1201-1215,
# 1865-1884), g masked by the output level first:
#   k3:   dfeats = sk conv of g with W[26 - k]^T over the same level;
#   down: dfeats = up conv of g with W^T over the fine level's parent map;
#   up:   dfeats = down conv of g with W^T over the coarse level's child map;
#   dW from the dW kernels.  Both rest on the child map pointing back at c
#   at (oct(c), parent(c)) exactly where row_ok(c) = valid(c) & parent_ok(c),
#   which build_hierarchy's scatter guarantees.

def _masked(g, valid, dtype):
    return torch.where(valid[..., None], g, 0.0).to(dtype)


class SkConvFn(torch.autograd.Function):
    """:func:`gather_gemm_sk` with the self-keyed conv's VJP.
    ``apply(feats, weights, key, kbits, valid)``."""

    @staticmethod
    def forward(ctx, feats, weights, key, kbits, valid):
        ctx.save_for_backward(feats, weights, key, kbits, valid)
        return gather_gemm_sk(feats, weights, key, kbits)

    @staticmethod
    def backward(ctx, g):
        feats, weights, key, kbits, valid = ctx.saved_tensors
        g_m = _masked(g, valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_sk(g_m, weights.flip(0).transpose(1, 2),
                                    key, kbits)
        if ctx.needs_input_grad[1]:
            dw = dw_sk(feats, g_m, key, kbits).to(weights.dtype)
        return dfeats, dw, None, None, None


class DownConvFn(torch.autograd.Function):
    """:func:`gather_gemm_down` with its VJP.  ``apply(feats, weights,
    child_idx, child_hit, coarse_valid, parent_idx, row_ok, octant)``: the
    coarse level's child map and validity, the fine level's parent map."""

    @staticmethod
    def forward(ctx, feats, weights, child_idx, child_hit, coarse_valid,
                parent_idx, row_ok, octant):
        ctx.save_for_backward(feats, weights, child_idx, child_hit,
                              coarse_valid, parent_idx, row_ok, octant)
        return gather_gemm_down(feats, weights, child_idx, child_hit)

    @staticmethod
    def backward(ctx, g):
        (feats, weights, child_idx, child_hit, coarse_valid, parent_idx,
         row_ok, octant) = ctx.saved_tensors
        g_m = _masked(g, coarse_valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_up(g_m, weights.transpose(1, 2), parent_idx,
                                    row_ok, octant)
        if ctx.needs_input_grad[1]:
            dw = dw_down(feats, g_m, child_idx, child_hit).to(weights.dtype)
        return dfeats, dw, None, None, None, None, None, None


class UpConvFn(torch.autograd.Function):
    """:func:`gather_gemm_up` with its VJP.  ``apply(feats, weights,
    parent_idx, row_ok, octant, fine_valid, child_idx, child_hit)``: the
    fine level's parent map and validity, the coarse level's child map."""

    @staticmethod
    def forward(ctx, feats, weights, parent_idx, row_ok, octant, fine_valid,
                child_idx, child_hit):
        ctx.save_for_backward(feats, weights, parent_idx, row_ok, octant,
                              fine_valid, child_idx, child_hit)
        return gather_gemm_up(feats, weights, parent_idx, row_ok, octant)

    @staticmethod
    def backward(ctx, g):
        (feats, weights, parent_idx, row_ok, octant, fine_valid, child_idx,
         child_hit) = ctx.saved_tensors
        g_m = _masked(g, fine_valid, feats.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = gather_gemm_down(g_m, weights.transpose(1, 2), child_idx,
                                      child_hit)
        if ctx.needs_input_grad[1]:
            dw = dw_up(feats, g_m, parent_idx, row_ok, octant).to(
                weights.dtype)
        return dfeats, dw, None, None, None, None, None, None
