"""K2 and K3 — gather-GEMM sparse convolutions and their plain twins.

K2 (``csrc/conv_sk.cu``) replaces ``conv_pallas._gather_gemm_call_sk``: the
self-keyed k=3 s=1 conv that resolves neighbours from the level's sorted
keys and per-row validity bitmap, with no neighbour tables.

K3 (``csrc/conv_map.cu``) replaces ``conv_pallas._gather_gemm_call`` in its
k2-down and broadcast-k up modes: convs over the explicit stride-2 maps
that ``build_hierarchy`` scatters.

Each wrapper launches its kernel for CUDA tensors (f32 or bf16 features,
weights of the same dtype, f32 accumulation) and runs its plain twin for
CPU tensors.  The plain twins are the JAX ``"xla"`` formulation
(``mrcc_tpu/sparse/conv.py:60-96``): a loop over offsets of gather ->
mask -> matmul with f32 accumulation, cast back to the feature dtype.
Bias stays outside (``sparse/conv.py``).
"""

from __future__ import annotations

import torch

from ..sparse.hierarchy import K3_OFFSETS, pack_deltas
from .build import I, KernelLibrary, LaunchCounter, P, ptr, stream_ptr

_K3_DELTAS = tuple(int(d) for d in pack_deltas(K3_OFFSETS))

SK_LIB = KernelLibrary("conv_sk", {
    "mrcc_conv_sk_f32": (P, P, P, P, P, I, I, I, I, P),
    "mrcc_conv_sk_bf16": (P, P, P, P, P, I, I, I, I, P),
})
MAP_LIB = KernelLibrary("conv_map", {
    "mrcc_conv_down_f32": (P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_down_bf16": (P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_up_f32": (P, P, P, P, P, P, I, I, I, I, I, P),
    "mrcc_conv_up_bf16": (P, P, P, P, P, P, I, I, I, I, I, P),
})
SK = LaunchCounter("conv_sk")
DOWN = LaunchCounter("conv_down")
UP = LaunchCounter("conv_up")

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


def _check(name, feats, weights, k, index_tensors):
    if feats.dtype not in _SUFFIX:
        raise ValueError(f"{name}: feats dtype {feats.dtype} not in "
                         "(float32, bfloat16)")
    if weights.dtype != feats.dtype:
        raise ValueError(f"{name}: weights {weights.dtype} != feats "
                         f"{feats.dtype}")
    if feats.dim() != 3 or weights.dim() != 3 or weights.shape[0] != k \
            or weights.shape[1] != feats.shape[-1]:
        raise ValueError(f"{name}: feats {tuple(feats.shape)} / weights "
                         f"{tuple(weights.shape)} do not fit [B, N, Cin] / "
                         f"[{k}, Cin, Cout]")
    for t, dtype in index_tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: map dtype {t.dtype} != {dtype}")


def _gather(f, idx):
    """f [B, N, C], idx [B, M] -> [B, M, C]."""
    return f.gather(1, idx.long()[..., None].expand(-1, -1, f.shape[-1]))


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
        q = key + d
        idx = torch.searchsorted(key, q).clamp_max(n - 1)
        hit = (((kbits >> k) & 1) != 0) & (key.gather(1, idx) == q)
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

def gather_gemm_down_plain(feats, weights, child_idx, child_hit):
    """Plain twin of :func:`gather_gemm_down`."""
    b = feats.shape[0]
    n_out = child_idx.shape[2]
    f = feats.float()
    w = weights.to(feats.dtype).float()
    out = torch.zeros((b, n_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for k in range(weights.shape[0]):
        g = torch.where(child_hit[k][..., None], _gather(f, child_idx[k]), 0.0)
        out = out + g @ w[k]
    return out.to(feats.dtype)


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
