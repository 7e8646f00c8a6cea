"""The int8 convs' operands and their down / up decomposition, on the CPU:
the plain twins of what the card runs (``ops.conv_q8``).

- Operands: the quantisation pass's plain twin in the kernels' layout
  (``quantize_operands_plain``: q [B, N, cpad], wq [K, Cout, cpad], zeros
  past Cin) equals ``_quantize``'s ``(q, wq, m)`` after un-layout, bit for
  bit, in every mode (k3, k3 table, down, up with octant scales, the
  768 + 128 split, the 64- and 32-channel lane-packed up groups), with a
  calibrated and with the dynamic absmax.
- Decomposition: per-octant lists, each group's exact int32 products of
  the listed rows (``list_gemm_q8_plain``), then the down conv's int32
  child sum (``child_sum_q8_plain``) or the up conv's dequantisation with
  the octants' scales, the groups added in the feature dtype in group
  order.  It equals the JAX package's ``gather_gemm_conv_tiled_q8`` (down;
  up with ``bcast_k``) under ``jax.jit``, as ``tests/test_torch_q8.py``
  runs it, exactly (0 ulp) on the valid rows, and the port's plain conv
  twins exactly on every row; the overflow case has children of
  overflowed parents (``row_ok`` false).
- Padding: a level whose rows are all padding gives zeros.

Clouds: ``tests/test_torch_conv.py``'s border, overflow and scattered
cases, B = 2, bf16 features.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.ops import conv_pallas as CP
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.hierarchy import _up_tiled_maps
from mrcc_tpu_torch.ops import conv
from mrcc_tpu_torch.ops import conv_q8 as Q
from mrcc_tpu_torch.sparse import build_hierarchy
from mrcc_tpu_torch.sparse.types import SparseVoxels
from test_torch_conv import CASES, _points, _t
from test_torch_conv import Q as VOXEL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: under the suite's
    parallel workers torch's default of a thread a core oversubscribes the
    CPU (one small engine call took 185 s at six-way contention on an
    8-core CPU, 1.8 s at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["border", "overflow", "scattered"])
def case(request):
    cloud, cin, cout, cap, caps = CASES[request.param]
    rng = np.random.default_rng(len(request.param) + 23)
    clouds = [_points(cloud, rng) for _ in range(2)]
    n_min = min(700, *(len(c) for c in clouds))
    pts = np.stack([c[:n_min] for c in clouds])
    rgb = rng.random(pts.shape).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), VOXEL, cap)
    lv_j = jax.jit(partial(jax_build_hierarchy, depth=4,
                           capacities=caps))(vox_j)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox_j.off), key=_t(vox_j.key), feats=_t(vox_j.feats),
        valid=_t(vox_j.valid), count=_t(vox_j.count)), 4, capacities=caps)
    return dict(name=request.param, cin=cin, cout=cout, lv_j=lv_j, lv=lv,
                rng=rng)


def _feats(level, c, rng):
    x = rng.normal(size=level.valid.shape + (c,)).astype(np.float32)
    x = np.where(np.asarray(level.valid)[..., None], x, 0.0)
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _weights(k, cin, cout, rng, octant_scales=False):
    w = rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)
    if octant_scales:  # octants whose weights differ in scale by up to 8x
        w = w * (1.0 + np.arange(k))[:, None, None]
    return torch.from_numpy(w.astype(np.float32))


def _unlayout(ops):
    cin = ops.groups[-1][1]
    return ops.q[..., :cin], ops.wq[..., :cin].transpose(1, 2)


# ------------------------------------------------------------- operands

OPERAND_MODES = {
    # name: (mode, table rows, Cin, Cout, per octant, table budget or None)
    "k3_stem": ("k3", 512, 3, 32, False, None),
    "k3_two_groups": ("k3", 512, 256, 40, False, None),
    "k3_table_256_128": ("k3_table", 512, 384, 24, False, None),
    "down_768_128": ("down", 512, 896, 16, False, None),
    "up_octants": ("up", 256, 130, 70, True, None),
    "up_packed_64": ("up", 256, 160, 40, True, 256 * 64),
    "up_packed_32": ("up", 512, 80, 24, True, 512 * 32),
}


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("name", sorted(OPERAND_MODES))
def test_operands_equal_quantize_after_unlayout(name, calibrated,
                                                monkeypatch):
    mode, n, cin, cout, octant, budget = OPERAND_MODES[name]
    if budget is not None:
        monkeypatch.setattr(Q, "_TABLE_BUDGET", budget)
    groups = Q.q8_channel_groups(mode, n, cin)
    want_groups = {"k3_two_groups": 2, "k3_table_256_128": 2,
                   "down_768_128": 2, "up_packed_64": 3,
                   "up_packed_32": 3}.get(name, 1)
    assert len(groups) == want_groups, groups
    rng = np.random.default_rng(cin + cout)
    f = torch.from_numpy(rng.normal(size=(2, n, cin)).astype(
        np.float32)).bfloat16()
    f[:, n - 7:] = 0  # padding rows
    w = _weights(8 if mode in ("down", "up") else 27, cin, cout, rng,
                 octant_scales=octant)
    amax = (f.float().abs().amax(dim=(0, 1)) * 0.75 if calibrated
            else None)
    ops = Q.quantize_operands_plain(mode, f, w, n, amax, per_octant=octant)
    # the card route's own entry takes the twin on the CPU
    again = Q.quantize_operands(mode, f, w, n, amax, per_octant=octant)
    assert all(torch.equal(a, b) for a, b in zip(ops[:3], again[:3]))
    cpad = -(-cin // 16) * 16
    assert ops.cpad == cpad and ops.q.shape == (2, n, cpad)
    assert ops.wq.shape == (w.shape[0], cout, cpad)
    assert ops.q.dtype == ops.wq.dtype == torch.int8
    assert ops.q.is_contiguous() and ops.wq.is_contiguous()
    assert not ops.q[..., cin:].any() and not ops.wq[..., cin:].any()
    gw = ops.gw
    assert gw % 16 == 0
    assert len(groups) == 1 or all(a == i * gw for i, (a, _) in
                                   enumerate(groups))
    _, q, wq, m = Q._quantize(mode, f, w, n, amax, per_octant=octant)
    got_q, got_wq = _unlayout(ops)
    assert torch.equal(got_q, q) and torch.equal(got_wq, wq)
    assert torch.equal(ops.m, m)
    assert ops.m.shape == ((len(groups), w.shape[0], cout) if octant
                           else (len(groups), cout))
    if calibrated:  # the calibrated absmax clips the largest activations
        assert int((q.abs() == 127).sum()) >= cin


# ---------------------------------------------------- down / up by stages

def _down(feats, w, coarse, act_absmax=None):
    """The down conv as the card runs it: the child map's lists, each group's
    int32 products of the listed fine rows, the int32 child sum."""
    b, n_in, _ = feats.shape
    ops = Q.quantize_operands_plain("down", feats, w, n_in, act_absmax)
    fidx, _, count = conv.dw_hit_lists_plain("down", n_in, coarse.child_idx,
                                             coarse.child_hit)
    y = Q.list_gemm_q8_plain(ops, fidx, fidx, count, b * n_in)
    return Q.child_sum_q8_plain(y.reshape(len(ops.groups), b, n_in, -1),
                                ops.m, coarse.child_idx, coarse.child_hit,
                                feats.dtype)


def _up(feats, w, fine, row_ok, act_absmax=None):
    """The up conv as the card runs it: the parent map's lists, each group's
    int32 products from the parent rows into the fine rows, dequantised with
    the row's octant's scales (rows no list names come out 0)."""
    b, n_out = fine.parent_idx.shape
    n_in = feats.shape[1]
    ops = Q.quantize_operands_plain("up", feats, w, n_in, act_absmax,
                                    per_octant=True)
    fidx, gidx, count = conv.dw_hit_lists_plain(
        "up", n_in, fine.parent_idx, row_ok, fine.octant)
    y = Q.list_gemm_q8_plain(ops, fidx, gidx, count, b * n_out)
    y = y.reshape(len(ops.groups), b, n_out, -1)
    octant = fine.octant.long()
    return Q._dequant_sum([(y[g], ops.m[g][octant])
                           for g in range(len(ops.groups))], feats.dtype)


def _jax(f, w, tiled, valid, amax, bcast_k):
    return np.asarray(jax.jit(partial(
        CP.gather_gemm_conv_tiled_q8, k=8, bcast_k=bcast_k))(
            jnp.asarray(f.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(w.numpy()), tiled, valid,
            act_absmax=None if amax is None else jnp.asarray(amax.numpy())
    ).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["down", "up"])
def test_decomposition_equals_jax_exactly(case, kind):
    """Dynamic absmax on the case's widths; a calibrated absmax (75 % of the
    dynamic one: clipped activations) at 896 channels, which split into
    768 + 128-channel groups."""
    lv, lv_j, rng = case["lv"], case["lv_j"], case["rng"]
    fine, coarse = lv[0], lv[1]
    fj, cj = lv_j[0], lv_j[1]
    for cin, cout, calibrated in ((case["cin"], case["cout"], False),
                                  (896, 12, True)):
        src = fine if kind == "down" else coarse
        f = _feats(src, cin, rng)
        w = _weights(8, cin, cout, rng, octant_scales=kind == "up")
        amax = (f.float().abs().amax(dim=(0, 1)) * 0.75 if calibrated
                else None)
        n_table = src.key.shape[1]
        assert len(Q.q8_channel_groups(kind, n_table, cin)) == (
            2 if cin == 896 else 1)
        if kind == "down":
            got = _down(f, w, coarse, amax)
            plain = Q.gather_gemm_down_q8_plain(f, w, coarse.child_idx,
                                                coarse.child_hit, amax)
            tiled = CP.build_tiled_maps(cj.child_idx, cj.child_hit,
                                        fj.key.shape[1])
            want = _jax(f, w, tiled, cj.valid, amax, False)
            valid = coarse.valid
        else:
            assert case["name"] != "overflow" or not bool(
                fine.row_ok[fine.valid].all())
            got = _up(f, w, fine, fine.row_ok, amax)
            plain = Q.gather_gemm_up_q8_plain(f, w, fine.parent_idx,
                                              fine.row_ok, fine.octant, amax)
            tiled = _up_tiled_maps(fj.parent_idx, fj.parent_ok, fj.octant,
                                   fj.valid, cj.key.shape[1])
            want = _jax(f, w, tiled, fj.valid, amax, True)
            valid = fine.valid
        assert got.dtype == torch.bfloat16 and got.shape == plain.shape
        assert torch.equal(got, plain)
        masked = torch.where(valid[..., None], got, 0.0).float().numpy()
        assert want.shape == masked.shape
        assert np.array_equal(masked, want), float(np.abs(masked - want).max())
        assert bool(got.float().abs().sum() > 0)


def test_padding_levels_give_zeros(case):
    lv, rng = case["lv"], case["rng"]
    cin, cout = case["cin"], case["cout"]
    fine, coarse = lv[0], lv[1]
    down_in = _feats(fine, cin, rng)
    up_in = _feats(coarse, cin, rng)
    w8 = _weights(8, cin, cout, rng)
    none = dataclasses.replace(coarse, child_hit=coarse.child_hit & False)
    assert not _down(down_in, w8, none).any()
    assert not Q.gather_gemm_down_q8_plain(down_in, w8, none.child_idx,
                                           none.child_hit).any()
    off = fine.row_ok & False
    assert not _up(up_in, w8, fine, off).any()
    assert not Q.gather_gemm_up_q8_plain(up_in, w8, fine.parent_idx, off,
                                         fine.octant).any()
    # the k3 convs: no row of a level of padding has a neighbour
    w27 = _weights(27, cin, cout, rng)
    zero = torch.zeros_like(fine.kbits)
    assert not Q.gather_gemm_sk_q8(down_in, w27, fine.key, zero).any()
    # and the rows the up lists leave out are 0 on a real level
    out = _up(up_in, w8, fine, fine.row_ok)
    assert not out[~fine.row_ok].any()
    assert bool(out[fine.row_ok].float().abs().sum(-1).gt(0).all())
