"""K3's down and up convs as a list GEMM over per-octant hit lists, on the
CPU: the plain twins of each stage (``ops.conv.list_gemm_plain``,
``child_sum_plain``, the lists of ``ops.hit_lists.hit_lists_plain``), which
the wrappers run for CPU tensors.

- The down lists over the coarse level's child map and the up lists over
  the fine level's parent map name the same (fine row, coarse row,
  octant) triples; each fine row with ``row_ok`` lies in exactly one list
  of each, and no other fine row in any.
- The decomposition (up: the list GEMM from the parent rows into the fine
  rows; down: the list GEMM of each fine row with its octant's weight
  slice, then the sum over each coarse row's children) equals the JAX
  package's ``conv_transpose_up`` / ``conv_down`` under
  ``sparse_impl("xla")``: f32 within 1e-5 in relative norm (summation
  order only), bf16 within 2e-2 (one rounding of the f32 sum).
- A level of padding rows (no hit) gives all-zero outputs, and the
  children of overflowed parents (``row_ok`` false) zero rows.

Clouds: ``tests/test_torch_conv.py``'s border, overflow and scattered
cases, B = 2.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import conv as JC
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu_torch.ops import conv, hit_lists
from mrcc_tpu_torch.sparse import build_hierarchy
from mrcc_tpu_torch.sparse.types import SparseVoxels
from test_torch_conv import CASES, Q, _points, _t


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


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", params=["border", "overflow", "scattered"])
def case(request):
    cloud, cin, cout, cap, caps = CASES[request.param]
    rng = np.random.default_rng(len(request.param) + 11)
    clouds = [_points(cloud, rng) for _ in range(2)]
    n_min = min(700, *(len(c) for c in clouds))
    pts = np.stack([c[:n_min] for c in clouds])
    rgb = rng.random(pts.shape).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), Q, cap)
    lv_j = jax.jit(partial(jax_build_hierarchy, depth=4,
                           capacities=caps))(vox_j)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox_j.off), key=_t(vox_j.key), feats=_t(vox_j.feats),
        valid=_t(vox_j.valid), count=_t(vox_j.count)), 4, capacities=caps)
    return dict(name=request.param, cin=cin, cout=cout, lv_j=lv_j, lv=lv,
                rng=rng)


def _down(feats, weights, coarse, dtype):
    """The down conv as the card runs it: the child map's lists, each fine
    row's product with its octant's slice (f32), the child sum."""
    b, n_in, _ = feats.shape
    fidx, _, count = hit_lists.hit_lists_plain(
        "down", n_in, coarse.child_idx, coarse.child_hit)
    y = conv.list_gemm_plain(feats, weights, fidx, fidx, count, b * n_in)
    return conv.child_sum_plain(y.reshape(b, n_in, -1), coarse.child_idx,
                                coarse.child_hit, dtype)


def _up(feats, weights, fine, row_ok, dtype):
    """The up conv as the card runs it: the parent map's lists, the list
    GEMM from the parents' rows into the fine rows."""
    b, n_out = fine.parent_idx.shape
    fidx, gidx, count = hit_lists.hit_lists_plain(
        "up", feats.shape[1], fine.parent_idx, row_ok, fine.octant)
    out = conv.list_gemm_plain(feats, weights, fidx, gidx, count, b * n_out)
    return out.reshape(b, n_out, -1).to(dtype)


def _feats(level, c, rng):
    x = rng.normal(size=level.valid.shape + (c,)).astype(np.float32)
    return np.where(np.asarray(level.valid)[..., None], x, 0.0
                    ).astype(np.float32)


def _rel(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_down_and_up_lists_name_the_same_triples(case, l):
    fine, coarse = case["lv"][l], case["lv"][l + 1]
    b, nf = fine.key.shape
    nc = coarse.key.shape[1]
    down = hit_lists.hit_lists_plain("down", nf, coarse.child_idx,
                                     coarse.child_hit)
    up = hit_lists.hit_lists_plain("up", nc, fine.parent_idx, fine.row_ok,
                                   fine.octant)
    triples = {}
    for name, (src, dst, count), fine_side in (("down", down, 0),
                                               ("up", up, 1)):
        rows = []
        for k, c in enumerate(count.tolist()):
            f = (src, dst)[fine_side][k, :c]
            cr = (src, dst)[1 - fine_side][k, :c]
            rows += zip(f.tolist(), cr.tolist(), [k] * c)
        triples[name] = rows
    assert triples["down"]
    assert sorted(triples["down"]) == sorted(triples["up"])
    listed = torch.tensor([t[0] for t in triples["up"]], dtype=torch.long)
    times = torch.bincount(listed, minlength=b * nf)
    assert torch.equal(times, fine.row_ok.reshape(-1).long())
    # the coarse row of a triple is the fine row's parent, its octant the
    # fine row's octant
    fr = listed
    cr = torch.tensor([t[1] for t in triples["up"]], dtype=torch.long)
    k = torch.tensor([t[2] for t in triples["up"]], dtype=torch.long)
    assert torch.equal(cr, (fr // nf) * nc + fine.parent_idx.reshape(-1)[fr])
    assert torch.equal(k, fine.octant.reshape(-1)[fr].long())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["down", "up"])
def test_decomposition_matches_jax(case, kind, dtype):
    lv, lv_j, rng = case["lv"], case["lv_j"], case["rng"]
    cin, cout = case["cin"], case["cout"]
    fine, coarse = lv[0], lv[1]
    src = fine if kind == "down" else coarse
    f = _feats(src, cin, rng)
    w = (rng.normal(size=(8, cin, cout)) / 3).astype(np.float32)
    ft, wt = _t(f).to(dtype), _t(w).to(dtype)
    fj, wj = (jnp.asarray(x).astype(JAX_DTYPE[dtype]) for x in (f, w))
    with sparse_impl("xla"):
        if kind == "down":
            want = jax.jit(JC.conv_down)(fj, wj, lv_j[0], lv_j[1])
            got = _down(ft, wt, coarse, dtype)
            plain = conv.gather_gemm_down_plain(ft, wt, coarse.child_idx,
                                                coarse.child_hit)
        else:
            want = jax.jit(JC.conv_transpose_up)(fj, wj, lv_j[1], lv_j[0])
            got = _up(ft, wt, fine, fine.row_ok, dtype)
            plain = conv.gather_gemm_up_plain(ft, wt, fine.parent_idx,
                                              fine.row_ok, fine.octant)
    assert got.dtype == dtype and got.shape == plain.shape
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got, plain.float()) <= TOL[dtype]


def test_padding_and_overflowed_children_give_zero_rows(case):
    lv, rng = case["lv"], case["rng"]
    cin, cout = case["cin"], case["cout"]
    fine, coarse = lv[0], lv[1]
    w = _t((rng.normal(size=(8, cin, cout))).astype(np.float32))
    down_in = _t(_feats(fine, cin, rng))
    up_in = _t(_feats(coarse, cin, rng))
    no_hit = coarse.child_hit & False
    assert not _down(down_in, w,
                     dataclasses.replace(coarse, child_hit=no_hit),
                     torch.float32).any()
    assert not _up(up_in, w, fine, fine.row_ok & False, torch.float32).any()
    out = _up(up_in, w, fine, fine.row_ok, torch.float32)
    dropped = fine.valid & ~fine.row_ok
    assert not out[~fine.row_ok].any()
    assert bool(out[fine.row_ok].abs().sum(-1).gt(0).all())
    if case["name"] == "overflow":
        assert bool(dropped.any())  # the case has overflowed parents


def test_stage_wrappers_take_the_plain_twins_on_the_cpu(case):
    lv, rng = case["lv"], case["rng"]
    fine, coarse = lv[0], lv[1]
    b, nf = fine.key.shape
    f = _t(_feats(fine, 5, rng))
    w = _t(rng.normal(size=(8, 5, 6)).astype(np.float32))
    fidx, _, count = hit_lists.HitLists("down", nf, coarse.child_idx,
                                         coarse.child_hit).entries()
    y = conv.list_gemm(f, w, fidx, fidx, count, b * nf)
    assert torch.equal(y, conv.list_gemm_plain(f, w, fidx, fidx, count,
                                               b * nf))
    out = conv.child_sum(y.reshape(b, nf, 6), coarse.child_idx,
                         coarse.child_hit, torch.float32)
    assert torch.equal(out, conv.child_sum_plain(
        y.reshape(b, nf, 6), coarse.child_idx, coarse.child_hit,
        torch.float32))
    assert _rel(out, conv.gather_gemm_down(f, w, coarse.child_idx,
                                           coarse.child_hit)) <= 1e-6
