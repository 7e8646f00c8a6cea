"""The per-offset hit lists of a map (``ops.hit_lists.HitLists``), which
K3's down and up convs, their int8 counterparts and the dW kernels read,
on the CPU: the plain twin, which ``HitLists`` runs for CPU tensors.

- The lists hold every hit of the map in row order ``r = b * n_rows + i``
  and nothing else: no miss, no row whose offset bit is off (the
  self-keyed ``kbits`` gate), no padding row, no up-map row whose
  ``row_ok`` is false (C8); -1 after ``count[k]``.
- ``dW[k] = feats[fidx[k]]^T @ g[gidx[k]]`` (an einsum over the lists, g
  masked by the output level's validity as the autograd Functions do)
  equals the JAX package's weight cotangent, ``jax.grad`` of its
  ``conv_k3`` / ``conv_down`` / ``conv_transpose_up`` under
  ``sparse_impl("xla")``, within 1e-5 in relative norm (summation order
  only), for the self-keyed search, the k3 tables, the child map and the
  parent / octant map.
- The self-keyed search and the k3 tables of one level give the same
  lists (the dW kernels then give the same bits on both k3 routes).
- A level of padding rows gives empty lists and a zero dW.
- The lists' k3 deltas are the sparse core's, and a level on the CPU holds
  no lists.

Clouds: ``tests/test_torch_conv.py``'s border (keys that alias across the
packed fields), overflow (parents past the coarse capacity) and scattered
cases, B = 2, f32.
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
from mrcc_tpu_torch.sparse import build_hierarchy, neighbor_tables
from mrcc_tpu_torch.sparse import conv as sparse_conv
from mrcc_tpu_torch.sparse.hierarchy import K3_DELTAS
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


TOL = 1e-5
KINDS = ("sk", "k3map", "down", "up")


@pytest.fixture(scope="module", params=["border", "overflow", "scattered"])
def case(request):
    cloud, cin, cout, cap, caps = CASES[request.param]
    rng = np.random.default_rng(len(request.param) + 7)
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


def _setup(kind, case):
    """``(maps, n_in, feats level, g level, JAX conv fn(f, w))`` of one dW
    kind: the k3 kinds on level 0, down 0 -> 1, up 1 -> 0."""
    lv, lv_j = case["lv"], case["lv_j"]
    if kind == "sk":
        return ((lv[0].key, lv[0].kbits), lv[0], lv[0],
                lambda f, w: JC.conv_k3(f, w, lv_j[0]))
    if kind == "k3map":
        return (neighbor_tables(lv[0]), lv[0], lv[0],
                lambda f, w: JC.conv_k3(f, w, lv_j[0]))
    if kind == "down":
        return ((lv[1].child_idx, lv[1].child_hit), lv[0], lv[1],
                lambda f, w: JC.conv_down(f, w, lv_j[0], lv_j[1]))
    return ((lv[0].parent_idx, lv[0].row_ok, lv[0].octant), lv[1], lv[0],
            lambda f, w: JC.conv_transpose_up(f, w, lv_j[1], lv_j[0]))


def _source_hits(kind, maps):
    """Independent [K, B * n] hit mask and source rows of the map."""
    if kind == "sk":
        key, kbits = maps
        hit, idx = [], []
        for k, d in enumerate(K3_DELTAS):
            q = key + d
            j = torch.searchsorted(key, q).clamp_max(key.shape[1] - 1)
            hit.append((((kbits >> k) & 1) != 0) & (key.gather(1, j) == q))
            idx.append(j)
        return torch.stack(hit), torch.stack(idx)
    if kind == "up":
        parent_idx, row_ok, octant = maps
        return (torch.stack([row_ok & (octant == k) for k in range(8)]),
                parent_idx.expand(8, -1, -1))
    idx, hit = maps
    return hit, idx


@pytest.mark.parametrize("kind", KINDS)
def test_lists_hold_the_hits_in_row_order(case, kind):
    maps, src_lv, dst_lv, _ = _setup(kind, case)
    n_in = src_lv.key.shape[1]
    fidx, gidx, count = hit_lists.HitLists(kind, n_in, *maps).entries()
    taps, b, n = (hit_lists.TAPS[kind],) + tuple(dst_lv.key.shape)
    assert fidx.shape == gidx.shape == (taps, b * n)
    assert count.dtype == fidx.dtype == torch.int32
    hit, j = _source_hits(kind, maps)
    hit, j = hit.reshape(taps, b * n), j.reshape(taps, b * n)
    rows = torch.arange(b * n)
    valid = dst_lv.valid.reshape(-1)
    row_ok = dst_lv.row_ok.reshape(-1)
    assert int(count.sum()) > 0
    for k in range(taps):
        c = int(count[k])
        assert c == int(hit[k].sum())
        g, f = gidx[k, :c].long(), fidx[k, :c].long()
        assert bool((g[1:] > g[:-1]).all())  # strictly row order
        assert bool(hit[k, g].all()) and bool(valid[g].all())
        assert torch.equal(f, (g // n) * n_in + j[k, g].long())
        assert bool((gidx[k, c:] == -1).all() and (fidx[k, c:] == -1).all())
        if kind == "up":
            assert bool(row_ok[g].all())
        if kind == "sk":  # the offset bit gates every listed row
            bits = (dst_lv.kbits.reshape(-1)[g] >> k) & 1
            assert bool((bits == 1).all())
    assert torch.equal(rows[hit.any(0)], rows[hit.any(0) & valid])
    if kind == "up" and case["name"] == "overflow":
        # the overflowed parents' rows are valid but listed nowhere
        dropped = valid & ~row_ok
        assert bool(dropped.any())
        assert not bool(torch.isin(rows[dropped], gidx[gidx >= 0]).any())


@pytest.mark.parametrize("kind", KINDS)
def test_einsum_over_lists_matches_jax_dw(case, kind):
    maps, src_lv, dst_lv, jfn = _setup(kind, case)
    cin, cout, rng = case["cin"], case["cout"], case["rng"]
    taps = hit_lists.TAPS[kind]
    f = np.where(np.asarray(src_lv.valid)[..., None],
                 rng.normal(size=src_lv.valid.shape + (cin,)), 0.0
                 ).astype(np.float32)
    ct = rng.normal(size=dst_lv.valid.shape + (cout,)).astype(np.float32)
    w0 = jnp.zeros((taps, cin, cout), jnp.float32)
    with sparse_impl("xla"):
        want = np.asarray(jax.jit(jax.grad(
            lambda w: jnp.sum(jfn(jnp.asarray(f), w) * ct)))(w0))
    fidx, gidx, count = hit_lists.HitLists(kind, src_lv.key.shape[1],
                                           *maps).entries()
    ff = _t(f).reshape(-1, cin)
    gg = torch.where(dst_lv.valid[..., None], _t(ct), 0.0).reshape(-1, cout)
    got = torch.stack([
        torch.einsum("hc,hd->cd", ff[fidx[k, :c].long()],
                     gg[gidx[k, :c].long()])
        for k, c in enumerate(count.tolist())])
    assert float(np.linalg.norm(got.numpy() - want)
                 / np.linalg.norm(want)) <= TOL


def test_self_keyed_and_table_lists_are_equal(case):
    lv = case["lv"][0]
    n = lv.key.shape[1]
    sk = hit_lists.HitLists("sk", n, lv.key, lv.kbits).entries()
    tables = hit_lists.HitLists("k3map", n, *neighbor_tables(lv)).entries()
    for a, b in zip(sk, tables):
        assert torch.equal(a, b)


def test_padding_level_gives_empty_lists(case):
    lv = dataclasses.replace(case["lv"][2], kbits=torch.zeros_like(
        case["lv"][2].kbits))
    n = lv.key.shape[1]
    fidx, gidx, count = hit_lists.HitLists("sk", n, lv.key,
                                           lv.kbits).entries()
    assert int(count.abs().sum()) == 0
    assert bool((fidx == -1).all() and (gidx == -1).all())
    f = torch.ones(lv.key.shape + (4,))
    assert not bool(conv.dw_sk(f, f, lv.key, lv.kbits).any())


def test_k3_deltas_are_the_sparse_cores():
    """``ops.hit_lists`` computes the k3 deltas as the card does, without
    importing the sparse core: the same tuple as ``sparse.hierarchy``."""
    assert hit_lists.K3_DELTAS == K3_DELTAS
    assert conv._K3_DELTAS == K3_DELTAS


def test_cpu_levels_hold_no_lists(case):
    """The plain twins read no lists, so a CPU step lists nothing: the
    level accessors give None and the levels stay empty."""
    lv = case["lv"]
    assert sparse_conv._child_lists(lv[0], lv[1]) is None
    assert sparse_conv._parent_lists(lv[0], lv[1]) is None
    assert all(not level.lists for level in lv)


@pytest.mark.parametrize("kind", KINDS)
def test_lists_reject_another_map(case, kind):
    """``HitLists`` refuses an unknown kind, maps of the wrong dtype or
    count, and a k3 map whose gathered rows are not its own; ``check``
    refuses lists of another map's kind or shape."""
    maps, src_lv, dst_lv, _ = _setup(kind, case)
    n_in = src_lv.key.shape[1]
    with pytest.raises(ValueError):
        hit_lists.HitLists("k5", n_in, *maps)
    with pytest.raises(ValueError):
        hit_lists.HitLists(kind, n_in, *maps[:-1])
    with pytest.raises(ValueError):
        hit_lists.HitLists(kind, n_in, maps[0].float(), *maps[1:])
    if kind in ("sk", "k3map"):
        with pytest.raises(ValueError):
            hit_lists.HitLists(kind, n_in + 1, *maps)
    lists = hit_lists.HitLists(kind, n_in, *maps)
    rows = dst_lv.key.shape
    lists.check("t", (kind,), n_in, rows)
    for kinds, n, r in (((("down",) if kind != "down" else ("up",)), n_in,
                         rows), ((kind,), n_in + 1, rows),
                        ((kind,), n_in, (rows[0], rows[1] + 1))):
        with pytest.raises(ValueError):
            lists.check("t", kinds, n, r)
