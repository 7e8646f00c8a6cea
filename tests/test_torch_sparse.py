"""mrcc_tpu_torch sparse core vs the JAX package (CPU, plain twins).

Sort, voxelize, hierarchy and the k3 bitmap are integer-exact against the
JAX ``"xla"`` path; voxel features agree to 1e-6 (segment sums in another
order).  Inputs are numpy arrays from a seed, handed to both packages.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.ops.rank_pallas import sk_bits
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import slice_to_points as jax_slice_to_points
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.sorting import argsort_keys as jax_argsort_keys
from mrcc_tpu.sparse.hierarchy import K3_OFFSETS as JAX_K3_OFFSETS
from mrcc_tpu_torch.ops.sort import argsort, argsort_plain
from mrcc_tpu_torch.sparse import (KEY_PAD, build_hierarchy, slice_to_points,
                                   voxelize)
from mrcc_tpu_torch.sparse.hierarchy import K3_OFFSETS, k3_bits
from mrcc_tpu_torch.sparse.types import SparseVoxels


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


Q = 0.01  # voxel edge (m)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, b=2, p=1500):
    """Points with duplicates per voxel, some masked rows, and some points
    outside the 1024^3 voxel window."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, p, 3)).astype(np.float32) * 0.4
    pts[:, : p // 3] = np.round(pts[:, : p // 3] / Q) * Q + Q / 2  # stacks
    pts[:, -40:] = rng.uniform(6.0, 9.0, size=(b, 40, 3))  # out of range
    rgb = rng.random((b, p, 3)).astype(np.float32)
    mask = rng.random((b, p)) > 0.1
    return pts, rgb, mask


def _border_cloud(b=2):
    """Voxels at offset coords 0 and 1023 on every axis, plus (x, y, 1023)
    beside (x, y + 1, 0): a border query that aliases a real key."""
    rows = []
    for x in (0, 1, 500, 1022, 1023):
        for y in (0, 1, 2, 1022, 1023):
            for z in (0, 1, 1022, 1023):
                rows.append((x, y, z))
    off = np.array(rows, np.float32)
    pts = ((off - 512 + 0.5) * Q).astype(np.float32)
    pts = np.broadcast_to(pts, (b,) + pts.shape).copy()
    rgb = np.random.default_rng(5).random(pts.shape).astype(np.float32)
    return pts, rgb, np.ones(pts.shape[:2], bool)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n", [1000, 1024, 77])
def test_sort_plain_matches_jax_stable_argsort(n):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 40, size=(3, n)).astype(np.int32)  # duplicates
    key[:, rng.random(n) < 0.3] = KEY_PAD
    want_order = np.asarray(jnp.argsort(jnp.asarray(key), axis=-1,
                                        stable=True))
    for fn in (argsort_plain, argsort):  # the wrapper routes CPU to plain
        skey, order = fn(_t(key))
        assert order.dtype == torch.int32 and skey.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(), want_order)
        np.testing.assert_array_equal(skey.numpy(),
                                      np.take_along_axis(key, want_order, -1))


def test_sort_and_voxelize_past_two_pow_17_match_jax():
    """B = 1, P = 2^17 + 4096 (past the TPU kernel's range, where the JAX
    package takes XLA's stable argsort): the port's argsort and voxelize
    give the same order, keys and voxel rows."""
    p = (1 << 17) + 4096
    pts, rgb, mask = _cloud(17, b=1, p=p)
    coords = np.floor(pts / Q).astype(np.int32) + 512
    ok = mask & ((coords >= 0) & (coords < 1024)).all(-1)
    key = np.where(ok, (coords[..., 0] << 20) | (coords[..., 1] << 10)
                   | coords[..., 2], KEY_PAD).astype(np.int32)
    want_key, want_order = jax_argsort_keys(jnp.asarray(key))
    got_key, got_order = argsort(_t(key))
    _same(want_order, got_order)
    _same(want_key, got_key)
    vox_j, pv_j, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                                  jnp.asarray(mask), Q, 65536)
    vox, pv = voxelize(_t(pts), _t(rgb), _t(mask), Q, 65536)
    for name in ("off", "key", "valid", "count", "feats"):
        _same(getattr(vox_j, name), getattr(vox, name))
    _same(pv_j, pv)


@pytest.mark.parametrize("capacity", [2048, 300])  # 300 overflows
def test_voxelize_matches_jax(capacity):
    pts, rgb, mask = _cloud(1)
    vox_j, pv_j, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                                  jnp.asarray(mask), Q, capacity)
    vox, pv = voxelize(_t(pts), _t(rgb), _t(mask), Q, capacity)
    for name in ("off", "key", "valid", "count"):
        _same(getattr(vox_j, name), getattr(vox, name))
    _same(pv_j, pv)
    np.testing.assert_allclose(vox.feats.numpy(), np.asarray(vox_j.feats),
                               atol=1e-6)
    if capacity == 300:
        assert int(vox.count.min()) == capacity
        assert (pv.numpy() == capacity).any()


def test_slice_to_points_matches_jax():
    pts, rgb, mask = _cloud(2)
    vox, pv = voxelize(_t(pts), _t(rgb), _t(mask), Q, 600)
    vals = np.random.default_rng(3).normal(size=(2, 600, 5)).astype(np.float32)
    want = jax_slice_to_points(jnp.asarray(vals), jnp.asarray(pv.numpy()),
                               fill_value=-1e9)
    got = slice_to_points(_t(vals), pv, fill_value=-1e9)
    _same(want, got)


def _to_port_voxels(vox_j):
    return SparseVoxels(off=_t(vox_j.off), key=_t(vox_j.key),
                        feats=_t(vox_j.feats), valid=_t(vox_j.valid),
                        count=_t(vox_j.count))


@pytest.mark.parametrize("caps", [(1024, 512, 256, 128), (256, 64, 64, 64)])
def test_build_hierarchy_matches_jax(caps):
    """Second caps set overflows levels 1-4 (parent_ok false somewhere)."""
    pts, rgb, mask = _cloud(4)
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), Q, 1200)
    lv_j = jax.jit(partial(jax_build_hierarchy, depth=4, capacities=caps,
                           build_k3=False))(vox_j)
    lv = build_hierarchy(_to_port_voxels(vox_j), 4, capacities=caps)
    assert len(lv) == len(lv_j) == 5
    for l, (a, b) in enumerate(zip(lv_j, lv)):
        for name in ("off", "key", "valid", "count"):
            _same(getattr(a, name), getattr(b, name))
        if l < 4:
            for name in ("parent_idx", "parent_ok", "octant"):
                _same(getattr(a, name), getattr(b, name))
        if l > 0:
            _same(a.child_idx, b.child_idx)
            _same(a.child_hit, b.child_hit)
    if caps[0] == 256:
        assert not bool(lv[0].parent_ok[lv[0].valid].all())


@pytest.mark.parametrize("caps", [(1024, 512, 256, 128), (256, 64, 64, 64)])
def test_row_ok_is_the_child_map_reversed(caps):
    """``row_ok == valid & parent_ok``, and it holds exactly where the
    coarse child map points back at the row, each hit of the map once
    (ROADMAP C8: the down/up backward rests on this)."""
    pts, rgb, mask = _cloud(4)
    vox, _ = voxelize(_t(pts), _t(rgb), _t(mask), Q, 1200)
    lv = build_hierarchy(vox, 4, capacities=caps)
    for fine, coarse in zip(lv[:-1], lv[1:]):
        assert torch.equal(fine.row_ok, fine.valid & fine.parent_ok)
        b, n = fine.key.shape
        oct_l, par_l = fine.octant.long(), fine.parent_idx.long()
        items = torch.arange(b)[:, None].expand(b, n)
        hit = coarse.child_hit[oct_l, items, par_l]
        back = coarse.child_idx[oct_l, items, par_l]
        rows = torch.arange(n, dtype=back.dtype).expand(b, n)
        assert torch.equal(hit & (back == rows), fine.row_ok)
        assert torch.equal(coarse.child_hit.sum(dim=(0, 2)),
                           fine.row_ok.sum(dim=1))
    if caps[0] == 256:
        assert not bool(lv[0].row_ok[lv[0].valid].all())


@pytest.mark.parametrize("which", ["cloud", "border"])
def test_k3_bits_match_sk_bits(which):
    pts, rgb, mask = _cloud(6) if which == "cloud" else _border_cloud()
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), Q, 1024)
    np.testing.assert_array_equal(K3_OFFSETS, JAX_K3_OFFSETS)
    want = sk_bits(vox_j.off, vox_j.valid, JAX_K3_OFFSETS)
    got = k3_bits(_t(vox_j.off), _t(vox_j.valid))
    _same(want, got)
    lv = build_hierarchy(_to_port_voxels(vox_j), 4)
    _same(want, lv[0].kbits)
    if which == "border":
        # some bit is cleared on a valid row: the border gate is exercised
        valid = np.asarray(vox_j.valid)
        assert (np.asarray(want)[valid] != (1 << 27) - 1).any()
