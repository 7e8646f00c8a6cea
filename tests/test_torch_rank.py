"""The rank lookup and the k3 route of the port vs the JAX package (CPU).

- ``neighbor_tables`` (the rank plain twin over a level) against the JAX
  package's XLA tables (``hierarchy._neighbor_table_one``) and, at 128
  rows, against its rank kernel (``rank_pallas.neighbor_tables``,
  interpret mode): ``hit`` exact, ``idx``
  exact wherever ``hit``.  Levels hold padding rows and voxels at
  coordinates 0 and 1023, where border queries alias real keys across the
  packed fields.  Every ``idx`` (misses included) equals numpy's
  ``searchsorted(side="left")`` clamped to N - 1: the rank kernel's own
  value for a miss.
- The card kernel's chained ranks (``rank_plan``: ``rank(q + 1) = rank(q)
  + #{keys == q}``), emulated in numpy, equal the plain searchsorted on keys
  with repeated KEY_PAD padding.
- ``uses_k3_tables`` equals the JAX engine's gate (``_k3_sk`` and
  ``hierarchy._use_self_keyed``) over a grid of (n, impl, compute dtype,
  ``k3_self_keyed``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.ops import rank_pallas
from mrcc_tpu.sparse.hierarchy import K3_OFFSETS as JAX_K3_OFFSETS
from mrcc_tpu.sparse.hierarchy import _neighbor_table_one, _use_self_keyed
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.ops.rank import rank_lookup, rank_plan
from mrcc_tpu_torch.sparse import (K3_OFFSETS, KEY_PAD, Level,
                                   neighbor_tables, pack_key, uses_k3_tables)
from mrcc_tpu_torch.sparse.hierarchy import K3_DELTAS, k3_bits


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


B = 2


def _level(n, seed):
    """B items of unique voxels in sorted key order, ~75 % of n valid,
    clustered at both ends of the coordinate window and in the middle."""
    rng = np.random.default_rng(seed)
    offs, keys, valid = [], [], []
    for _ in range(B):
        m = int(n * 0.75)
        # (x, y, 0) - dz aliases (x, y - 1, 1023): the last part holds both
        parts = [rng.integers(0, 8, size=(m, 3)),
                 rng.integers(1016, 1024, size=(m, 3)),
                 rng.integers(500, 508, size=(m, 3)),
                 np.stack([rng.integers(0, 8, m), rng.integers(0, 8, m),
                           rng.choice([0, 1, 1022, 1023], m)], 1)]
        pts = np.unique(np.concatenate(parts), axis=0)
        pts = pts[rng.permutation(len(pts))[:m]]
        key = pack_key(torch.as_tensor(pts, dtype=torch.int32)).numpy()
        order = np.argsort(key)
        off = np.zeros((n, 3), np.int32)
        off[:m] = pts[order]
        k = np.full((n,), KEY_PAD, np.int32)
        k[:m] = key[order]
        offs.append(off)
        keys.append(k)
        valid.append(np.arange(n) < m)
    off, key, valid = (np.stack(offs), np.stack(keys), np.stack(valid))
    assert (off[valid] == 0).any() and (off[valid] == 1023).any()
    return off, key, valid


def _port_tables(off, key, valid):
    off_t, valid_t = torch.as_tensor(off), torch.as_tensor(valid)
    level = Level(off=off_t, key=torch.as_tensor(key), valid=valid_t,
                  count=valid_t.sum(1, dtype=torch.int32),
                  kbits=k3_bits(off_t, valid_t))
    idx, hit = neighbor_tables(level)
    return idx.numpy(), hit.numpy()


@pytest.mark.parametrize("n", [128, 300, 1024])
def test_neighbor_tables_match_jax(n):
    off, key, valid = _level(n, seed=n)
    idx, hit = _port_tables(off, key, valid)
    assert idx.shape == hit.shape == (27, B, n) and idx.dtype == np.int32
    want_idx, want_hit = jax.vmap(
        lambda o, k, v: _neighbor_table_one(o, k, v, JAX_K3_OFFSETS),
        out_axes=(1, 1))(jnp.asarray(off), jnp.asarray(key),
                         jnp.asarray(valid))
    want_hit = np.asarray(want_hit)
    np.testing.assert_array_equal(hit, want_hit)
    np.testing.assert_array_equal(np.where(hit, idx, -1),
                                  np.where(want_hit, want_idx, -1))
    assert hit.sum() > 2 * valid.sum()       # real neighbourhoods
    # border queries that alias a real key across the packed fields miss
    deltas = np.asarray(K3_DELTAS)[:, None, None]
    q = key[None] + deltas
    alias = np.zeros_like(hit)
    for b in range(B):
        alias[:, b] = np.isin(q[:, b], key[b][valid[b]])
    assert (alias & ~hit & valid[None]).any()
    # every idx is the clamped left rank of its query (the miss contract)
    rank = np.stack([np.searchsorted(key[b], q[:, b], side="left")
                     for b in range(B)], axis=1)
    np.testing.assert_array_equal(idx, np.minimum(rank, n - 1))
    if n == 128:  # the JAX rank kernel (interpret mode)
        k_idx, k_hit = rank_pallas.neighbor_tables(
            jnp.asarray(off), jnp.asarray(key), jnp.asarray(valid),
            JAX_K3_OFFSETS)
        np.testing.assert_array_equal(hit, np.asarray(k_hit))
        np.testing.assert_array_equal(np.where(hit, idx, -1),
                                      np.where(hit, np.asarray(k_idx), -1))


def test_chained_ranks_equal_searchsorted():
    """The card kernel's order and chain over K3 deltas and an arbitrary
    delta set, on keys with repeated KEY_PAD: numpy emulation."""
    rng = np.random.default_rng(1)
    for deltas in (K3_DELTAS, (-3, 5, 4, 0, 1, 2, 9, -4, 1 << 10)):
        order, ds, chain = rank_plan(deltas)
        assert sorted(order) == list(range(len(deltas)))
        keys = np.sort(rng.choice(1 << 22, size=(B, 700), replace=False)
                       ).astype(np.int32)
        keys[:, 500:] = KEY_PAD
        qbase = np.concatenate([keys + rng.integers(-2, 3, size=(B, 700)),
                                np.full((B, 100), KEY_PAD)], 1)
        qbits = rng.integers(0, 1 << 31, size=(B, 800)).astype(np.int32)
        got_idx = np.zeros((len(deltas), B, 800), np.int64)
        got_hit = np.zeros((len(deltas), B, 800), bool)
        for b in range(B):
            kr = keys[b]
            for i in range(800):
                r, q_prev, eq_prev = 0, 0, False
                for j, k in enumerate(order):
                    q = int(qbase[b, i]) + ds[j]
                    if not chain[j]:
                        r = int(np.searchsorted(kr, q))
                    elif eq_prev:
                        r += 1
                        if r < len(kr) and kr[r] == q_prev:
                            r = int(np.searchsorted(kr, q))
                    eq = r < len(kr) and kr[r] == q
                    got_idx[k, b, i] = min(r, len(kr) - 1)
                    got_hit[k, b, i] = eq and (qbits[b, i] >> k) & 1
                    q_prev, eq_prev = q, eq
        want_idx, want_hit = rank_lookup(torch.as_tensor(keys),
                                         torch.as_tensor(qbase.astype(
                                             np.int32)), deltas,
                                         torch.as_tensor(qbits))
        np.testing.assert_array_equal(got_idx, want_idx.numpy())
        np.testing.assert_array_equal(got_hit, want_hit.numpy())
        assert got_hit.any() and (got_idx == 699).any()


def _jax_uses_tables(n, impl, compute_dtype, k3_self_keyed):
    """The JAX engine: ``_k3_sk`` (bf16 only), then the build-time gate at
    the stage's impl ("pallas" for every port impl but int8)."""
    if not (k3_self_keyed and jnp.dtype(compute_dtype).itemsize == 2):
        return True
    with sparse_impl("pallas-int8" if impl == "pallas-int8" else "pallas"):
        return not _use_self_keyed(n)


def test_route_matches_the_jax_gate():
    grid = (64, 128, 200, 12544, 20480, 20608, 20500, 40960, 40992, 41000,
            72448, 72500)
    for n in grid:
        for impl in ("auto", "pallas", "xla", "pallas-int8"):
            for dtype in ("bfloat16", "float32"):
                for sk in (True, False):
                    assert uses_k3_tables(n, impl, dtype, sk) == \
                        _jax_uses_tables(n, impl, dtype, sk), \
                        (n, impl, dtype, sk)
    assert uses_k3_tables(20608) and not uses_k3_tables(20480)
    assert uses_k3_tables(40992, "pallas-int8")
    assert not uses_k3_tables(40960, "pallas-int8")


def test_engine_routes_each_stage_at_its_impl():
    """An int8 engine's rotation stage gates at bf16; f32 and
    ``k3_self_keyed=False`` take tables everywhere."""
    caps = dict(point_capacity=256, seg_voxel_capacity=40960,
                seg_hierarchy_caps=(20608, 20480, 128, 128),
                ee_point_capacity=128, ee_voxel_capacity=40960,
                ee_hierarchy_caps=(20608, 20480, 128, 128),
                kp_voxel_capacity=256, kp_hierarchy_caps=(128,) * 4,
                seg_backbone="minkunet14A", rot_backbone="minkunet14A",
                kp_backbone="minkunet14A")
    eng = InferenceEngine(InferenceConfig(conv_impl="pallas-int8", **caps),
                          device="cpu")
    assert eng.k3_tables == {
        "seg": (False,) * 5, "rot": (True, True, False, False, False),
        "kp": (False,) * 5}
    for kw in (dict(k3_self_keyed=False),
               dict(compute_dtype="float32")):
        eng = InferenceEngine(InferenceConfig(**kw, **caps), device="cpu")
        assert all(all(t) for t in eng.k3_tables.values())
    # int8 over 40960 rows: tables on level 0 (level 1's transpose conv
    # takes the lane-packed groups)
    big = dict(caps, seg_voxel_capacity=72448,
               seg_hierarchy_caps=(49152, 13568, 4352, 768))
    eng = InferenceEngine(InferenceConfig(conv_impl="pallas-int8", **big),
                          device="cpu")
    assert eng.k3_tables["seg"] == (True, True, False, False, False)
    assert len(K3_OFFSETS) == 27
