"""The k3-table convs of the port vs the JAX package (CPU).

- ``q8_channel_groups("k3_table", n, cin)`` against the JAX plan:
  ``_split_plan(n, cin, 27, 32, itemsize=1)`` (interpret branch) under the
  5 MiB table budget, the streamed wrapper's 128-channel groups over it.
- ``gather_gemm_k3_map`` (plain twin) against the JAX ``"xla"``
  ``conv_kernel_map`` over the same level's tables: f32 to 1e-5, bf16 to
  2e-2 in relative norm (the JAX Pallas wrapper sums its channel groups in
  bf16, the port sums all channels in f32: the bf16 tolerance covers it).
- ``gather_gemm_k3_map_q8`` (plain twin) against the jitted JAX
  ``gather_gemm_conv_tiled_q8(identity_k=13)`` (interpret mode) at two
  channel groups, and against ``gather_gemm_conv_streamed(q8=True)`` called
  directly at a small n with the port's budget shrunk so that it takes the
  streamed groups: within 1 bf16 ulp elementwise (0 expected: the int32
  sums are exact), and within 3e-2 of the f32 conv.
- The int8 transpose conv over a table past the budget (``_split_plan``'s
  lane-packed plan: 64-channel groups at pack 2) against the JAX wrapper,
  with both budgets shrunk: within 1 bf16 ulp (0 expected).
- Engine pairs with ``k3_self_keyed=False``: the JAX engine's jitted seg
  stage against the port's on the CPU, same weights through
  ``load_jax_params``, every capacity a multiple of 128; seg labels equal
  on at least 99.5 % of points.  bf16 against the JAX ``"xla"`` tables;
  int8 against ``"pallas-int8"`` (the rank kernel and the q8 table conv in
  interpret mode, both sides quantising with the dynamic absmax), which
  costs about 90 s of JAX compile and sits in the slow tier.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.ops import conv_pallas as CP
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import conv as JC
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.hierarchy import _up_tiled_maps
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.ops import conv as TC
from mrcc_tpu_torch.ops import conv_q8 as Q
from mrcc_tpu_torch.sparse import build_hierarchy
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


B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def levels():
    """JAX (``"xla"``, with tables) and port (tables on every level)
    hierarchies of one cloud: capacities 768, 512, 256, 128, 128."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(B, 700, 3)) * 0.05).astype(np.float32)
    rgb = (rng.random((B, 700, 3)) - 0.5).astype(np.float32)
    mask = rng.random((B, 700)) > 0.05
    caps = (512, 256, 128, 128)
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), 0.005, 768)
    with sparse_impl("xla"):
        lv_j = jax.jit(partial(jax_build_hierarchy, depth=4,
                               capacities=caps))(vox_j)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox_j.off), key=_t(vox_j.key), feats=_t(vox_j.feats),
        valid=_t(vox_j.valid), count=_t(vox_j.count)), 4, capacities=caps,
        k3_tables=(True,) * 5)
    return lv_j, lv


def _feats(level, c, rng):
    x = rng.normal(size=level.valid.shape + (c,))
    return jnp.asarray(np.where(np.asarray(level.valid)[..., None], x, 0.0),
                       jnp.float32)


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ulps(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7))
                 .max())


def _jax_k3_table_groups(n, c):
    if n * 128 > CP._TABLE_BUDGET:
        c_g = min(CP._padded_lanes(c), 128)    # gather_gemm_conv_streamed
    else:
        c_g, _, _, kg, n_kg, pack = CP._split_plan(n, c, 27, 32, itemsize=1)
        assert kg == 27 and n_kg == 1 and pack == 1
    return tuple((a, min(a + c_g, c)) for a in range(0, c, c_g))


def test_k3_table_channel_groups_match_the_jax_plan():
    for n in (128, 12544, 20480, 20608, 40960, 40992, 72448):
        for c in (3, 32, 96, 128, 256, 384, 416):
            assert Q.q8_channel_groups("k3_table", n, c) == \
                _jax_k3_table_groups(n, c), (n, c)
    assert Q.q8_channel_groups("k3_table", 12544, 384) == ((0, 256),
                                                           (256, 384))
    assert Q.q8_channel_groups("k3_table", 72448, 384) == (
        (0, 128), (128, 256), (256, 384))


@pytest.mark.parametrize("l,cin,cout", [(0, 3, 32), (1, 96, 64),
                                        (3, 256, 48)])
def test_k3_map_conv_matches_jax(levels, l, cin, cout):
    lv_j, lv = levels
    rng = np.random.default_rng(cin)
    f = _feats(lv[l], cin, rng)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    with sparse_impl("xla"):
        want = JC.conv_kernel_map(f, jnp.asarray(w), lv_j[l].nbr_idx,
                                  lv_j[l].nbr_hit, lv_j[l].valid)
    valid = lv[l].valid[..., None]
    got = TC.gather_gemm_k3_map(_t(f), _t(w), lv[l].nbr_idx, lv[l].nbr_hit)
    assert _rel(torch.where(valid, got, 0.0), want) <= 1e-5
    got16 = TC.gather_gemm_k3_map(_t(f).bfloat16(), _t(w).bfloat16(),
                                  lv[l].nbr_idx, lv[l].nbr_hit)
    assert got16.dtype == torch.bfloat16
    assert _rel(torch.where(valid, got16, 0.0), want) <= 2e-2


def test_k3_map_q8_matches_jax(levels):
    """384 channels split 256 + 128 by the int8 k-lane cap."""
    lv_j, lv = levels
    l, cin, cout = 2, 384, 24
    n = lv[l].key.shape[1]
    assert Q.q8_channel_groups("k3_table", n, cin) == ((0, 256), (256, 384))
    rng = np.random.default_rng(cin)
    f = _feats(lv[l], cin, rng).astype(jnp.bfloat16)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    tiled = CP.build_tiled_maps(lv_j[l].nbr_idx, lv_j[l].nbr_hit, n)
    want = jax.jit(partial(CP.gather_gemm_conv_tiled_q8, k=27,
                           identity_k=13))(f, jnp.asarray(w), tiled,
                                           lv_j[l].valid)
    fb = _t(f.astype(jnp.float32)).bfloat16()
    got = Q.gather_gemm_k3_map_q8(fb, _t(w), lv[l].nbr_idx, lv[l].nbr_hit)
    got = torch.where(lv[l].valid[..., None], got, 0.0)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, want) == 0.0
    with sparse_impl("xla"):
        ref = JC.conv_kernel_map(f.astype(jnp.float32), jnp.asarray(w),
                                 lv_j[l].nbr_idx, lv_j[l].nbr_hit,
                                 lv_j[l].valid)
    assert _rel(got, ref) <= 3e-2


def test_k3_map_q8_matches_the_streamed_wrapper(levels, monkeypatch):
    """The production level's plan (128-channel groups over an HBM table)
    at a small n: the port's budget shrunk under its table."""
    lv_j, lv = levels
    l, cin, cout = 1, 256, 40
    n = lv[l].key.shape[1]
    monkeypatch.setattr(Q, "_TABLE_BUDGET", n * 128 - 1)
    assert Q.q8_channel_groups("k3_table", n, cin) == ((0, 128), (128, 256))
    rng = np.random.default_rng(11)
    f = _feats(lv[l], cin, rng).astype(jnp.bfloat16)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    tiled = CP.build_tiled_maps(lv_j[l].nbr_idx, lv_j[l].nbr_hit, n)
    want = jax.jit(partial(CP.gather_gemm_conv_streamed, k=27, q8=True))(
        f, jnp.asarray(w), tiled, lv_j[l].valid)
    got = Q.gather_gemm_k3_map_q8(_t(f.astype(jnp.float32)).bfloat16(),
                                  _t(w), lv[l].nbr_idx, lv[l].nbr_hit)
    assert _ulps(torch.where(lv[l].valid[..., None], got, 0.0), want) == 0.0


def test_up_q8_lane_packed_groups_match_jax(levels, monkeypatch):
    """An int8 transpose conv from a table over the budget: the JAX
    wrapper lane-packs it (``_split_plan``'s pack branch) and quantises in
    64-channel groups; both budgets shrunk under the 256-row level."""
    lv_j, lv = levels
    l, cin, cout = 1, 160, 24
    fine, coarse = lv[l], lv[l + 1]
    n = coarse.key.shape[1]
    monkeypatch.setattr(Q, "_TABLE_BUDGET", n * 64)
    monkeypatch.setattr(CP, "_TABLE_BUDGET", n * 64)
    assert Q.q8_channel_groups("up", n, cin) == ((0, 64), (64, 128),
                                                 (128, 160))
    rng = np.random.default_rng(12)
    f = _feats(coarse, cin, rng).astype(jnp.bfloat16)
    w = (rng.normal(size=(8, cin, cout)) / np.sqrt(cin)
         * (1.0 + np.arange(8))[:, None, None]).astype(np.float32)
    up = _up_tiled_maps(lv_j[l].parent_idx, lv_j[l].parent_ok,
                        lv_j[l].octant, lv_j[l].valid, n)
    want = jax.jit(partial(CP.gather_gemm_conv_tiled_q8, k=8, bcast_k=True))(
        f, jnp.asarray(w), up, lv_j[l].valid)
    got = Q.gather_gemm_up_q8(_t(f.astype(jnp.float32)).bfloat16(), _t(w),
                              fine.parent_idx, fine.row_ok, fine.octant)
    assert _ulps(torch.where(fine.valid[..., None], got, 0.0), want) == 0.0


# ------------------------------------------------------------- engine

P = 1024
ENGINE_CFG = dict(point_capacity=P, seg_voxel_capacity=768,
                  seg_hierarchy_caps=(512, 256, 128, 128),
                  ee_point_capacity=512, ee_voxel_capacity=512,
                  ee_hierarchy_caps=(256, 128, 128, 128),
                  kp_voxel_capacity=512,
                  kp_hierarchy_caps=(384, 256, 128, 128),
                  seg_backbone="minkunet14A", rot_backbone="minkunet14A",
                  kp_backbone="minkunet14A", icp_iterations=3,
                  icp_template_points=128, k3_self_keyed=False)


def _scenes():
    pts = np.zeros((B, P, 3), np.float32)
    rgb = np.zeros((B, P, 3), np.float32)
    mask = np.zeros((B, P), bool)
    for i in range(B):
        s = generate_sample(seed=40 + i, n_ee=300, n_arm=300, n_bg=380)
        n = len(s["points"])
        pts[i, :n], rgb[i, :n], mask[i, :n] = s["points"], s["rgb"], True
    return pts, rgb, mask


def _seg_pair(conv_impl):
    """The JAX engine's jitted seg stage and the port's, same weights;
    returns the share of equal seg labels over valid points."""
    pts, rgb, mask = _scenes()
    cfg = dict(ENGINE_CFG, conv_impl=conv_impl)
    jeng = JaxEngine(JaxConfig(**cfg), seed=0)
    peng = InferenceEngine(InferenceConfig(**cfg), device="cpu")
    peng.load_jax_params(jax.device_get(jeng.params))
    assert all(all(t) for t in peng.k3_tables.values())
    want = jeng._seg_jit(jeng.params["segmentation"], pts, rgb, mask)
    got = peng.seg_stage(_t(pts), _t(rgb), _t(mask))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    return float((got[0].numpy() == np.asarray(want[0]))[mask].mean())


def test_bf16_tables_engine_matches_jax():
    """bf16 on the table route at every level against the JAX engine's
    ``"xla"`` tables (its oracle route; the rank kernel and the bf16 table
    conv agree with it per layer, above)."""
    agree = _seg_pair("xla")
    assert agree >= 0.995, agree


@pytest.mark.slow
def test_int8_tables_engine_matches_jax():
    """int8 on the table route at every level against the JAX engine under
    ``"pallas-int8"`` (rank kernel and q8 table conv in interpret mode):
    about 90 s of JAX compile on one CPU core, hence the slow tier."""
    agree = _seg_pair("pallas-int8")
    assert agree >= 0.995, agree
