"""The dense point ops, the JAX uniform draws and the dense sample's order
vs the JAX package (CPU).

Each of the seven functions of ``mrcc_tpu/ops/points.py`` takes the same
seeded numpy clouds on both sides (B = 2, N up to 2048): integer outputs
(FPS, ball query, index gathers) exactly; ``square_distance`` bit for bit
against the eager JAX function (a jitted one fuses otherwise and moves
~15 % of the entries by an ulp) at a large and a small shape, and bit for
bit with itself between a small call and the same points inside a large
one (ROADMAP C36); ``three_nn_interpolate`` to 1e-6 against
the eager function, with its three neighbours equal to ``jax.lax.top_k``'s
on a cloud of duplicate points.  FPS per item from ``start_idx``, with
fewer points than picks, and over parked invalid rows; the ball query with
empty and under-filled balls.  ``ops.prng.uniform`` equals
``jax.random.uniform(PRNGKey(seed), shape)`` bit for bit at three shapes;
the engine's uniform sample is the stable order of those draws (ties
forced) as ``jnp.argsort``; ``normalize_points`` to 1e-5 (its masked
mean sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.geometry.preprocess import normalize_points as jax_normalize
from mrcc_tpu.ops import points as J
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.geometry.preprocess import normalize_points
from mrcc_tpu_torch.ops import points as T
from mrcc_tpu_torch.ops.prng import uniform


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs files in
    parallel workers; torch's default of a thread a core oversubscribes
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,m", [(1024, 2048), (37, 5)])
def test_square_distance_bit_equal(n, m):
    a, b = _cloud(0, (2, n, 3)), _cloud(1, (2, m, 3))
    want = np.asarray(J.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = T.square_distance(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_square_distance_shape_stable():
    """A pair's distance has the same bits alone and inside a larger call
    (the [37, 5] case zero-padded to [1024, 2048])."""
    a, b = _cloud(0, (2, 37, 3)), _cloud(1, (2, 5, 3))
    pa, pb = np.zeros((2, 1024, 3), np.float32), np.zeros((2, 2048, 3),
                                                          np.float32)
    pa[:, :37], pb[:, :5] = a, b
    alone = T.square_distance(_t(a), _t(b)).numpy()
    inside = T.square_distance(_t(pa), _t(pb)).numpy()[:, :37, :5]
    np.testing.assert_array_equal(alone.view(np.uint32),
                                  inside.view(np.uint32))


def test_index_points():
    pts = _cloud(2, (2, 300, 5))
    idx = np.random.default_rng(3).integers(0, 300, size=(2, 40, 7))
    want = np.asarray(J.index_points(jnp.asarray(pts),
                                     jnp.asarray(idx, jnp.int32)))
    got = T.index_points(_t(pts), _t(idx))
    assert got.shape == (2, 40, 7, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fps_matches_jax(seed):
    xyz = _cloud(seed, (2, 2048, 3), 0.05)
    want = np.asarray(J.farthest_point_sample(jnp.asarray(xyz), 1024))
    got = T.farthest_point_sample(_t(xyz), 1024)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_start_per_item_and_short_clouds():
    xyz = _cloud(4, (2, 300, 3))
    start = np.array([7, 123], np.int32)
    want = np.asarray(J.farthest_point_sample(jnp.asarray(xyz), 64,
                                              start_idx=jnp.asarray(start)))
    got = T.farthest_point_sample(_t(xyz), 64, start_idx=_t(start))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0].tolist() == [7, 123]
    # fewer points than picks: every point once, then index 0 (JAX too)
    few = _cloud(5, (2, 40, 3))
    want = np.asarray(J.farthest_point_sample(jnp.asarray(few), 64))
    got = T.farthest_point_sample(_t(few), 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(sorted(set(row[:40])) == list(range(40)) for row in got)
    assert (got[:, 40:] == 0).all()


def test_fps_over_parked_rows():
    """The engine's farthest sample: invalid rows moved onto the first row
    are never picked while a valid row is left."""
    xyz = _cloud(6, (2, 512, 3), 0.05)
    valid = np.ones((2, 512), bool)
    valid[0, 300:] = False
    valid[1, ::3] = False
    valid[1, 0] = True
    parked = np.where(valid[..., None], xyz, xyz[:, :1])
    want = np.asarray(J.farthest_point_sample(jnp.asarray(parked), 256))
    got = T.farthest_point_sample(_t(parked), 256).numpy()
    np.testing.assert_array_equal(got, want)
    assert valid[0][got[0]].all() and valid[1][got[1]].all()


def test_ball_query_matches_jax():
    xyz = _cloud(7, (2, 2048, 3), 0.05)
    new = xyz[:, :512] + _cloud(8, (2, 512, 3), 0.01)
    for radius, k in ((0.02, 32), (0.05, 16), (0.1, 32)):
        want = np.asarray(J.query_ball_point(radius, k, jnp.asarray(xyz),
                                             jnp.asarray(new)))
        got = T.query_ball_point(radius, k, _t(xyz), _t(new))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_empty_and_underfilled():
    xyz = _cloud(9, (2, 64, 3))
    new = np.concatenate([xyz[:, :3], np.full((2, 2, 3), 50.0, np.float32)],
                         axis=1)
    want = np.asarray(J.query_ball_point(0.3, 16, jnp.asarray(xyz),
                                         jnp.asarray(new)))
    got = T.query_ball_point(0.3, 16, _t(xyz), _t(new)).numpy()
    np.testing.assert_array_equal(got, want)
    # an empty ball is N - 1 throughout (the JAX clamp)
    assert (got[:, 3:] == 63).all()
    # an under-filled ball repeats its first hit
    row = got[0, 0]
    hits = np.flatnonzero(((xyz[0] - xyz[0, 0]) ** 2).sum(-1) <= 0.09)
    assert len(hits) < 16
    np.testing.assert_array_equal(row[:len(hits)], hits)
    assert (row[len(hits):] == hits[0]).all()
    # more samples than points: the row holds all N candidates
    want = np.asarray(J.query_ball_point(5.0, 80, jnp.asarray(xyz),
                                         jnp.asarray(new)))
    got = T.query_ball_point(5.0, 80, _t(xyz), _t(new)).numpy()
    assert got.shape == (2, 5, 64)
    np.testing.assert_array_equal(got, want)


def test_sample_and_group():
    xyz = _cloud(10, (2, 1024, 3), 0.05)
    feats = _cloud(11, (2, 1024, 6))
    nx_j, g_j = J.sample_and_group(256, 0.05, 32, jnp.asarray(xyz),
                                   jnp.asarray(feats))
    nx_t, g_t = T.sample_and_group(256, 0.05, 32, _t(xyz), _t(feats))
    np.testing.assert_array_equal(nx_t.numpy(), np.asarray(nx_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-7)
    nx_j, g_j = J.sample_and_group(64, 0.1, 16, jnp.asarray(xyz), None)
    nx_t, g_t = T.sample_and_group(64, 0.1, 16, _t(xyz), None)
    assert g_t.shape == (2, 64, 16, 3)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-7)


def test_sample_and_group_all():
    xyz, feats = _cloud(12, (2, 50, 3)), _cloud(13, (2, 50, 4))
    for f in (feats, None):
        nx_j, g_j = J.sample_and_group_all(
            jnp.asarray(xyz), None if f is None else jnp.asarray(f))
        nx_t, g_t = T.sample_and_group_all(_t(xyz),
                                           None if f is None else _t(f))
        np.testing.assert_array_equal(nx_t.numpy(), np.asarray(nx_j))
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_three_nn_interpolate():
    fine, coarse = _cloud(14, (2, 2048, 3), 0.05), _cloud(15, (2, 512, 3),
                                                         0.05)
    feats = _cloud(16, (2, 512, 32))
    want = np.asarray(J.three_nn_interpolate(
        jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(feats)))
    got = T.three_nn_interpolate(_t(fine), _t(coarse), _t(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_three_nn_ties_keep_jax_order():
    """Duplicate coarse points tie exactly: ``top_k`` takes the lower index
    first, and so must the port."""
    base = _cloud(17, (2, 40, 3), 0.05)
    coarse = np.concatenate([base, base, base[:, :10]], axis=1)   # 90 pts
    fine = np.concatenate([base[:, :20], _cloud(18, (2, 30, 3), 0.05)], 1)
    d2 = T.square_distance(_t(fine), _t(coarse))
    idx, _ = T.three_nn(d2)
    _, want = jax.lax.top_k(-jnp.asarray(d2.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert (idx[:, :20, 0] < idx[:, :20, 1]).all()   # a tie, in index order
    feats = _cloud(19, (2, 90, 8))
    want = np.asarray(J.three_nn_interpolate(
        jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(feats)))
    got = T.three_nn_interpolate(_t(fine), _t(coarse), _t(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("shape,seed", [((2, 5), 0), ((8, 8192), 0),
                                        ((3, 4097), 7)])
def test_uniform_draws_bit_equal(shape, seed):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = uniform(shape, seed)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_sample_is_the_stable_jax_order():
    """The engine's uniform sample with forced ties among the draws: the
    stable order of ``where(valid, r, 2.0)`` (invalid rows last, equal draws
    in row order), as ``jnp.argsort``."""
    cfg = InferenceConfig(
        point_capacity=256, seg_voxel_capacity=256, ee_point_capacity=512,
        ee_voxel_capacity=128, seg_backbone="minkunet14A",
        rot_backbone="minkunet14A", kp_backbone="pointnet2",
        num_of_dense_input_points=200, compute_dtype="float32")
    eng = InferenceEngine(cfg, device="cpu")
    rng = np.random.default_rng(20)
    pts = (rng.normal(size=(2, 512, 3)) * 0.05).astype(np.float32)
    rgb = rng.uniform(size=(2, 512, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, 512)) < 0.8
    tied = np.floor(uniform((2, 512)) * 16) / 16      # ~32 equal draws a value
    eng._draws[(2, 512)] = _t(tied.astype(np.float32))
    _, order, s_valid = eng.dense_sample(_t(pts), _t(rgb), _t(valid))
    want = np.asarray(jnp.argsort(jnp.where(jnp.asarray(valid),
                                            jnp.asarray(tied), 2.0),
                                  axis=-1))[:, :200]
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(s_valid.numpy(),
                                  np.take_along_axis(valid, want, 1))
    # the engine's own draws are the JAX key-0 draws of its batch shape
    eng._draws.clear()
    eng.dense_sample(_t(pts), _t(rgb), _t(valid))
    np.testing.assert_array_equal(
        eng._draws[(2, 512)].numpy(),
        np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 512))))


def test_normalize_points():
    pc = _cloud(21, (2, 300, 3), 0.05) + 1.5
    mask = np.random.default_rng(22).uniform(size=(2, 300)) < 0.7
    for m in (mask, None):
        want = np.asarray(jax_normalize(jnp.asarray(pc),
                                        None if m is None else
                                        jnp.asarray(m)))
        got = normalize_points(_t(pc), None if m is None else _t(m)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
