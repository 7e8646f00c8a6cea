"""The port's host runtime (``mrcc_tpu_torch.native``: ``runtime/
voxelizer.cpp`` built at first use with the host compiler) against its
numpy twins, the JAX package's ``mrcc_tpu.native`` (its library where it
was built, else its numpy branches) and the port's own voxelizer, as
``tests/test_native.py`` holds the JAX one:

- voxelize: the same voxel set, feature means within 1e-5 (the library
  sums in f32, the twin in f64), labels exact (``ignore_label`` where a
  voxel's points disagree), ``point_to_voxel`` naming each point's voxel,
  and overflow past ``capacity``;
- FPS: indices equal to the twin's and the JAX package's;
- the ball query: equal to the twin's and the JAX package's, first hits
  in index order, missing slots filled with the first hit;
- the build: one library a source, and a compiler error raised with its
  log.
"""

import numpy as np
import pytest
import torch

from mrcc_tpu import native as jax_native
from mrcc_tpu_torch import native
from mrcc_tpu_torch.sparse import voxelize


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n=2000):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    labels[: n // 2] = 1  # voxels whose points agree
    return pts, feats, labels


def _table(res):
    coords, f, lab, _, nv = res
    return {tuple(coords[i]): (f[i], None if lab is None else int(lab[i]))
            for i in range(nv)}


def _same_voxels(got, want, atol=1e-5):
    assert got[4] == want[4]
    tg, tw = _table(got), _table(want)
    assert set(tg) == set(tw)
    for k in tg:
        np.testing.assert_allclose(tg[k][0], tw[k][0], atol=atol)
        assert tg[k][1] == tw[k][1]


@pytest.mark.parametrize("capacity", [4096, 300])  # 300 overflows
@pytest.mark.parametrize("with_labels", [True, False])
def test_voxelize_matches_twin_and_jax(capacity, with_labels):
    pts, feats, labels = _cloud(capacity)
    lab = labels if with_labels else None
    got = native.voxelize_host(pts, feats, 0.05, capacity, labels=lab)
    plain = native.voxelize_host_plain(pts, feats, 0.05, capacity,
                                       labels=lab)
    _same_voxels(got, plain)
    _same_voxels(got, jax_native.voxelize_host(pts, feats, 0.05, capacity,
                                               labels=lab))
    coords, _, vlab, pv, nv = got
    if capacity == 300:
        assert nv == 300 and (pv == 300).any()
    kept = pv < nv
    want = np.floor(pts / 0.05).astype(np.int32)
    np.testing.assert_array_equal(coords[pv[kept]], want[kept])
    if with_labels:
        assert (vlab == -100).any() and (vlab >= 0).any()
    # the twin's point map agrees wherever both kept the point
    both = kept & (plain[3] < nv)
    np.testing.assert_array_equal(plain[0][plain[3][both]],
                                  coords[pv[both]])


def test_voxelize_matches_port_voxelizer():
    pts, feats, labels = _cloud(5, n=800)
    coords_h, feats_h, labels_h, _, nv = native.voxelize_host(
        pts, feats, 0.05, 2048, labels=labels)
    vox, _, vlab = voxelize(torch.from_numpy(pts[None]),
                            torch.from_numpy(feats[None]),
                            torch.ones((1, 800), dtype=torch.bool), 0.05,
                            2048, labels=torch.from_numpy(labels[None]))
    nd = int(vox.count[0])
    assert nv == nd
    dc = vox.coords()[0].numpy()
    dev = {tuple(dc[i]): (vox.feats[0, i].numpy(), int(vlab[0, i]))
           for i in range(nd)}
    for i in range(nv):
        k = tuple(coords_h[i])
        assert k in dev
        np.testing.assert_allclose(feats_h[i], dev[k][0], atol=1e-5)
        assert labels_h[i] == dev[k][1]


@pytest.mark.parametrize("start", [0, 17])
def test_fps_matches_twin_and_jax(start):
    pts = np.random.default_rng(3).normal(size=(300, 3)).astype(np.float32)
    got = native.fps_host(pts, 32, start_idx=start)
    assert got.dtype == np.int32 and got[0] == start
    np.testing.assert_array_equal(got, native.fps_host_plain(
        pts, 32, start_idx=start))
    np.testing.assert_array_equal(got, jax_native.fps_host(
        pts, 32, start_idx=start))
    assert len(np.unique(got)) == 32


@pytest.mark.parametrize("radius", [0.05, 0.4])
def test_ball_query_matches_twin_and_jax(radius):
    pts = np.random.default_rng(4).uniform(-1, 1, (400, 3)).astype(
        np.float32)
    queries = np.concatenate([pts[:8], [[5.0, 5.0, 5.0]]]).astype(np.float32)
    got = native.ball_query_host(pts, queries, radius, 8)
    np.testing.assert_array_equal(got, native.ball_query_host_plain(
        pts, queries, radius, 8))
    np.testing.assert_array_equal(got, jax_native.ball_query_host(
        pts, queries, radius, 8))
    np.testing.assert_array_equal(got[-1], 0)  # an empty ball
    d2 = ((queries[:, None] - pts[None]) ** 2).sum(-1)
    for q in range(8):
        within = np.flatnonzero(d2[q] < radius ** 2)[:8]
        np.testing.assert_array_equal(got[q, :len(within)], within)
        assert (got[q, len(within):] == within[0]).all()


def test_build_is_cached_and_reports_errors(tmp_path, monkeypatch):
    path = native.build()
    assert path.exists() and path == native.library_path()
    assert native.build() == path  # built once
    bad = tmp_path / "voxelizer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="voxelizer.cpp failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
