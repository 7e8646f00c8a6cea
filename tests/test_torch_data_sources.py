"""The port's data sources vs the JAX package's (CPU, numpy only).

- ``write_sample_set`` writes the same pickles byte for byte and the same
  split JSON (paths aside), and each package reads the other's samples to
  the same arrays;
- ``AliveV1Dataset`` items (tuple pickles, XYZW -> WXYZ, the full-scale
  crop, the file filter) equal the JAX items;
- ``rgbd``: discontinuity filter, depth registration, organised and flat
  unprojection equal elementwise, ``write_ply`` writes the same text, and
  ``read_pcd`` reads ascii and binary PCD files (NaN points dropped) to
  the same arrays;
- ``PickleDataEngine`` (``get``, ``get_raw`` with and without the EE
  relabel, cyclic and not) and ``DirectoryDataEngine`` (``.pcd`` with pose
  sidecars, ``.pickle``, ``_points.npy`` / ``_rgb.npy`` pairs) give the
  JAX engines' frames field for field.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from mrcc_tpu.app.calibrate_pcd import DirectoryDataEngine as JaxDirectory
from mrcc_tpu.app.data_engine import PickleDataEngine as JaxPickleEngine
from mrcc_tpu.data import alivev1 as jax_v1
from mrcc_tpu.data import rgbd as jax_rgbd
from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.data.dataset import load_sample as jax_load_sample
from mrcc_tpu.data.synthetic import write_sample_set as jax_write
from mrcc_tpu_torch.app import PickleDataEngine
from mrcc_tpu_torch.app.calibrate_pcd import DirectoryDataEngine
from mrcc_tpu_torch.data import alivev1, rgbd
from mrcc_tpu_torch.data.dataset import DataConfig, load_sample
from mrcc_tpu_torch.data.synthetic import write_sample_set

SAMPLE_KW = dict(n_ee=300, n_arm=400, n_bg=500)


@pytest.fixture(scope="module")
def sample_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sets")
    port = write_sample_set(root / "port", n=4, seed0=3, **SAMPLE_KW)
    jax = jax_write(root / "jax", n=4, seed0=3, **SAMPLE_KW)
    return root, port, jax


def _equal(a, b, key=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            _equal(a[k], b[k], f"{key}/{k}")
    elif a is None or isinstance(a, (str, int, float, bool)):
        assert a == b, key
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=key)


def test_write_sample_set_matches_jax(sample_sets):
    root, port, jax = sample_sets
    assert json.dumps(port).replace(str(root / "port"), "") == \
        json.dumps(jax).replace(str(root / "jax"), "")
    with open(root / "port" / "sample_splits.json") as f:
        assert json.load(f) == port
    for e_p, e_j in zip(port["train"] + port["val"] + port["test"],
                        jax["train"] + jax["val"] + jax["test"]):
        with open(e_p["filepath"], "rb") as a, \
                open(e_j["filepath"], "rb") as b:
            assert a.read() == b.read()
        # either package reads the other's files
        _equal(load_sample(e_j["filepath"]), jax_load_sample(e_p["filepath"]))


def _v1_folder(root):
    """Tuple pickles with XYZW poses (points partly outside the v1 grid),
    a dict pickle, and files the filter drops."""
    rng = np.random.default_rng(0)
    folder = root / "v1" / "train"
    folder.mkdir(parents=True)
    for i in range(3):
        n = 400
        pts = (rng.normal(size=(n, 3)) * (0.5 + i)).astype(np.float32)
        x = (pts, rng.random((n, 3)).astype(np.float32),
             rng.integers(0, 3, n).astype(np.float32),
             rng.integers(0, 5, n).astype(np.float32),
             rng.normal(size=7).astype(np.float32))
        with open(folder / f"s{i}.pickle", "wb") as f:
            pickle.dump(x, f)
    with open(folder / "s9.pickle", "wb") as f:
        pickle.dump({"points": pts, "rgb": x[1], "labels": x[2],
                     "pose": x[4]}, f)
    for name in ("s0_semantic.pickle", "dark_s5.pickle"):
        with open(folder / name, "wb") as f:
            pickle.dump(x, f)
    return root / "v1"


def test_alivev1_items_match_jax(tmp_path):
    folder = _v1_folder(tmp_path)
    kw = dict(scale=200.0, max_points=300, data_type=None)
    ds = alivev1.AliveV1Dataset(folder=str(folder), cfg=DataConfig(**kw))
    want = jax_v1.AliveV1Dataset(folder=str(folder), cfg=JaxDataConfig(**kw))
    assert len(ds) == len(want) == 4
    assert [f["filepath"] for f in ds.files] == [f["filepath"]
                                                for f in want.files]
    for i in range(len(ds)):
        _equal(ds[i], want[i])
    for name in ("a/b_semantic.pickle", "a/dark1.pickle", "a/x.pickle"):
        for prefix in ("", "x"):
            assert alivev1.filter_filename(name, prefix) == \
                jax_v1.filter_filename(name, prefix)
    batch = ds.collate([ds[i] for i in range(len(ds))])
    assert batch["points"].shape == (4, 300, 3)


def test_rgbd_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    depth = rng.uniform(500, 1500, (40, 50))
    depth[10:20, 10:25] += 2000         # a step: discontinuous edges
    depth[rng.random(depth.shape) < 0.05] = 0
    _equal(rgbd.filter_discontinuities(depth),
           jax_rgbd.filter_discontinuities(depth))
    k = np.array([[60.0, 0, 25], [0, 60.0, 20], [0, 0, 1]])
    h = np.eye(4)
    h[:3, 3] = [20.0, -5.0, 3.0]
    _equal(rgbd.register_depth_map(depth, (40, 50, 3), k, k * 1.1, h),
           jax_rgbd.register_depth_map(depth, (40, 50, 3), k, k * 1.1, h))
    rgb = rng.integers(0, 255, (40, 50, 3))
    mask = rng.random(depth.shape) < 0.1
    for organized in (True, False):
        _equal(rgbd.depth_to_cloud(depth, rgb, k, organized, mask),
               jax_rgbd.depth_to_cloud(depth, rgb, k, organized, mask))
    cloud = rgbd.depth_to_cloud(depth, rgb, k, organized=False)
    rgbd.write_ply(tmp_path / "a.ply", cloud)
    jax_rgbd.write_ply(tmp_path / "b.ply", cloud)
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()


def _write_pcd(path, pts, rgb, binary):
    packed = ((rgb[:, 0].astype(np.uint32) << 16)
              | (rgb[:, 1].astype(np.uint32) << 8)
              | rgb[:, 2].astype(np.uint32))
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\n"
              "TYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {len(pts)}\nDATA {'binary' if binary else 'ascii'}\n")
    rows = np.concatenate([pts.astype(np.float32),
                           packed.view(np.float32)[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(rows.astype(np.float32).tobytes())
        else:
            for r in rows:
                f.write((" ".join(repr(float(v)) for v in r) + "\n").encode())


@pytest.mark.parametrize("binary", [False, True])
def test_read_pcd_matches_jax(tmp_path, binary):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[[3, 17]] = np.nan
    rgb = rng.integers(0, 256, (50, 3))
    path = tmp_path / "a.pcd"
    _write_pcd(path, pts, rgb, binary)
    got, want = rgbd.read_pcd(str(path)), jax_rgbd.read_pcd(str(path))
    _equal(got, want)
    assert got[0].shape == (48, 3)
    np.testing.assert_allclose(got[1] * 255.0, np.delete(rgb, [3, 17], 0),
                               atol=1e-3)


def _frame(dto):
    return {f.name: getattr(dto, f.name) for f in dataclasses.fields(dto)
            if f.name != "timestamp"}


def test_pickle_data_engine_matches_jax(sample_sets, tmp_path):
    root, port, _ = sample_sets
    split = str(root / "port" / "sample_splits.json")
    # a sample without EE labels: get_raw relabels its EE box
    entry = port["train"][0]
    s = load_sample(entry["filepath"])
    s["labels"] = np.where(s["labels"] == 2, 1, s["labels"]).astype(
        s["labels"].dtype)
    bare = tmp_path / "bare.pickle"
    with open(bare, "wb") as f:
        pickle.dump(s, f)
    extra = tmp_path / "extra.json"
    extra.write_text(json.dumps({"train": [{"filepath": str(bare),
                                            "position": "p9"}]}))
    paths = f"{split},{extra}"
    for cyclic in (True, False):
        eng = PickleDataEngine(paths, split="train", cyclic=cyclic)
        want = JaxPickleEngine(paths, split="train", cyclic=cyclic)
        n = len(eng.entries)
        assert n == len(want.entries) == len(port["train"]) + 1
        for _ in range(n + 1 if cyclic else n):
            _equal(_frame(eng.get()), _frame(want.get()))
        if not cyclic:
            assert eng.get() is None and want.get() is None
    eng = PickleDataEngine(paths, split="train")
    want = JaxPickleEngine(paths, split="train")
    for _ in range(len(eng.entries)):
        got, ref = _frame(eng.get_raw()), _frame(want.get_raw())
        _equal(got, ref)
    assert (got["labels"] == 2).any()     # the relabelled sample
    with pytest.raises(AssertionError):
        PickleDataEngine(split, split="nope")


def test_directory_data_engine_matches_jax(sample_sets, tmp_path):
    root, port, _ = sample_sets
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        _write_pcd(d / f"c{i}.pcd", rng.normal(size=(30, 3)),
                   rng.integers(0, 256, (30, 3)), binary=bool(i))
    np.save(d / "c0_pose.npy", rng.normal(size=7).astype(np.float32))
    for e in port["test"] + port["val"]:
        with open(e["filepath"], "rb") as a, \
                open(d / os.path.basename(e["filepath"]), "wb") as b:
            b.write(a.read())
    for i in range(2):
        np.save(d / f"n{i}_points.npy", rng.normal(size=(20, 3)))
        np.save(d / f"n{i}_rgb.npy", rng.random((20, 3)))
    np.save(d / "n1_pose.npy", rng.normal(size=7).astype(np.float32))
    eng, want = DirectoryDataEngine(str(d)), JaxDirectory(str(d))
    count = 0
    while True:
        got, ref = eng.get(), want.get()
        if ref is None:
            assert got is None
            break
        _equal(_frame(got), _frame(ref))
        count += 1
    assert count == 6
