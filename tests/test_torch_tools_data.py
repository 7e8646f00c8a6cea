"""The port's data-preparation and viz tools (``mrcc_tpu_torch.tools``)
against the JAX package's scripts (CPU).

Each JAX script is loaded by path (``scripts/*.py``, unchanged) and its
``main`` driven with ``sys.argv`` patched; the port's tool runs its
``main(argv)`` on its own copy of the same recorded set, written by the
JAX package's ``data.synthetic.write_sample_set`` (two position folders,
``p1_bright`` and ``p2_dark``).  Outputs are compared with the roots'
paths swapped:

- ``alivev2_splitter``: the split JSON equal (shuffled and temporal);
- ``consolidate_ee_poses``: the pose list, appended by a second run,
  bit-equal;
- ``change_base_pickle``: the re-based pickles loaded back, every array
  bit-equal but ``robot2ee_pose``, which is within 1e-6 (the composition
  rounds its f32 4 x 4 product otherwise than XLA's dot);
- ``instance_finder``: the same instance folders with the same files;
- ``eemask_extractor``: the EE masks bit-equal;
- ``pickle_picker``: the labelled JSON equal (``--auto``), and the arrays
  handed to ``save_cloud_png`` bit-equal (answers on stdin);
- ``data_stats``: the printed lines equal;
- ``viz_pickle``: the arrays handed to ``save_cloud_png`` bit-equal (RGB
  and ``--seg``), the port's PNG written;
- ``viz_analysis``: the ``errors`` / ``conf`` / ``embed`` returns equal;
- ``ycb_generate_point_cloud``: the PLY files of a synthetic two-view YCB
  folder byte for byte, and ``view_cloud`` against the JAX ``data.rgbd``
  pipeline of the script's ``process_view`` on a synthetic view.

Every tools module imports with ``jax``, ``flax``, ``optax`` and
``mrcc_tpu`` blocked (a subprocess), as on the card's machine.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from mrcc_tpu.data import rgbd as jrgbd
from mrcc_tpu.data.synthetic import generate_sample, write_sample_set
from mrcc_tpu_torch.tools import (alivev2_splitter, change_base_pickle,
                                  consolidate_ee_poses, data_stats,
                                  eemask_extractor, instance_finder,
                                  pickle_picker, viz_analysis, viz_pickle,
                                  ycb_generate_point_cloud)
from test_torch_viz import _results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("alivev2_splitter", "consolidate_ee_poses", "change_base_pickle",
         "instance_finder", "eemask_extractor", "pickle_picker",
         "data_stats", "viz_pickle", "viz_analysis",
         "ycb_generate_point_cloud", "play_icp", "play_ee_icp",
         "play_keypoints", "play_segmentation")
SMALL = dict(n_ee=300, n_arm=400, n_bg=500)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script(name, folder="scripts"):
    """The JAX package's script ``folder/name.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + [str(a) for a in argv])
    return mod.main()


def _recorded(root):
    """Two position folders of small samples under ``root``; returns the
    merged split dict."""
    a = write_sample_set(os.path.join(root, "p1_bright"), n=4, seed0=1,
                         **SMALL)
    b = write_sample_set(os.path.join(root, "p2_dark"), n=3, seed0=11,
                         **dict(SMALL, n_arm=250))
    return {k: a[k] + b[k] for k in a}


@pytest.fixture
def roots(tmp_path):
    """``(JAX script's root, port tool's root)``, each holding its own copy
    of the recorded set."""
    out = tmp_path / "jax", tmp_path / "port"
    for r in out:
        _recorded(str(r))
    return out


def _swap(obj, a, b):
    """``obj`` (JSON-like) with the string ``a`` replaced by ``b``."""
    return json.loads(json.dumps(obj).replace(str(a), str(b)))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_sample(got, want, skip=()):
    assert got.keys() == want.keys()
    for k in want:
        if k in skip:
            continue
        if want[k] is None or np.isscalar(want[k]):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------ 1-2. splits, poses

@pytest.mark.parametrize("temporal", [False, True])
def test_alivev2_splitter(roots, monkeypatch, temporal):
    jr, pr = roots
    flags = ["--seed", "3"] + (["--temporal"] if temporal else [])
    run_script(script("alivev2_splitter"),
               ["--infolder", jr, "--out", jr / "s.json"] + flags,
               monkeypatch)
    got = alivev2_splitter.main(["--infolder", str(pr), "--out",
                                 str(pr / "s.json")] + flags)
    want = json.loads((jr / "s.json").read_text())
    assert sum(map(len, want.values())) == 7 and want["train"]
    assert json.loads((pr / "s.json").read_text()) == got
    assert _swap(got, pr, jr) == want


def test_consolidate_ee_poses(roots, monkeypatch):
    jr, pr = roots
    for _ in range(2):  # the second run appends
        run_script(script("consolidate_ee_poses"),
                   ["--infolder", jr / "p1_bright", "--out", jr / "o.pkl"],
                   monkeypatch)
        got = consolidate_ee_poses.main(["--infolder", str(pr / "p1_bright"),
                                         "--out", str(pr / "o.pkl")])
    want = _load(jr / "o.pkl")
    assert len(want) == len(got) == 8
    for g, w, r in zip(_load(pr / "o.pkl"), want, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(r, w)


# -------------------------------------------------------- 3. change base

def test_change_base_pickle(roots, monkeypatch):
    jr, pr = roots
    rng = np.random.default_rng(4)
    for r in roots:  # the recorded robot2ee poses (XYZW)
        rng = np.random.default_rng(4)
        for path in sorted((r / "p1_bright" / "labeled").glob("*.pickle")):
            s = _load(path)
            q = rng.normal(size=4)
            s["robot2ee_pose"] = np.concatenate(
                [rng.normal(size=3) * 0.4, q / np.linalg.norm(q)]
            ).astype(np.float32)
            with open(path, "wb") as f:
                pickle.dump(s, f)
    base = ["0.1", "-0.2", "0.3", "0.1", "0.2", "-0.3", "0.9"]
    run_script(script("change_base_pickle"),
               [jr / "p1_bright" / "labeled", "--base-pose", *base],
               monkeypatch)
    written = change_base_pickle.main(
        [str(pr / "p1_bright" / "labeled"), "--base-pose", *base])
    assert len(written) == 4
    for path in written:
        got = _load(path)
        want = _load(path.replace(str(pr), str(jr)))
        _same_sample(got, want, skip=("robot2ee_pose",))
        assert got["robot2ee_pose"].dtype == want["robot2ee_pose"].dtype
        np.testing.assert_allclose(got["robot2ee_pose"],
                                   want["robot2ee_pose"], rtol=0, atol=1e-6)


# ------------------------------------------------------ 4. instance finder

def test_instance_finder(tmp_path, monkeypatch):
    """Frames at 3 positions in runs of 6, 2 and 5 (a run shorter than 5
    frames does not close its instance: the third run joins the second)."""
    positions = [0] * 6 + [1] * 2 + [2] * 5
    folders = {}
    for side in ("jax", "port"):
        rec = tmp_path / side / "rec"
        rec.mkdir(parents=True)
        for i, p in enumerate(positions):
            s = generate_sample(seed=i, **SMALL)
            s["pose"] = s["pose"].copy()
            s["pose"][:3] = [0.1 * p, 0.0, 1.0 + 0.002 * (i % 2)]
            with open(rec / f"{i + 1}.pickle", "wb") as f:
                pickle.dump(s, f)
        folders[side] = rec
    run_script(script("instance_finder"),
               ["--infolder", folders["jax"], "--outfolder",
                tmp_path / "jax" / "fold"], monkeypatch)
    got = instance_finder.main(["--infolder", str(folders["port"]),
                                "--outfolder", str(tmp_path / "port" / "fold")])
    assert [i for i, _ in got] == [0] * 6 + [1] * 7

    def tree(root):
        return sorted((os.path.relpath(d, root), sorted(f))
                      for d, _, f in os.walk(root) if f)

    want = tree(tmp_path / "jax" / "fold")
    assert tree(tmp_path / "port" / "fold") == want
    assert [d for d, _ in want] == ["p1", "p2"]
    for d, files in want:
        for f in files:
            assert ((tmp_path / "port" / "fold" / d / f).read_bytes()
                    == (tmp_path / "jax" / "fold" / d / f).read_bytes())


# ------------------------------------------------- 5-7. masks, labels, stats

def test_eemask_extractor(roots, monkeypatch):
    jr, pr = roots
    run_script(script("eemask_extractor"),
               ["--splits", jr / "p1_bright" / "sample_splits.json"],
               monkeypatch)
    written = eemask_extractor.main(
        ["--splits", str(pr / "p1_bright" / "sample_splits.json")])
    assert len(written) == 4
    for path in written:
        got, want = _load(path), _load(path.replace(str(pr), str(jr)))
        assert got.dtype == want.dtype and len(want) > 100
        np.testing.assert_array_equal(got, want)


def _unlabelled_splits(root):
    splits = _recorded_splits(root)
    for entries in splits.values():
        for e in entries:
            del e["position_eligibility"], e["orientation_eligibility"]
    path = root / "all.json"
    path.write_text(json.dumps(splits))
    return path


def _recorded_splits(root):
    out = {}
    for folder in ("p1_bright", "p2_dark"):
        s = json.loads((root / folder / "sample_splits.json").read_text())
        for k, v in s.items():
            out.setdefault(k, []).extend(v)
    return out


@pytest.mark.parametrize("flags", [["--auto", "300", "--every", "2"],
                                   ["--auto", "300", "--every", "1"]])
def test_pickle_picker_auto(roots, monkeypatch, flags):
    jr, pr = roots
    run_script(script("pickle_picker"),
               ["--splits", _unlabelled_splits(jr)] + flags, monkeypatch)
    got = pickle_picker.main(["--splits", str(_unlabelled_splits(pr))]
                             + flags)
    want = json.loads((jr / "all.json").read_text())
    assert json.loads((pr / "all.json").read_text()) == got
    assert _swap(got, pr, jr) == want
    marks = [e.get("position_eligibility") for v in want.values()
             for e in v]
    assert True in marks and False in marks


def _capture(monkeypatch, module, store):
    """Replace ``module.save_cloud_png`` with a recorder of its arrays."""
    def record(points, colors, path, **kw):
        store.append((np.array(points), np.array(colors), kw))
        return path

    monkeypatch.setattr(module, "save_cloud_png", record)


def test_pickle_picker_snapshots(roots, monkeypatch):
    """The interactive path (answers "y" / "n" on stdin), snapshots on."""
    from mrcc_tpu.utils import visualization as jvis
    from mrcc_tpu_torch.utils import visualization as vis

    jr, pr = roots
    answers = iter(["y", "n"] * 10)
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    want, got = [], []
    _capture(monkeypatch, jvis, want)
    _capture(monkeypatch, vis, got)
    run_script(script("pickle_picker"),
               ["--splits", _unlabelled_splits(jr), "--snapshots",
                jr / "snaps"], monkeypatch)
    answers = iter(["y", "n"] * 10)
    labelled = pickle_picker.main(["--splits", str(_unlabelled_splits(pr)),
                                   "--snapshots", str(pr / "snaps")])
    assert _swap(labelled, pr, jr) == json.loads(
        (jr / "all.json").read_text())
    assert len(got) == len(want) == 3   # the first entry of each split
    for (gp, gc, _), (wp, wc, _) in zip(got, want):
        assert len(wp) > 100
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)


def test_data_stats(roots, monkeypatch, capsys):
    jr, pr = roots
    path = jr / "p1_bright" / "sample_splits.json"
    run_script(script("data_stats"), [path], monkeypatch)
    want = capsys.readouterr().out.splitlines()
    got = data_stats.main([str(path)])
    assert capsys.readouterr().out.splitlines() == got == want
    assert len(want) == 3 and "class balance" in want[0]


# ------------------------------------------------------------ 8-9. viz

@pytest.mark.parametrize("seg", [False, True])
def test_viz_pickle(roots, monkeypatch, seg):
    from mrcc_tpu.utils import visualization as jvis

    jr, pr = roots
    sample = jr / "p1_bright" / "labeled" / "2.pickle"
    want, got = [], []
    _capture(monkeypatch, jvis, want)
    run_script(script("viz_pickle"),
               [sample, jr / "v.png"] + (["--seg"] if seg else []),
               monkeypatch)
    real = viz_pickle.save_cloud_png
    monkeypatch.setattr(
        viz_pickle, "save_cloud_png",
        lambda p, c, path: got.append((p, c)) or real(p, c, path))
    out = viz_pickle.main([str(sample), str(pr / "v.png")]
                          + (["--seg"] if seg else []))
    assert out == str(pr / "v.png") and os.path.getsize(out) > 1000
    (gp, gc), (wp, wc, _) = got[0], want[0]
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gc, wc)
    assert gc.shape == wp.shape


def test_viz_analysis(tmp_path, monkeypatch):
    res, splits = _results()
    emb = np.random.default_rng(1).normal(size=(12, 5)).astype(np.float32)
    files = {"r.json": res, "s.json": splits, "l.json": list("ab" * 6)}
    for name, obj in files.items():
        (tmp_path / name).write_text(json.dumps(obj))
    np.save(tmp_path / "e.npy", emb)
    mod = script("viz_analysis")
    cases = {
        "errors": ["--results", "r.json", "--splits", "s.json", "--out",
                   "{}_err.png"],
        "conf": ["--results", "r.json", "--out", "{}_conf.png"],
        "embed": ["--embeddings", "e.npy", "--labels", "l.json",
                  "--log_dir", "{}_proj"]}
    calls = {}
    for fn in ("error_histograms", "confidence_plots", "embedding_export"):
        real = getattr(mod, fn)
        monkeypatch.setattr(
            mod, fn, lambda *a, _r=real, _n=fn: calls.setdefault(
                _n, _r(*a)))
    for cmd, argv in cases.items():
        def at(side):
            return [str(tmp_path / a.format(side)) if "." in a or "{" in a
                    else a for a in argv]

        run_script(mod, [cmd] + at("j"), monkeypatch)
        got = viz_analysis.main([cmd] + at("p"))
        want = calls[{"errors": "error_histograms",
                      "conf": "confidence_plots",
                      "embed": "embedding_export"}[cmd]]
        if cmd == "embed":
            assert [os.path.basename(p) for p in got] == [
                os.path.basename(p) for p in want]
            for g, w in zip(got, want):
                assert open(g, "rb").read() == open(w, "rb").read()
        elif cmd == "errors":
            assert got == want and want
        else:
            assert got.keys() == want.keys() and want
            for k in want:
                for g, w in zip(got[k], want[k]):
                    np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ 10. YCB

def _ycb_view(rng, h=48, w=64):
    """A synthetic view's arrays: RGB, depth with an edge, the calibration
    (depth K, RGB K, depth scale, H_rgb_from_ref, H_ir_from_ref)."""
    rgb = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    depth = np.full((h, w), 9000.0) + rng.normal(0, 20, (h, w))
    depth[:, w // 2:] += 4000.0          # a discontinuity to filter
    depth[:3, :3] = 0.0                  # holes
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    k_rgb = k * np.array([[1.05], [1.05], [1]])
    h_ref = np.eye(4)
    h_ir = np.eye(4)
    h_ir[:3, 3] = [0.02, -0.01, 0.0]
    return rgb, depth, k, k_rgb, np.array(1.0), h_ref, h_ir


def test_ycb_view_pipeline():
    """``view_cloud`` against the JAX ``data.rgbd`` steps of the script's
    ``process_view``, with and without the discontinuity filter."""
    rgb, depth, k, k_rgb, scale, h_ref, h_ir = _ycb_view(
        np.random.default_rng(0))
    for filt in (True, False):
        d = jrgbd.filter_discontinuities(depth) if filt else depth
        reg = jrgbd.register_depth_map(
            d * scale * 1e-4, rgb.shape, k, k_rgb,
            h_ref @ np.linalg.inv(h_ir))
        want = jrgbd.depth_to_cloud(reg, rgb, k_rgb, organized=False)
        got = ycb_generate_point_cloud.view_cloud(
            rgb, depth, k, k_rgb, scale * 1e-4, h_ref, h_ir,
            filter_depth=filt)
        assert want.shape[1] > 1000
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ycb_generate_point_cloud(tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    imageio = pytest.importorskip("imageio")
    rng = np.random.default_rng(1)
    for side in ("jax", "port"):
        obj = tmp_path / side / "002_master_chef_can"
        obj.mkdir(parents=True)
        rng = np.random.default_rng(1)
        with h5py.File(obj / "calibration.h5", "w") as cal:
            for cam, angle in (("NP1", "0"), ("NP3", "9")):
                rgb, depth, k, k_rgb, scale, h_ref, h_ir = _ycb_view(rng)
                imageio.imwrite(obj / f"{cam}_{angle}.jpg", rgb)
                with h5py.File(obj / f"{cam}_{angle}.h5", "w") as f:
                    f["depth"] = depth
                cal[f"{cam}_depth_K"] = k
                cal[f"{cam}_rgb_K"] = k_rgb
                cal[f"{cam}_ir_depth_scale"] = scale
                cal[f"H_{cam}_from_NP5"] = h_ref
                cal[f"H_{cam}_ir_from_NP5"] = h_ir
    run_script(script("ycb_generate_point_cloud"), [tmp_path / "jax"],
               monkeypatch)
    assert ycb_generate_point_cloud.main([str(tmp_path / "port")]) == 2
    clouds = "002_master_chef_can/clouds"
    names = sorted(os.listdir(tmp_path / "jax" / clouds))
    assert names == ["pc_NP1_0.ply", "pc_NP3_9.ply"]
    assert sorted(os.listdir(tmp_path / "port" / clouds)) == names
    for n in names:
        assert ((tmp_path / "port" / clouds / n).read_bytes()
                == (tmp_path / "jax" / clouds / n).read_bytes())


# ----------------------------------------------------------- no JAX

BLOCKER = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "mrcc_tpu"):
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, Block())
import importlib
for name in sys.argv[1:]:
    importlib.import_module(f"mrcc_tpu_torch.tools.{name}")
print("ok", len(sys.argv) - 1)
"""


def test_tools_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", BLOCKER, *TOOLS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(TOOLS))]
    assert sorted(TOOLS) == sorted(
        f[:-3] for f in os.listdir(os.path.join(
            ROOT, "mrcc_tpu_torch", "tools"))
        if f.endswith(".py") and f != "__init__.py")
