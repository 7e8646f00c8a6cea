"""The port's display modules (``viz/``, ``utils/visualization.py``)
against the JAX package's ``mrcc_tpu.viz`` and
``mrcc_tpu.utils.visualization``:

- ``write_html_viewer`` (whole, subsampled, from tensors) and
  ``embedding_export`` write files byte for byte equal to JAX's;
- ``error_histograms`` / ``confidence_plots`` return JAX's curves and
  series, and every picture (these two, the eight ``viz_*`` viewers, and
  ``save_scene_snapshot``) decodes to the same pixels as JAX's (matplotlib's
  Agg renderer is deterministic for one input in one process);
- ``MainApp(snapshot_dir=...)`` draws each frame of its update loop;
- ``mrcc_tpu_torch.viz`` and ``utils.visualization`` import with
  ``matplotlib`` hidden (the card's machine has none), the HTML viewer
  still works there and a picture raises ``ImportError``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mrcc_tpu import viz as jviz
from mrcc_tpu.utils import visualization as jvis
from mrcc_tpu.viz import viewers as jviewers
from mrcc_tpu_torch import viz
from mrcc_tpu_torch.app.dto import PointCloudDTO, ResultDTO
from mrcc_tpu_torch.data.synthetic import generate_sample
from mrcc_tpu_torch.utils import visualization as vis
from mrcc_tpu_torch.viz import viewers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(path):
    import matplotlib.pyplot as plt

    return plt.imread(str(path))


def _same_picture(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape and pa.size > 10000
    np.testing.assert_array_equal(pa, pb)


def _results():
    rng = np.random.default_rng(0)
    res = {}
    for pos in ("p1", "p2"):
        for i in range(10):
            res[f"{pos}/{i}.pickle"] = {
                k: float(rng.uniform(0, hi)) for k, hi in (
                    ("dist_position", 0.05), ("dist_orientation", 0.5),
                    ("angle_diff", 0.4), ("dist", 0.1), ("confidence", 1),
                    ("position_confidence", 1),
                    ("orientation_confidence", 1))}
    splits = {"test": [
        {"filepath": f"/x/{i}.pickle", "position": pos,
         "arm_point_count": int(rng.integers(500, 60000))}
        for pos in ("p1", "p2") for i in range(10)]}
    return res, splits


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n,max_points", [(500, 200000), (5000, 1000)])
def test_html_viewer_bytes_match_jax(tmp_path, n, max_points):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.random((n, 3)).astype(np.float32)
    seg = rng.integers(0, 3, n)
    got = viz.write_html_viewer(str(tmp_path / "p.html"), torch.from_numpy(
        pts), torch.from_numpy(rgb), torch.from_numpy(seg),
        max_points=max_points, use_seg=True)
    want = jviz.write_html_viewer(str(tmp_path / "j.html"), pts, rgb, seg,
                                  max_points=max_points, use_seg=True)
    assert _read(got) == _read(want)
    bare = viz.write_html_viewer(str(tmp_path / "b.html"), pts)
    assert _read(bare) == _read(jviz.write_html_viewer(
        str(tmp_path / "jb.html"), pts))


def test_embedding_export_bytes_match_jax(tmp_path):
    emb = np.random.default_rng(1).normal(size=(12, 16)).astype(np.float32)
    labels = [f"cls{i % 3}" for i in range(12)]
    got = viz.embedding_export(torch.from_numpy(emb), labels,
                               str(tmp_path / "p"))
    want = jviz.embedding_export(emb, labels, str(tmp_path / "j"))
    for a, b in zip(got, want):
        assert _read(a) == _read(b)


def test_analysis_plots_match_jax(tmp_path):
    res, splits = _results()
    got = viz.error_histograms(res, splits, str(tmp_path / "p_err.png"))
    want = jviz.error_histograms(res, splits, str(tmp_path / "j_err.png"))
    assert got == want
    _same_picture(tmp_path / "p_err.png", tmp_path / "j_err.png")
    got = viz.confidence_plots(res, str(tmp_path / "p_conf.png"))
    want = jviz.confidence_plots(res, str(tmp_path / "j_conf.png"))
    assert set(got) == set(want)
    for k in got:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)
    _same_picture(tmp_path / "p_conf.png", tmp_path / "j_conf.png")


def _sample(seed=11):
    return generate_sample(seed=seed, n_ee=256, n_arm=256, n_bg=512)


def _viewer_calls():
    s = _sample()
    pred = np.asarray(s["labels"]).astype(int).copy()
    pred[:50] = 0
    return [
        ("viz_segmentation", (s,), dict(pred_labels=pred)),
        ("viz_segmentation", (s,), dict(roi_mask=np.asarray(
            s["points"])[:, 2] > 0.8)),
        ("viz_ee_bbox", (s,), {}),
        ("viz_pcd", (np.asarray(s["points"]),), {}),
        ("viz_pickle", (s,), dict(keypoints=np.asarray(s["points"])[:6])),
        ("viz_cross_section", (s,), {}),
        ("viz_data_instances", ([_sample(1), _sample(2)],), {}),
        ("viz_data_collection_positions", ([_sample(i) for i in range(4)],),
         {}),
    ]


@pytest.mark.parametrize("i", range(8))
def test_viewers_match_jax(tmp_path, i):
    name, args, kw = _viewer_calls()[i]
    got = getattr(viewers, name)(*args, str(tmp_path / "p.png"), **kw)
    want = getattr(jviewers, name)(*args, str(tmp_path / "j.png"), **kw)
    if isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, want)
    _same_picture(tmp_path / "p.png", tmp_path / "j.png")


def test_generate_colors_match_jax():
    np.testing.assert_array_equal(viewers.generate_colors(7),
                                  jviewers.generate_colors(7))


def _frame_and_result():
    s = _sample(5)
    data = PointCloudDTO(points=s["points"], rgb=s["rgb"], id="f1")
    q = s["pose"][3:]
    result = ResultDTO(segmentation=np.asarray(s["labels"], np.int32),
                       ee_pose=np.concatenate([s["pose"][:3], q[3:], q[:3]]),
                       key_points=[(k, s["points"][k * 10]) for k in range(6)])
    return data, result


def test_scene_snapshot_matches_jax(tmp_path):
    data, result = _frame_and_result()
    vis.save_scene_snapshot(data, result, str(tmp_path / "p.png"),
                            max_points=500)
    jvis.save_scene_snapshot(data, result, str(tmp_path / "j.png"),
                             max_points=500)
    _same_picture(tmp_path / "p.png", tmp_path / "j.png")
    no_pose = ResultDTO(segmentation=None)
    vis.save_scene_snapshot(data, no_pose, str(tmp_path / "p0.png"))
    jvis.save_scene_snapshot(data, no_pose, str(tmp_path / "j0.png"))
    _same_picture(tmp_path / "p0.png", tmp_path / "j0.png")


def test_main_app_writes_snapshots(tmp_path):
    from mrcc_tpu_torch.app.main import MainApp

    data, result = _frame_and_result()

    class Source:
        frames = [data]

        def get(self):
            return self.frames.pop() if self.frames else None

    class Engine:
        def predict(self, d):
            return result

    app = MainApp(Source(), engine=Engine(), snapshot_dir=str(tmp_path / "s"))
    assert app.step() is result
    assert app.step() is None
    vis.save_scene_snapshot(data, result, str(tmp_path / "want.png"))
    _same_picture(tmp_path / "s" / "frame_f1.png", tmp_path / "want.png")


def test_viz_imports_without_matplotlib(tmp_path):
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import mrcc_tpu_torch.viz as viz\n"
        "import mrcc_tpu_torch.viz.viewers as viewers\n"
        "import mrcc_tpu_torch.utils.visualization\n"
        "import mrcc_tpu_torch.app.main\n"
        f"viz.write_html_viewer({str(tmp_path / 'v.html')!r},"
        " np.zeros((4, 3)))\n"
        "try:\n"
        f"    viewers.viz_pcd(np.ones((4, 3)), {str(tmp_path / 'x.png')!r})\n"
        "except ImportError:\n"
        "    print('no matplotlib')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no matplotlib"
    assert (tmp_path / "v.html").exists()
