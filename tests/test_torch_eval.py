"""The port's evaluation harnesses, report and BenchmarkApp vs the JAX
package's (CPU, f32).

The same seeded sample pickles feed both packages' ``AliveV2Dataset``; the
JAX model's variables (its own init on a sample, as the JAX test mains
make them) load into the port's model through ``load_jax_variables``.
The JAX harness runs its jitted forward on the ``"xla"`` hierarchy, the
port's the rank-kernel tables and the k3-table conv (plain twins here).

Tolerances: per-instance segmentation accuracy, precision and recall
within 1e-6 (labels equal; a label flip would move them by more than
1e-4 at these point counts); pose, keypoint and centre distances within
1e-5 relative; keypoint ``found`` counts equal.  ``write_report`` writes
the same JSON (and the same csv where openpyxl is missing).
``BenchmarkApp``: ``test_torch_eval_app.py``.
"""

import json

import jax
import pytest
import torch

from mrcc_tpu.cli.test_mains import _init_on_sample
from mrcc_tpu.data.dataset import AliveV2Dataset as JaxDataset
from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.eval import harness as JH
from mrcc_tpu.eval.report import write_report as jax_write_report
from mrcc_tpu.models import RobotNet as JaxRobotNet
from mrcc_tpu.models import RobotNetSegmentation as JaxSeg
from mrcc_tpu.models import RobotNetVote as JaxVote
from mrcc_tpu_torch.data.dataset import AliveV2Dataset, DataConfig
from mrcc_tpu_torch.data.synthetic import write_sample_set
from mrcc_tpu_torch.eval import harness as H
from mrcc_tpu_torch.eval.report import write_report
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import RobotNet, RobotNetSegmentation, RobotNetVote


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAP = 1024


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    splits = write_sample_set(root, n=6, seed0=21, n_ee=400, n_arm=500,
                              n_bg=600)
    return splits["train"]


def _datasets(entries, **kw):
    kw = dict(dict(max_points=2048, scale=200.0), **kw)
    return (AliveV2Dataset(files=entries, cfg=DataConfig(**kw)),
            JaxDataset(files=entries, cfg=JaxDataConfig(**kw)))


def _pair(jmod, port, jds):
    variables = jax.device_get(_init_on_sample(None, jmod, jds, cap=CAP)())
    load_jax_variables(port, variables)
    return variables, port


def _close(a, b, rtol=1e-5):
    assert abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30), (a, b)


def test_evaluate_segmentation_matches_jax(entries, tmp_path):
    ds, jds = _datasets(entries, data_type=None)
    variables, port = _pair(JaxSeg(backbone="minkunet14A", in_channels=3,
                                   num_classes=3),
                            RobotNetSegmentation(backbone="minkunet14A",
                                                 in_channels=3,
                                                 num_classes=3), jds)
    kw = dict(voxel_capacity=CAP, batch_size=2)
    want = JH.evaluate_segmentation(
        JaxSeg(backbone="minkunet14A", in_channels=3, num_classes=3),
        variables, jds, out_path=str(tmp_path / "j.json"), **kw)
    got = H.evaluate_segmentation(port, ds, out_path=str(tmp_path / "p.json"),
                                  device="cpu", **kw)
    assert len(got["instances"]) == len(want["instances"]) == len(entries)
    for g, w in zip(got["instances"], want["instances"]):
        assert g.keys() == w.keys() and g["file"] == w["file"]
        for k in ("accuracy", "precision", "recall"):
            assert abs(g[k] - w[k]) <= 1e-6, k
        assert g["class_results"].keys() == w["class_results"].keys()
    assert got["overall"].keys() == want["overall"].keys()
    with open(tmp_path / "p.json") as f:
        assert json.load(f).keys() == want.keys()


def test_evaluate_pose_matches_jax(entries):
    ds, jds = _datasets(entries)
    variables, port = _pair(JaxRobotNet(backbone="minkunet14A",
                                        out_channels=7),
                            RobotNet(backbone="minkunet14A", out_channels=7),
                            jds)
    want = JH.evaluate_pose(JaxRobotNet(backbone="minkunet14A",
                                        out_channels=7), variables, jds,
                            voxel_capacity=CAP, batch_size=3)
    got = H.evaluate_pose(port, ds, voxel_capacity=CAP, batch_size=3,
                          device="cpu")
    for g, w in zip(got["instances"], want["instances"]):
        assert g["position"] == w["position"]
        for k in ("dist", "dist_position", "dist_orientation", "angle_diff"):
            _close(g[k], w[k])
    assert got["positions"].keys() == want["positions"].keys()
    assert got["overall"].keys() == want["overall"].keys()


def test_evaluate_key_points_matches_jax(entries):
    ds, jds = _datasets(entries, keypoints_enabled=True, scale=800.0)
    variables, port = _pair(JaxSeg(backbone="minkunet14A", in_channels=3,
                                   num_classes=6),
                            RobotNetSegmentation(backbone="minkunet14A",
                                                 in_channels=3,
                                                 num_classes=6), jds)
    # a low gate: a random net's keypoint probabilities are near 1 / 6
    kw = dict(voxel_capacity=CAP, batch_size=3, conf_threshold=0.17)
    want = JH.evaluate_key_points(JaxSeg(backbone="minkunet14A",
                                         in_channels=3, num_classes=6),
                                  variables, jds, **kw)
    got = H.evaluate_key_points(port, ds, device="cpu", **kw)
    assert len(got["instances"]) == len(want["instances"]) > 0
    assert any(w["found"] for w in want["instances"])
    for g, w in zip(got["instances"], want["instances"]):
        assert g["found"] == w["found"]
        _close(g["kp_error"], w["kp_error"])


def test_evaluate_vote_matches_jax(entries):
    ds, jds = _datasets(entries, voting_enabled=True)
    variables, port = _pair(JaxVote(backbone="minkunet14A", in_channels=3,
                                    num_classes=2),
                            RobotNetVote(backbone="minkunet14A",
                                         in_channels=3, num_classes=2), jds)
    want = JH.evaluate_vote(JaxVote(backbone="minkunet14A", in_channels=3,
                                    num_classes=2), variables, jds,
                            voxel_capacity=CAP, batch_size=3, ee_r=0.02)
    got = H.evaluate_vote(port, ds, voxel_capacity=CAP, batch_size=3,
                          ee_r=0.02, device="cpu")
    for g, w in zip(got["instances"], want["instances"]):
        _close(g["center_dist"], w["center_dist"])


def test_write_report_matches_jax(tmp_path):
    metrics = {"nn_translation_m": [0.01, 0.02, 0.03],
               "nn_rotation_rad": [0.1, None, float("nan")],
               "seg_ee_precision": [0.9, 0.95, 0.85], "empty": []}
    pos = {"p1": {"nn_translation_m": [0.01]},
           "p2": {"nn_translation_m": [0.02, 0.03]}}
    extra = {"calibration": {"translation_m": 0.1}}
    got_path, got = write_report(metrics, str(tmp_path / "a" / "r.xlsx"),
                                 extra=extra, position_metrics=pos)
    want_path, want = jax_write_report(metrics, str(tmp_path / "b" / "r.xlsx"),
                                       extra=extra, position_metrics=pos)
    assert got == want
    assert got_path.rsplit(".", 1)[1] == want_path.rsplit(".", 1)[1]
    with open(tmp_path / "a" / "r.json") as a, \
            open(tmp_path / "b" / "r.json") as b:
        assert a.read() == b.read()
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        if got_path.endswith(".csv"):
            assert a.read() == b.read()
