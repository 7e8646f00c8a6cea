"""The port's entry mains on the CPU: the test mains through a ``Config``,
a train main's ``Config`` form and the checkpoint it leaves, ``python -m
mrcc_tpu_torch.cli``, ``MainApp`` and ``calibrate_directory``.

The results are checked for their structure and against the port's own
harness on the same weights (the numbers' parity with the JAX harness is
``test_torch_eval.py``'s)."""

import json
import os

import numpy as np
import pytest
import torch

from mrcc_tpu_torch.app import (CalibrationResultDTO, InferenceConfig,
                                InferenceEngine, ResultDTO,
                                SyntheticDataEngine)
from mrcc_tpu_torch.app.calibrate_pcd import calibrate_directory
from mrcc_tpu_torch.app.main import MainApp
from mrcc_tpu_torch.cli import test_mains, train_mains
from mrcc_tpu_torch.cli.__main__ import MAINS
from mrcc_tpu_torch.cli.__main__ import main as cli_main
from mrcc_tpu_torch.cli.common import (exp_name_of, make_datasets,
                                       select_pose_model)
from mrcc_tpu_torch.config import Config
from mrcc_tpu_torch.data.synthetic import generate_sample, write_sample_set
from mrcc_tpu_torch.eval import evaluate_vote
from mrcc_tpu_torch.models import RobotNetEncode, RobotNetVote
from mrcc_tpu_torch.train.checkpoint import latest_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SAMPLE_KW = dict(n_ee=400, n_arm=500, n_bg=700)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    write_sample_set(d, n=5, **SAMPLE_KW)
    return d


def _cfg(tmp_path, dataset_dir, **structure):
    return Config(overrides={
        "DATA": {"file_names": str(dataset_dir / "sample_splits.json"),
                 "batch_size": 2, "max_npoint": 2048, "scale": 200},
        "STRUCTURE": {"backbone": "minkunet14A", **structure},
        "TRAIN": {"epochs": 1, "lr": 1e-3}}, exp_path=str(tmp_path / "exp"))


@pytest.mark.parametrize("name,keys,result", [
    ("test_segmentation", ("accuracy", "precision", "recall"),
     "result_segmentation_test.json"),
    ("test_vote", ("center_dist",), "result_vote_test.json"),
    ("test_pose", ("dist_position", "angle_diff"), "result_test.json"),
    ("test_key_points", ("kp_error",), "result_key_points_test.json"),
])
def test_test_mains_on_the_cpu(name, keys, result, tmp_path, dataset_dir):
    cfg = _cfg(tmp_path, dataset_dir)
    res = getattr(test_mains, name)(cfg, device="cpu")
    assert tuple(res["overall"]) == keys
    for k in keys:
        assert res["overall"][k]["count"] == len(res["instances"])
    with open(tmp_path / "exp" / result) as f:
        assert json.load(f)["overall"] == res["overall"]


def test_feature_extractor_main(tmp_path, dataset_dir):
    res = test_mains.test_feature_extractor(_cfg(tmp_path, dataset_dir),
                                            device="cpu")
    assert set(res) == {"recall@1"} and 0.0 <= res["recall@1"] <= 1.0


def test_train_main_config_form_and_its_checkpoint(tmp_path, dataset_dir):
    """``train_vote(cfg)`` trains on the train split and saves
    ``{config name}-000000001.ckpt``; ``test_vote(cfg)`` evaluates those
    weights (the harness on the loaded model gives the same records)."""
    cfg = _cfg(tmp_path, dataset_dir)
    hist = train_mains.train_vote(cfg, epochs=1, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert hist[0]["batches"] == 2           # 3 train samples, batch 2
    path = latest_checkpoint(cfg.exp_path, exp_name_of(cfg))
    assert path and path.endswith("default-000000001.ckpt")
    res = test_mains.test_vote(cfg, device="cpu")
    model = RobotNetVote(backbone="minkunet14A", in_channels=3,
                         num_classes=2)
    model.load_state_dict(torch.load(path, weights_only=True)["model"])
    data_cfg = cfg.data_config()
    data_cfg.voting_enabled = True
    want = evaluate_vote(model, make_datasets(cfg, data_cfg,
                                              splits=("test",)),
                         device="cpu")
    assert res["instances"] == want["instances"]
    # an explicit TEST.checkpoint wins over the newest file
    cfg()["TEST"]["checkpoint"] = path
    assert test_mains.test_vote(cfg, device="cpu")["instances"] == \
        want["instances"]


def test_pose_main_config_form(tmp_path, dataset_dir):
    cfg = _cfg(tmp_path, dataset_dir, encode_only=True)
    assert isinstance(select_pose_model(cfg), RobotNetEncode)
    hist = train_mains.train_pose(cfg, epochs=1, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])


def test_cli_module(tmp_path, dataset_dir):
    override = tmp_path / "tiny.yaml"
    override.write_text(json.dumps({
        "DATA": {"file_names": str(dataset_dir / "sample_splits.json"),
                 "max_npoint": 2048, "scale": 200},
        "STRUCTURE": {"backbone": "minkunet14A"}}))
    res = cli_main(["test_segmentation", "--device", "cpu", "--override",
                    str(override), "--exp_path", str(tmp_path / "e")])
    assert set(res["overall"]) == {"accuracy", "precision", "recall"}
    assert os.path.isfile(tmp_path / "e" / "result_segmentation_test.json")
    assert {"test", "app_test", "train_segmentation"} <= set(MAINS)


def test_missing_split_file_bootstraps_a_sample_set(tmp_path):
    cfg = Config(overrides={"DATA": {
        "file_names": str(tmp_path / "boot" / "sample_splits.json")}})
    train, val = make_datasets(cfg)
    assert len(train) == 4 and len(val) == 1
    assert os.path.isfile(tmp_path / "boot" / "labeled" / "6.pickle")


ENGINE = dict(point_capacity=2048, seg_voxel_capacity=1024,
              seg_hierarchy_caps=(512, 256, 128, 128),
              ee_point_capacity=512, ee_voxel_capacity=512,
              ee_hierarchy_caps=(256, 128, 128, 128), kp_voxel_capacity=512,
              kp_hierarchy_caps=(384, 256, 128, 128),
              seg_backbone="minkunet14A", rot_backbone="minkunet14A",
              kp_backbone="minkunet14A", icp_iterations=3,
              icp_template_points=128, ee_point_counts_threshold=1,
              sanity_min_num_of_ee_points=1)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(InferenceConfig(**ENGINE), device="cpu")


def test_main_app_session(engine, tmp_path):
    source = SyntheticDataEngine(n_positions=3, frames_per_position=2,
                                 seed=70, **SAMPLE_KW)
    app = MainApp(source, engine=engine, num_of_frames=2,
                  min_num_of_positions=3)
    calib = app.run()
    assert sorted(app.collected) == ["p1", "p2", "p3"]
    assert all(len(v) == 2 for v in app.collected.values())
    # random nets find no confident frame: the session's calibration is
    # the engine's over the collected results (here empty)
    assert isinstance(calib, CalibrationResultDTO)
    assert calib == engine.calibrate(dict(app.collected))
    # confident results calibrate
    rng = np.random.default_rng(0)
    app.collected.clear()
    for p in ("p1", "p2", "p3"):
        for _ in range(2):
            pose = np.concatenate([rng.normal(size=3) * 0.01 + [0.6, 0.4, 1],
                                   [0.65, 0.3, 0.28, -0.63]])
            app.collected[p].append(ResultDTO(
                segmentation=np.zeros(4, np.int32), ee_pose=pose,
                base_pose=pose, key_points_pose=pose,
                key_points_base_pose=pose, is_confident=True))
    calib = app.calibrate()
    assert np.isfinite(calib.pose_camera_link).all()
    np.testing.assert_allclose(calib.pose_camera_link[:3], [0.6, 0.4, 1.0],
                               atol=0.05)
    result = app.step()
    assert result.segmentation.shape == (len(generate_sample(
        seed=76, **SAMPLE_KW)["points"]),)
    # snapshot_dir: the update loop draws each frame
    snaps = MainApp(source, engine=engine, snapshot_dir=str(tmp_path / "s"))
    assert snaps.step() is not None
    assert len(list((tmp_path / "s").glob("frame_*.png"))) == 1


def test_calibrate_directory(engine, tmp_path, dataset_dir):
    """Three frames in chunks of two: two chunks through the engine, one
    calibration (of no confident frame, with random nets)."""
    d = tmp_path / "frames"
    d.mkdir()
    for i, name in enumerate(sorted(os.listdir(dataset_dir / "labeled"))[:2]):
        with open(dataset_dir / "labeled" / name, "rb") as a, \
                open(d / name, "wb") as b:
            b.write(a.read())
    s = generate_sample(seed=90, **SAMPLE_KW)
    np.save(d / "x_points.npy", s["points"])
    np.save(d / "x_rgb.npy", s["rgb"])
    pose = s["ee2base_pose"]                 # WXYZ -> the sidecar's XYZW
    np.save(d / "x_pose.npy", np.concatenate([pose[:3], pose[4:], pose[3:4]]))
    seen = []
    predict = engine.predict

    def spy(data):
        seen.append((data.id, data.ee2base_pose))
        return predict(data)

    engine.predict = spy
    try:
        calib = calibrate_directory(str(d), engine=engine, chunk=2)
    finally:
        del engine.predict
    assert [i for i, _ in seen] == ["f1", "f2", "f3"]
    np.testing.assert_allclose(seen[2][1], pose)
    assert isinstance(calib, CalibrationResultDTO)
