"""Test / evaluation mains (port of ``mrcc_tpu/cli/test_mains.py``), one
per reference script: ``test.py`` (:func:`test_pose`),
``test_segmentation.py``, ``test_key_points.py``, ``test_vote.py``,
``test_feature-extractor.py`` and ``app_test.py`` (:func:`test_app`).

Each takes a ``Config`` (default ``Config.from_args()``: ``--config
--override --exp_path --log_path``) and ``device``: the card unless
``"cpu"``.  Weights come from ``TEST.checkpoint`` or else the newest
``{config name}-*.ckpt`` of the experiment directory: the port trainer's
``.ckpt``, a JAX package msgpack checkpoint or a reference ``.pth``
(``interop.load_weights``).  Where there is none, a warning is logged and
the seeded init (seed 0) is evaluated, as the JAX mains evaluate their
fresh init.  Run them as ``python -m mrcc_tpu_torch.cli <main> [--config
...]``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..interop import load_weights
from ..sparse.nn import init_parameters
from ..train.checkpoint import latest_checkpoint
from ..utils.logger import get_logger
from . import train_mains
from .common import exp_name_of, make_datasets, select_pose_model


def _load_variables(cfg: Config, model):
    """``model`` with its trained weights, or the seeded init (logged)."""
    init_parameters(model, 0)
    path = (cfg()["TEST"].get("checkpoint")
            or latest_checkpoint(cfg.exp_path, exp_name_of(cfg)))
    if path and os.path.isfile(path):
        return load_weights(model, path)
    get_logger().warning("no checkpoint found; evaluating fresh init")
    return model


def _split(cfg: Config) -> str:
    return cfg()["TEST"].get("split", "test")


def _segmentation_net(cfg: Config, num_classes: int):
    from ..models import RobotNetSegmentation

    return RobotNetSegmentation(
        backbone=cfg()["STRUCTURE"].get("backbone", "minkunet"),
        in_channels=cfg()["DATA"].get("input_channel", 3),
        num_classes=num_classes)


def test_pose(cfg: Config = None, device=None):
    """``test.py``: pose regression over ``TEST.split``; writes
    ``result_{split}.json``."""
    from ..eval import evaluate_pose

    cfg = cfg or Config.from_args()
    data_cfg = cfg.data_config()
    split = _split(cfg)
    ds = make_datasets(cfg, data_cfg, splits=(split,))
    model = _load_variables(cfg, select_pose_model(cfg, data_cfg))
    pv = data_cfg.scale if cfg()["DATA"].get("voxelize_position") else 1.0
    out = os.path.join(cfg.exp_path, f"result_{split}.json")
    res = evaluate_pose(model, ds, position_voxelization=pv, out_path=out,
                        device=device)
    get_logger().info(f"pose eval -> {out}: {res['overall']}")
    return res


def test_segmentation(cfg: Config = None, device=None):
    """``test_segmentation.py``: whole scenes (``data_type`` None) at
    capacity 8192, batch 4; writes ``result_segmentation_{split}.json``."""
    from ..eval import evaluate_segmentation

    cfg = cfg or Config.from_args()
    data_cfg = cfg.data_config()
    data_cfg.data_type = None
    split = _split(cfg)
    ds = make_datasets(cfg, data_cfg, splits=(split,))
    model = _load_variables(cfg, _segmentation_net(
        cfg, cfg()["DATA"].get("classes", 3)))
    out = os.path.join(cfg.exp_path, f"result_segmentation_{split}.json")
    res = evaluate_segmentation(model, ds, out_path=out, device=device)
    get_logger().info(f"segmentation eval -> {out}: {res['overall']}")
    return res


def test_key_points(cfg: Config = None, device=None):
    """``test_key_points.py`` (sparse path): EE crops with keypoint
    labels; writes ``result_key_points_{split}.json``."""
    from ..eval import evaluate_key_points

    cfg = cfg or Config.from_args()
    data_cfg = cfg.data_config()
    data_cfg.keypoints_enabled = True
    data_cfg.data_type = "ee_seg"
    split = _split(cfg)
    ds = make_datasets(cfg, data_cfg, splits=(split,))
    model = _load_variables(cfg, _segmentation_net(
        cfg, data_cfg.num_of_keypoints))
    out = os.path.join(cfg.exp_path, f"result_key_points_{split}.json")
    res = evaluate_key_points(model, ds,
                              num_keypoints=data_cfg.num_of_keypoints,
                              out_path=out, device=device)
    get_logger().info(f"keypoint eval -> {out}: {res['overall']}")
    return res


def test_vote(cfg: Config = None, device=None):
    """``test_vote.py``: RobotNetVote (2 classes on EE crops, else 4);
    writes ``result_vote_{split}.json``."""
    from ..eval import evaluate_vote
    from ..models import RobotNetVote

    cfg = cfg or Config.from_args()
    data_cfg = cfg.data_config()
    data_cfg.voting_enabled = True
    split = _split(cfg)
    ds = make_datasets(cfg, data_cfg, splits=(split,))
    model = _load_variables(cfg, RobotNetVote(
        backbone=cfg()["STRUCTURE"].get("backbone", "minkunet"),
        in_channels=cfg()["DATA"].get("input_channel", 3),
        num_classes=2 if data_cfg.data_type == "ee_seg" else 4))
    out = os.path.join(cfg.exp_path, f"result_vote_{split}.json")
    res = evaluate_vote(model, ds, ee_r=cfg()["PARAM"].get("ee_r", 0.02),
                        out_path=out, device=device)
    get_logger().info(f"vote eval -> {out}: {res['overall']}")
    return res


def test_feature_extractor(cfg: Config = None, device=None):
    """``test_feature-extractor.py``: recall@1 of FeatureNet (MinkUNet34A,
    16-wide) embeddings over ``YCBDataset(num_classes=8,
    samples_per_class=6, max_points=1024)``, 5 mm voxels at capacity 1024,
    every level on tables, in batches of 8."""
    from ..data.ycb import YCBDataset
    from ..models import FeatureNet
    from ..sparse import build_hierarchy, voxelize
    from ..train.metric_learning import pairwise_dist

    cfg = cfg or Config.from_args()
    dev = resolve_device(device)
    ds = YCBDataset(num_classes=8, samples_per_class=6, max_points=1024)
    model = _load_variables(cfg, FeatureNet(in_channels=3, out_channels=16,
                                            backbone="minkunet34A"))
    model = model.to(dev).eval()
    cap = train_mains.FEATURE_CAPACITY
    caps = (cap, cap // 2, cap // 4, cap // 8)
    embs, labels = [], []
    for batch in ds.batches(8, shuffle=False):
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        with torch.no_grad():
            vox, _ = voxelize(t(batch["points"], torch.float32),
                              t(batch["feats"], torch.float32),
                              t(batch["mask"], torch.bool), 1 / 200.0, cap)
            levels = build_hierarchy(vox, 4, capacities=caps,
                                     k3_tables=(True,) * 5)
            embs.append(model(vox.feats, levels).float())
        labels.append(batch["labels"])
    d = pairwise_dist(torch.cat(embs)).cpu().numpy().copy()
    labels = np.concatenate(labels)
    np.fill_diagonal(d, np.inf)
    recall1 = float((labels[d.argmin(axis=1)] == labels).mean())
    get_logger().info(f"feature-extractor recall@1: {recall1:.3f}")
    return {"recall@1": recall1}


def test_app(cfg: Config = None, n_samples=20, device=None):
    """``app_test.py``: the engine of ``INFERENCE`` over the labelled
    frames of ``INFERENCE.data_source`` (``PickleDataEngine`` on
    ``TEST.split``; fresh synthetic scenes where the files are missing)
    through ``BenchmarkApp``: metrics, calibration and the report
    ``TEST.output`` in the experiment directory."""
    from ..app import InferenceEngine, PickleDataEngine, SyntheticDataEngine
    from ..eval.benchmark import BenchmarkApp

    cfg = cfg or Config.from_args()
    engine = InferenceEngine(cfg.inference_config(), device=device)
    source_path = cfg()["INFERENCE"].get("data_source")
    if source_path and all(os.path.isfile(p)
                           for p in str(source_path).split(",")):
        source = PickleDataEngine(source_path, split=_split(cfg))
    else:
        source = SyntheticDataEngine()
    app = BenchmarkApp(engine, source, cfg()["TEST"].get(
        "gt_base_to_cam_pose"), n_samples=n_samples,
        ignore_unconfident=cfg()["TEST"].get("ignore_unconfident", True))
    out = os.path.join(cfg.exp_path,
                       cfg()["TEST"].get("output", "test_results.xlsx"))
    res = app.run(out_path=out)
    get_logger().info(f"benchmark report -> {res['report']}")
    return res
