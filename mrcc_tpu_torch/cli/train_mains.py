"""Trainer entry mains (port of ``mrcc_tpu/cli/train_mains.py``: the pose,
segmentation, voting, sparse keypoint and feature-extractor mains, with
``cli/common.py::select_pose_model``).

Dataclass configs stand in for the YAML ``Config`` (``config/`` is not
ported yet): ``PoseModelConfig`` carries the STRUCTURE keys the model
choice reads.  The data are the port's labelled synthetic scenes (object
clouds for the feature extractor) unless a dataset is passed.  The JAX
mains' crash-retry wrapper is not carried over: a failure raises.
"""

from __future__ import annotations

import dataclasses

from ..data.dataset import (AliveV2Dataset, DataConfig, PoseDataset,
                            SceneDataset)
from ..data.synthetic import generate_sample
from ..data.ycb import YCBDataset
from ..models import (FeatureNet, RobotNet, RobotNetEncode,
                      RobotNetSegmentation, RobotNetVote)
from ..sparse.nn import init_parameters
from ..train import (LossConfig, Trainer, TrainConfig,
                     make_metric_learning_train_step, make_pose_train_step,
                     make_segmentation_train_step)

VOXEL_CAPACITY = 16384
EE_VOXEL_CAPACITY = 4096


def _next_pow2(n):
    p = 64
    while p < n:
        p *= 2
    return p


def scene_capacity(data_cfg: DataConfig) -> int:
    """Voxel capacity of a full scene: ``min(16384, next_pow2(P))``."""
    return min(VOXEL_CAPACITY, _next_pow2(data_cfg.max_points))


def ee_capacity(data_cfg: DataConfig) -> int:
    """Voxel capacity of an EE crop: ``min(4096, next_pow2(P))``."""
    return min(EE_VOXEL_CAPACITY, _next_pow2(data_cfg.max_points))


@dataclasses.dataclass
class PoseModelConfig:
    """STRUCTURE keys of the pose model (``config/default.yaml``)."""

    backbone: str = "minkunet"
    encode_only: bool = False
    compute_confidence: bool = False
    use_joint_angles: bool = False


def select_pose_model(model_cfg: PoseModelConfig, data_cfg: DataConfig):
    """``cli/common.py::select_pose_model``: RobotNet, or RobotNetEncode
    with ``encode_only`` (which takes ``voxelize_position``), over RGB
    features; 10 outputs with ``compute_confidence``, else 7."""
    if model_cfg.backbone.startswith("pointnet"):
        raise NotImplementedError(
            f"{model_cfg.backbone}: the dense PointNet2 paths are not ported "
            "(ROADMAP A6)")
    kw = dict(backbone=model_cfg.backbone,
              out_channels=10 if model_cfg.compute_confidence else 7,
              use_joint_angles=model_cfg.use_joint_angles)
    if model_cfg.encode_only:
        return RobotNetEncode(voxelize_position=data_cfg.voxelize_position,
                              quantization_size=data_cfg.quantization_size,
                              **kw)
    return RobotNet(**kw)


def train_pose(train_cfg: TrainConfig = None, model_cfg: PoseModelConfig = None,
               loss_cfg: LossConfig = None, epochs=None, device=None,
               data_cfg: DataConfig = None, dataset=None, capacity=None,
               exp_path="exp/pose", exp_name="pose"):
    """``train.py`` parity: RobotNet / RobotNetEncode pose regression with
    the cos2 criterion by default.

    Defaults are the reference's: RobotNet over minkunet (18D), 7 outputs,
    EE crops (``data_type="ee_seg"``) at 0.01 m voxels with capacity
    ``ee_capacity`` (a full scene's ``scene_capacity`` otherwise), batch 8,
    AdamW at lr 1e-4.  ``dataset``: any object with ``batches(batch_size,
    shuffle, seed)`` (default: ``4 * batch_size`` synthetic samples).  Runs
    on the card unless ``device="cpu"``.  Returns the per-epoch history of
    :meth:`Trainer.fit`.
    """
    train_cfg = train_cfg or TrainConfig(batch_size=8)
    model_cfg = model_cfg or PoseModelConfig()
    data_cfg = data_cfg or DataConfig()
    capacity = capacity or (ee_capacity(data_cfg)
                            if data_cfg.data_type == "ee_seg"
                            else scene_capacity(data_cfg))
    model = init_parameters(select_pose_model(model_cfg, data_cfg),
                            train_cfg.seed)
    dataset = dataset or PoseDataset(data_cfg, 4 * train_cfg.batch_size,
                                     seed=train_cfg.seed)
    step, optimizer = make_pose_train_step(
        model, data_cfg, loss_cfg or LossConfig(), train_cfg, capacity,
        use_joint_angles=model_cfg.use_joint_angles, device=device)
    trainer = Trainer(model, dataset, step, optimizer, train_cfg,
                      exp_path=exp_path, exp_name=exp_name)
    return trainer.fit(epochs=epochs)


def train_segmentation(train_cfg: TrainConfig = None, capacity=None,
                       epochs=None, device=None, data_cfg: DataConfig = None,
                       dataset=None, backbone="minkunet",
                       exp_path="exp/segmentation", exp_name="segmentation"):
    """``train_segmentation.py`` parity: RobotNetSegmentation + CE.

    Defaults are the reference's: minkunet (18D), 3 classes, batch 8
    (``DATA.batch_size``), voxel size 0.01 m, capacity 16384, AdamW at lr
    1e-4 with weight decay 1e-4.  ``dataset`` is any object with
    ``batches(batch_size, shuffle, seed)`` (default: ``4 * batch_size``
    synthetic scenes).  Runs on the card unless ``device="cpu"``.  Returns
    the per-epoch history of :meth:`Trainer.fit`.
    """
    train_cfg = train_cfg or TrainConfig(batch_size=8)
    data_cfg = data_cfg or DataConfig(data_type=None)
    capacity = capacity or scene_capacity(data_cfg)
    model = init_parameters(
        RobotNetSegmentation(backbone=backbone, in_channels=3,
                             num_classes=data_cfg.classes), train_cfg.seed)
    dataset = dataset or SceneDataset(data_cfg, 4 * train_cfg.batch_size,
                                      seed=train_cfg.seed)
    step, optimizer = make_segmentation_train_step(
        model, data_cfg, train_cfg, capacity,
        ignore_label=data_cfg.ignore_label, device=device)
    trainer = Trainer(model, dataset, step, optimizer, train_cfg,
                      exp_path=exp_path, exp_name=exp_name)
    return trainer.fit(epochs=epochs)


def _synthetic_items(data_cfg: DataConfig, n: int, seed: int):
    """``AliveV2Dataset`` items of ``n`` synthetic scenes from ``seed``."""
    return AliveV2Dataset(samples=[generate_sample(seed=seed + i)
                                   for i in range(n)], cfg=data_cfg)


def _fit_per_voxel(model, data_cfg, train_cfg, capacity, epochs, device,
                   dataset, exp_path, exp_name):
    """Train a per-voxel cross-entropy head as the segmentation main does
    (``make_segmentation_train_step``, as the JAX voting and keypoint mains
    reuse ``make_segmentation_train_step``)."""
    model = init_parameters(model, train_cfg.seed)
    dataset = dataset or _synthetic_items(data_cfg, 4 * train_cfg.batch_size,
                                          train_cfg.seed)
    step, optimizer = make_segmentation_train_step(
        model, data_cfg, train_cfg, capacity or ee_capacity(data_cfg),
        ignore_label=data_cfg.ignore_label, device=device)
    trainer = Trainer(model, dataset, step, optimizer, train_cfg,
                      exp_path=exp_path, exp_name=exp_name)
    return trainer.fit(epochs=epochs)


def train_vote(train_cfg: TrainConfig = None, capacity=None, epochs=None,
               device=None, data_cfg: DataConfig = None, dataset=None,
               backbone="minkunet", exp_path="exp/vote", exp_name="vote"):
    """``train_vote.py`` parity: RobotNetVote + CE on the cross-section
    labels (``voting_enabled``): 2 classes on EE crops (``data_type=
    "ee_seg"``, the default), 4 on whole scenes.

    Defaults are the reference's: minkunet (18D), batch 8, 0.01 m voxels at
    capacity ``ee_capacity``, AdamW at lr 1e-4.  ``dataset``: any object
    with ``batches(batch_size, shuffle, seed)`` (default: ``AliveV2Dataset``
    items of ``4 * batch_size`` synthetic scenes).  Runs on the card unless
    ``device="cpu"``.  Returns the per-epoch history of :meth:`Trainer.fit`.
    """
    train_cfg = train_cfg or TrainConfig(batch_size=8)
    data_cfg = dataclasses.replace(data_cfg or DataConfig(),
                                   voting_enabled=True)
    model = RobotNetVote(backbone=backbone, in_channels=3, num_classes=(
        2 if data_cfg.data_type == "ee_seg" else 4))
    return _fit_per_voxel(model, data_cfg, train_cfg, capacity, epochs,
                          device, dataset, exp_path, exp_name)


def train_key_points(train_cfg: TrainConfig = None, capacity=None,
                     epochs=None, device=None, data_cfg: DataConfig = None,
                     dataset=None, backbone="minkunet",
                     exp_path="exp/key_points", exp_name="key_points"):
    """``train_key_points.py`` parity, the sparse branch:
    RobotNetSegmentation with ``num_of_keypoints`` classes + CE on the
    keypoint labels of EE crops (``keypoints_enabled``, ``data_type=
    "ee_seg"``).  A ``pointnet*`` backbone (the dense branch) raises.

    Defaults, ``dataset``, device and the return value as
    :func:`train_vote`.
    """
    if backbone.startswith("pointnet"):
        raise NotImplementedError(
            f"{backbone}: the dense PointNet2 paths are not ported "
            "(ROADMAP A6)")
    train_cfg = train_cfg or TrainConfig(batch_size=8)
    data_cfg = dataclasses.replace(data_cfg or DataConfig(),
                                   keypoints_enabled=True, data_type="ee_seg")
    model = RobotNetSegmentation(backbone=backbone, in_channels=3,
                                 num_classes=data_cfg.num_of_keypoints)
    return _fit_per_voxel(model, data_cfg, train_cfg, capacity, epochs,
                          device, dataset, exp_path, exp_name)


FEATURE_CAPACITY = 1024  # voxel capacity of the feature extractor's step


def train_feature_extractor(train_cfg: TrainConfig = None, epochs=None,
                            device=None, dataset=None,
                            backbone="minkunet34A",
                            capacity=FEATURE_CAPACITY,
                            exp_path="exp/feature_extractor",
                            exp_name="feature_extractor"):
    """``train_feature-extractor.py`` parity: FeatureNet (MinkUNet34A to a
    16-wide embedding) trained with the mined triplet loss on object
    clouds, 5 mm voxels at capacity 1024 with every level on k3 tables, as
    the JAX main's inline step.

    ``dataset``: default ``YCBDataset(num_classes=8, samples_per_class=6,
    max_points=1024)`` (synthetic clouds); its ``cfg`` gives the voxel
    size.  The batch is ``max(batch_size, 8)``: mining needs positives in
    the batch.  Runs on the card unless ``device="cpu"``.  Returns the
    per-epoch history of :meth:`Trainer.fit`.
    """
    train_cfg = train_cfg or TrainConfig()
    dataset = dataset or YCBDataset(num_classes=8, samples_per_class=6,
                                    max_points=1024)
    model = init_parameters(FeatureNet(in_channels=3, out_channels=16,
                                       backbone=backbone), train_cfg.seed)
    step, optimizer = make_metric_learning_train_step(
        model, dataset.cfg, train_cfg, capacity, device=device)
    train_cfg = dataclasses.replace(train_cfg,
                                    batch_size=max(train_cfg.batch_size, 8))
    trainer = Trainer(model, dataset, step, optimizer, train_cfg,
                      exp_path=exp_path, exp_name=exp_name)
    return trainer.fit(epochs=epochs)
