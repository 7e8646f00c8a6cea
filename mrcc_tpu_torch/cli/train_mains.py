"""Trainer entry mains (port of ``mrcc_tpu/cli/train_mains.py``: the pose
and the segmentation mains, with ``cli/common.py::select_pose_model``).

Dataclass configs stand in for the YAML ``Config`` (``config/`` is not
ported yet): ``PoseModelConfig`` carries the STRUCTURE keys the model
choice reads.  The data are the port's labelled synthetic scenes.  The
JAX main's crash-retry wrapper is not carried over: a failure raises.
"""

from __future__ import annotations

import dataclasses

from ..data.dataset import DataConfig, PoseDataset, SceneDataset
from ..models import RobotNet, RobotNetEncode, RobotNetSegmentation
from ..sparse.nn import init_parameters
from ..train import (LossConfig, Trainer, TrainConfig, make_pose_train_step,
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
            "(ROADMAP A1)")
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
