"""Shared plumbing of the entry mains (port of ``mrcc_tpu/cli/common.py``):
the dataset bootstrap, the datasets of a ``Config``, the experiment name
and the pose-model choice (``train.py:259-276``)."""

from __future__ import annotations

import dataclasses
import os

from ..config import Config
from ..data.dataset import AliveV2Dataset, DataConfig, merge_split_files
from ..models import PointNet2SSG, RobotNet, RobotNetEncode
from ..utils.logger import get_logger


def ensure_dataset(cfg: Config, n=6):
    """The split-file paths of ``DATA.file_names``; where one is missing, a
    synthetic sample set of ``n`` samples is written beside the first
    missing path and its split file returned."""
    paths = str(cfg()["DATA"].get("file_names", "")).split(",")
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        from ..data.synthetic import write_sample_set

        out_dir = os.path.dirname(missing[0]) or "dataset/synthetic"
        get_logger().info("split file(s) missing; generating synthetic "
                          f"sample set in {out_dir}")
        write_sample_set(out_dir, n=n)
        paths = [os.path.join(out_dir, "sample_splits.json")]
    return paths


def make_datasets(cfg: Config, data_cfg: DataConfig = None, dense=False,
                  splits=("train", "val")):
    """One dataset a split (a list, or the dataset for one split):
    ``AliveV2Dataset`` or, with ``dense``, ``AliveV2DenseDataset`` at
    ``DATA.num_of_dense_input_points`` / ``pointcloud_sampling_method``;
    augmentation on the train split where ``DATA.augmentation`` names
    any."""
    data_cfg = data_cfg or cfg.data_config()
    d = cfg()["DATA"]
    paths = ensure_dataset(cfg)
    augment = bool(data_cfg.augmentation)
    out = []
    for split in splits:
        files = merge_split_files(paths, split=split,
                                  prefix=d.get("prefix", ""))
        if dense:
            from ..data.dense import AliveV2DenseDataset

            ds = AliveV2DenseDataset(
                files=files, cfg=data_cfg,
                augment=augment and split == "train",
                num_points=d.get("num_of_dense_input_points", 2048),
                sampling=d.get("pointcloud_sampling_method", "uniform"))
        else:
            ds = AliveV2Dataset(files=files, cfg=data_cfg,
                                augment=augment and split == "train")
        out.append(ds)
    return out if len(out) > 1 else out[0]


def exp_name_of(cfg: Config) -> str:
    """The config file's name without its extension."""
    return os.path.splitext(os.path.basename(cfg.config_path))[0]


@dataclasses.dataclass
class PoseModelConfig:
    """STRUCTURE keys of the pose model (``config/default.yaml``)."""

    backbone: str = "minkunet"
    encode_only: bool = False
    compute_confidence: bool = False
    use_joint_angles: bool = False

    @classmethod
    def from_config(cls, cfg: Config) -> "PoseModelConfig":
        s = cfg()["STRUCTURE"]
        return cls(backbone=s.get("backbone", "minkunet"),
                   encode_only=bool(s.get("encode_only", False)),
                   compute_confidence=bool(s.get("compute_confidence",
                                                 False)),
                   use_joint_angles=bool(s.get("use_joint_angles", False)))


def select_pose_model(model_cfg, data_cfg: DataConfig = None):
    """The pose model of a ``Config`` (its STRUCTURE and DATA sections) or
    of a ``PoseModelConfig`` and ``DataConfig``: RobotNet, or
    RobotNetEncode with ``encode_only`` (which takes
    ``voxelize_position``), over RGB features; 10 outputs with
    ``compute_confidence``, else 7.  A ``pointnet*`` backbone gives
    ``PointNet2SSG`` with that many classes, as in JAX (no pose step can
    train it: ROADMAP C29)."""
    if isinstance(model_cfg, Config):
        data_cfg = data_cfg or model_cfg.data_config()
        model_cfg = PoseModelConfig.from_config(model_cfg)
    data_cfg = data_cfg or DataConfig()
    out_channels = 10 if model_cfg.compute_confidence else 7
    if model_cfg.backbone.startswith("pointnet"):
        return PointNet2SSG(num_classes=out_channels)
    kw = dict(backbone=model_cfg.backbone, out_channels=out_channels,
              use_joint_angles=model_cfg.use_joint_angles)
    if model_cfg.encode_only:
        return RobotNetEncode(voxelize_position=data_cfg.voxelize_position,
                              quantization_size=data_cfg.quantization_size,
                              **kw)
    return RobotNet(**kw)
