"""Trainer entry mains (port of ``mrcc_tpu/cli/train_mains.py``; the
segmentation main).

Dataclass configs stand in for the YAML ``Config`` (``config/`` is not
ported yet), and the data are the port's labelled synthetic scenes.  The
JAX main's crash-retry wrapper is not carried over: a failure raises.
"""

from __future__ import annotations

from ..data.dataset import DataConfig, SceneDataset
from ..models import RobotNetSegmentation
from ..sparse.nn import init_parameters
from ..train import Trainer, TrainConfig, make_segmentation_train_step

VOXEL_CAPACITY = 16384


def _next_pow2(n):
    p = 64
    while p < n:
        p *= 2
    return p


def scene_capacity(data_cfg: DataConfig) -> int:
    """Voxel capacity of a full scene: ``min(16384, next_pow2(P))``."""
    return min(VOXEL_CAPACITY, _next_pow2(data_cfg.max_points))


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
    data_cfg = data_cfg or DataConfig()
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
