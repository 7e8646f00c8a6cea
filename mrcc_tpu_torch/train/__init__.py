"""Segmentation training (port of ``mrcc_tpu/train``: criterion,
checkpoints, optimizer, train step and epoch loop)."""

from .checkpoint import (checkpoint_restore, checkpoint_save, is_multiple,
                         is_power2, latest_checkpoint)
from .losses import segmentation_loss
from .trainer import (AverageMeter, MetricsWriter, SegmentationTrainStep,
                      TrainConfig, Trainer,
                      make_optimizer, make_segmentation_train_step,
                      step_learning_rate)

__all__ = ["AverageMeter", "MetricsWriter", "SegmentationTrainStep",
           "TrainConfig", "Trainer",
           "checkpoint_restore", "checkpoint_save", "is_multiple",
           "is_power2", "latest_checkpoint", "make_optimizer",
           "make_segmentation_train_step", "segmentation_loss",
           "step_learning_rate"]
