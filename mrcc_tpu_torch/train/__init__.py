"""Training (port of ``mrcc_tpu/train``: criteria, checkpoints, optimizer,
the segmentation, pose, metric-learning and dense train steps and the
epoch loop)."""

from .checkpoint import (checkpoint_restore, checkpoint_save, is_multiple,
                         is_power2, latest_checkpoint)
from .losses import LossConfig, LossType, get_criterion, segmentation_loss
from .metric_learning import (multi_similarity_miner, pairwise_dist,
                              triplet_margin_loss)
from .trainer import (AverageMeter, DenseKeyPointTrainStep,
                      KpToPoseTrainStep, MetricLearningTrainStep,
                      MetricsWriter, PoseTrainStep, SegmentationTrainStep,
                      TrainConfig, Trainer, make_dense_key_point_train_step,
                      make_kp_to_pose_train_step,
                      make_metric_learning_train_step, make_optimizer,
                      make_pose_train_step, make_segmentation_train_step,
                      step_learning_rate)

__all__ = ["AverageMeter", "DenseKeyPointTrainStep", "KpToPoseTrainStep",
           "LossConfig", "LossType", "MetricLearningTrainStep",
           "MetricsWriter", "PoseTrainStep", "SegmentationTrainStep",
           "TrainConfig", "Trainer", "checkpoint_restore", "checkpoint_save",
           "get_criterion", "is_multiple", "is_power2", "latest_checkpoint",
           "make_dense_key_point_train_step", "make_kp_to_pose_train_step",
           "make_metric_learning_train_step", "make_optimizer",
           "make_pose_train_step", "make_segmentation_train_step",
           "multi_similarity_miner", "pairwise_dist", "segmentation_loss",
           "step_learning_rate", "triplet_margin_loss"]
