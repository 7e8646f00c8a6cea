"""Geometric solvers of the inference path (port of ``mrcc_tpu/solve``)."""

from . import cluster, icp, keypoints, symmetry, translation, vote
from .cluster import largest_cluster_mask
from .icp import default_template, icp_refine
from .keypoints import (REFERENCE_KEY_POINTS, key_point_predictions,
                        pose_from_key_points)
from .symmetry import disambiguate_flip
from .translation import predict_translation
from .vote import pred_center

__all__ = ["REFERENCE_KEY_POINTS", "cluster", "default_template",
           "disambiguate_flip", "icp", "icp_refine", "key_point_predictions",
           "keypoints", "largest_cluster_mask", "pose_from_key_points",
           "pred_center", "predict_translation", "symmetry", "translation",
           "vote"]
