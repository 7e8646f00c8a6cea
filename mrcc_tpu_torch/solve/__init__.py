"""Geometric solvers of the inference path (port of ``mrcc_tpu/solve``)."""

from .cluster import largest_cluster_mask
from .icp import default_template, icp_refine
from .keypoints import key_point_predictions, pose_from_key_points
from .translation import predict_translation

__all__ = ["default_template", "icp_refine", "key_point_predictions",
           "largest_cluster_mask", "pose_from_key_points",
           "predict_translation"]
