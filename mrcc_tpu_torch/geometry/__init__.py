"""Geometry used by the inference path (port of ``mrcc_tpu/geometry``)."""

from .kabsch import kabsch, kabsch_pose
from .preprocess import center_at_origin, normalize_colors
from .transform import (matrix_to_pose, matrix_to_quat, pose_to_matrix,
                        quat_to_matrix)

__all__ = ["center_at_origin", "kabsch", "kabsch_pose", "matrix_to_pose",
           "matrix_to_quat", "normalize_colors", "pose_to_matrix",
           "quat_to_matrix"]
