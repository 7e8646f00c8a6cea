"""Geometry of the inference path and the pose criteria (port of
``mrcc_tpu/geometry``)."""

from .kabsch import kabsch, kabsch_pose
from .metrics import compute_pose_dist
from .preprocess import center_at_origin, normalize_colors
from .quaternion import qconj, qeuler, qmul, qnormalize
from .transform import (matrix_to_pose, matrix_to_quat, pose_to_matrix,
                        quat_to_matrix, rot6d_to_matrix, rot6d_to_quat)

__all__ = ["center_at_origin", "compute_pose_dist", "kabsch", "kabsch_pose",
           "matrix_to_pose", "matrix_to_quat", "normalize_colors",
           "pose_to_matrix", "qconj", "qeuler", "qmul", "qnormalize",
           "quat_to_matrix", "rot6d_to_matrix", "rot6d_to_quat"]
