"""Geometry: quaternions, SE(3), Kabsch, metrics, calibration averaging
(port of ``mrcc_tpu/geometry``)."""

from . import calibration, metrics, preprocess, quaternion, transform
from .kabsch import kabsch, kabsch_pose
from .kabsch import kabsch as rigid_transform_3d
from .metrics import compute_pose_dist
from .preprocess import base_at_origin, center_at_origin, normalize_colors
from .quaternion import (qconj, qeuler, qmul, qnormalize, qrot, switch_pose_w,
                         wxyz_to_xyzw, xyzw_to_wxyz)
from .transform import (base2cam_pose, matrix_to_pose, matrix_to_quat,
                        pose_inverse, pose_to_matrix, quat_to_matrix,
                        rot6d_to_matrix, rot6d_to_quat, transform_pose2pose)

__all__ = ["base2cam_pose", "base_at_origin", "calibration",
           "center_at_origin", "compute_pose_dist", "kabsch", "kabsch_pose", "matrix_to_pose",
           "matrix_to_quat", "metrics", "normalize_colors", "pose_inverse",
           "pose_to_matrix", "preprocess", "qconj", "qeuler", "qmul",
           "qnormalize", "qrot", "quat_to_matrix", "quaternion",
           "rigid_transform_3d", "rot6d_to_matrix", "rot6d_to_quat",
           "switch_pose_w", "transform", "transform_pose2pose",
           "wxyz_to_xyzw", "xyzw_to_wxyz"]
