"""ArUco-tag EE pose, the classical cross-check of the learned pipeline
(port of ``mrcc_tpu/utils/aruco.py``, after the reference's
``utils/aruco.py``): project the RGB-D cloud to an image with a z-buffer,
detect one tag (``cv2.aruco``), lift its four corners to 3D through the
depth image, Kabsch the canonical tag corners onto them and offset by
``t_tag2ee``.

``cv2`` is needed only to detect the tag, and is imported inside
:func:`compute_ee_pose` (which returns None without it).  The geometry
after detection is :func:`tag_pose_from_corners`, which takes the four
pixel corners and runs without ``cv2``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.kabsch import kabsch
from ..geometry.transform import matrix_to_quat

CAMERA_MATRIX_DEFAULT = np.array([
    [520.342706004118, 0, 323.0580496437712],
    [0, 513.826209565285, 263.4994539787398],
    [0, 0, 1],
])  # Kinect 1 RGB intrinsics


def project_to_rgbd(points, rgb, camera_matrix, width=640, height=480,
                    depth_max=4.0):
    """Pinhole projection with a z-buffer -> ``(rgb_img [H, W, 3],
    depth [H, W])`` (float32; the nearest point wins a pixel)."""
    points = np.asarray(points)
    rgb = np.asarray(rgb)
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    z = points[:, 2]
    ok = (z > 1e-6) & (z < depth_max)
    u = np.round(points[:, 0] * fx / z + cx).astype(np.int64)
    v = np.round(points[:, 1] * fy / z + cy).astype(np.int64)
    ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z, col = u[ok], v[ok], z[ok], rgb[ok]
    order = np.argsort(-z)  # far to near, so near pixels are written last
    u, v, z, col = u[order], v[order], z[order], col[order]
    rgb_img = np.zeros((height, width, 3), np.float32)
    depth = np.zeros((height, width), np.float32)
    rgb_img[v, u] = col
    depth[v, u] = z
    return rgb_img, depth


def tag_pose_from_corners(corners_px, depth_img,
                          camera_matrix=CAMERA_MATRIX_DEFAULT,
                          aruco_tag_size=0.075,
                          t_tag2ee=(-0.012, -0.0, -0.05), device="cpu"):
    """EE pose ``[x, y, z, qw, qx, qy, qz]`` from a detected tag's four
    pixel corners ``[4, 2]`` (cv2's order) and the depth image: each
    corner (truncated to an integer pixel) lifted to camera coordinates
    through its depth, the canonical corners (the tag in the y-z plane,
    ``aruco_tag_size`` wide) Kabsch-aligned onto them, then offset by
    ``t_tag2ee`` in the tag frame; None where a corner has no depth.  The
    Kabsch solve runs on ``device``."""
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    corners_3d = []
    for u, v in np.asarray(corners_px)[:4]:
        u, v = int(u), int(v)
        z = depth_img[v, u]
        if z <= 0:
            return None
        corners_3d.append([(u - cx) * z / fx, (v - cy) * z / fy, z])
    half = aruco_tag_size / 2
    corners_ref = np.array([[0, half, -half], [0, -half, -half],
                            [0, -half, half], [0, half, half]], np.float32)
    r, t = kabsch(torch.as_tensor(corners_ref, device=device),
                  torch.as_tensor(np.asarray(corners_3d, np.float32),
                                  device=device))
    t = t + r @ torch.as_tensor(t_tag2ee, dtype=r.dtype, device=device)
    return torch.cat([t, matrix_to_quat(r)]).cpu().numpy()


def compute_ee_pose(points, rgb, camera_matrix=CAMERA_MATRIX_DEFAULT,
                    image_width=640, image_height=480,
                    aruco_tag_size=0.075, t_tag2ee=(-0.012, -0.0, -0.05)):
    """Detect the tag (``DICT_6X6_1000``) and return the EE pose
    ``[x, y, z, qw, qx, qy, qz]``, or None without ``cv2``, without exactly
    one tag, or where a corner has no depth."""
    try:
        import cv2
    except ImportError:
        return None

    rgb = np.asarray(rgb)
    rgb01 = rgb if rgb.max() <= 1.5 else rgb / 255.0
    rgb_img, depth_img = project_to_rgbd(points, rgb01, camera_matrix,
                                         image_width, image_height)
    gray = cv2.cvtColor((rgb_img * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    if hasattr(cv2.aruco, "getPredefinedDictionary"):
        aruco_dict = cv2.aruco.getPredefinedDictionary(
            cv2.aruco.DICT_6X6_1000)
        if hasattr(cv2.aruco, "ArucoDetector"):
            detector = cv2.aruco.ArucoDetector(
                aruco_dict, cv2.aruco.DetectorParameters())
            corners, _, _ = detector.detectMarkers(gray)
        else:
            corners, _, _ = cv2.aruco.detectMarkers(
                gray, aruco_dict, parameters=cv2.aruco.DetectorParameters())
    else:  # the reference's older cv2 API
        aruco_dict = cv2.aruco.Dictionary_get(cv2.aruco.DICT_6X6_1000)
        corners, _, _ = cv2.aruco.detectMarkers(
            gray, aruco_dict, parameters=cv2.aruco.DetectorParameters_create())
    if corners is None or len(corners) != 1:
        return None
    return tag_pose_from_corners(corners[0][0], depth_img, camera_matrix,
                                 aruco_tag_size, t_tag2ee)
