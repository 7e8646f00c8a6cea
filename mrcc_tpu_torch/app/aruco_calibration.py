"""Marker-based calibration baseline (port of
``mrcc_tpu/app/aruco_calibration.py``, after the reference's
``ArucoTestApp``): the EE pose of each frame from its ArUco tag
(``utils/aruco.py``), optionally refined by ICP against the EE template
from the tag pose, then the learned pipeline's calibration path."""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..data.labels import get_ee_idx
from ..geometry.transform import base2cam_pose
from ..solve import icp_refine
from ..utils.aruco import compute_ee_pose
from ..utils.logger import get_logger
from .dto import CalibrationResultDTO, ResultDTO
from .inference_engine import InferenceConfig, InferenceEngine


class ArucoCalibrationApp:
    def __init__(self, data_source, engine: InferenceEngine = None,
                 icp_enabled: bool = True, camera_matrix=None, device=None):
        """``engine``: default a ``calibration_only`` engine (no networks)
        on ``device`` (the card unless told otherwise); the tag pose and
        ICP run on the engine's device."""
        self.engine = engine or InferenceEngine(
            InferenceConfig(), device=device, calibration_only=True)
        self.data_source = data_source
        self.icp_enabled = icp_enabled
        self.camera_matrix = camera_matrix
        self.log = get_logger()

    def refine(self, points, pose):
        """ICP of the template from ``pose`` onto the points inside the EE
        box of ``pose`` (where there are more than 64), on the engine's
        device; ``pose`` itself otherwise."""
        points = np.asarray(points, np.float32)
        ee_idx = get_ee_idx(points, pose)
        if len(ee_idx) <= 64:
            return pose
        dev = self.engine.device
        ee = torch.as_tensor(points[ee_idx], device=dev)
        out = icp_refine(self.engine.template, ee[None],
                         torch.ones((1, len(ee)), dtype=torch.bool,
                                    device=dev),
                         torch.as_tensor(pose, dtype=torch.float32,
                                         device=dev)[None],
                         iterations=self.engine.cfg.icp_iterations)
        return out[0].cpu().numpy()

    def predict(self, data) -> ResultDTO:
        kw = {}
        if self.camera_matrix is not None:
            kw["camera_matrix"] = self.camera_matrix
        pose = compute_ee_pose(np.asarray(data.points), np.asarray(data.rgb),
                               device=self.engine.device, **kw)
        result = ResultDTO(segmentation=None)
        if pose is None:
            return result
        if self.icp_enabled:
            pose = self.refine(data.points, pose)
        result.ee_pose = pose
        result.is_confident = True
        if data.ee2base_pose is not None:
            result.base_pose = self.engine._pose_np(base2cam_pose, pose,
                                                    data.ee2base_pose)
            result.key_points_base_pose = result.base_pose.copy()
        return result

    def run(self, n_frames=50) -> CalibrationResultDTO:
        """Up to ``n_frames`` frames from the source; the tagged ones,
        grouped by frame id, through ``engine.calibrate``."""
        collected = collections.defaultdict(list)
        found = 0
        for _ in range(n_frames):
            data = self.data_source.get()
            if data is None:
                break
            result = self.predict(data)
            if result.ee_pose is not None:
                collected[data.id or "p1"].append(result)
                found += 1
        self.log.info(f"aruco: {found} tagged frames")
        return self.engine.calibrate(dict(collected))
