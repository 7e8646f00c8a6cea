"""Data transfer objects of the calibration app (the port's copy of
``mrcc_tpu/app/dto.py``, after the reference's ``app/dto.py:7-70``).
numpy dataclasses; poses are WXYZ 7-vectors ``[x, y, z, qw, qx, qy, qz]``.
"""

from __future__ import annotations

import dataclasses
import datetime
import typing

import numpy as np


@dataclasses.dataclass
class PointCloudDTO:
    points: np.ndarray
    rgb: np.ndarray
    timestamp: typing.Optional[datetime.datetime] = None
    ee2base_pose: typing.Optional[np.ndarray] = None  # WXYZ
    joint_angles: typing.Optional[np.ndarray] = None
    id: typing.Optional[str] = None
    gt_pose: typing.Optional[np.ndarray] = None  # WXYZ


@dataclasses.dataclass
class RawDTO(PointCloudDTO):
    """Labelled variant used by the offline benchmark."""

    labels: typing.Optional[np.ndarray] = None
    instance_labels: typing.Optional[np.ndarray] = None
    pose: typing.Optional[np.ndarray] = None  # ground-truth EE pose, WXYZ
    other: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ResultDTO:
    """One cloud's prediction."""

    segmentation: typing.Optional[np.ndarray] = None
    ee_pose: typing.Optional[np.ndarray] = None
    base_pose: typing.Optional[np.ndarray] = None
    key_points: list = dataclasses.field(default_factory=list)  # [(cls, xyz)]
    key_points_pose: typing.Optional[np.ndarray] = None
    key_points_base_pose: typing.Optional[np.ndarray] = None
    is_confident: bool = False
    confidence: float = 1.0


@dataclasses.dataclass
class TestResultDTO(ResultDTO):
    """Result plus the camera_link-frame poses."""

    base_pose_camera_link: typing.Optional[np.ndarray] = None
    key_points_base_pose_camera_link: typing.Optional[np.ndarray] = None
    id: typing.Optional[str] = None


@dataclasses.dataclass
class CalibrationResultDTO:
    """The calibrated extrinsic and the averages it came from."""

    pose_camera_link: typing.Optional[np.ndarray] = None
    ee_pose: typing.Optional[np.ndarray] = None
    base_pose: typing.Optional[np.ndarray] = None
    key_points_pose: typing.Optional[np.ndarray] = None
    key_points_base_pose: typing.Optional[np.ndarray] = None
    base_pose_camera_link: typing.Optional[np.ndarray] = None
    key_points_base_pose_camera_link: typing.Optional[np.ndarray] = None

    def load_from_test_result(self, result: "TestResultDTO"):
        self.ee_pose = result.ee_pose
        self.base_pose = result.base_pose
        self.key_points_pose = result.key_points_pose
        self.key_points_base_pose = result.key_points_base_pose
        self.base_pose_camera_link = result.base_pose_camera_link
        self.key_points_base_pose_camera_link = (
            result.key_points_base_pose_camera_link)
