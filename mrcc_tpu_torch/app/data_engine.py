"""Data engines feeding the calibration app (port of
``mrcc_tpu/app/data_engine.py``: the interface and the synthetic engine,
over the port's own scene generator)."""

from __future__ import annotations

import datetime
import typing

import numpy as np

from ..data.synthetic import generate_sample
from .dto import PointCloudDTO, RawDTO


class DataEngineInterface:
    def get(self) -> PointCloudDTO:
        raise NotImplementedError

    def get_raw(self) -> typing.Optional[RawDTO]:
        raise NotImplementedError

    def run(self):
        pass

    def exit(self):
        pass


def _xyzw_to_wxyz(pose):
    pose = np.asarray(pose, np.float32).reshape(-1)
    return np.concatenate([pose[:3], pose[6:7], pose[3:6]])


class SyntheticDataEngine(DataEngineInterface):
    """Fresh synthetic scenes, one seed a frame; frame i belongs to
    position ``p{i // frames_per_position % n_positions + 1}``.  ``kw`` go
    to ``generate_sample`` (point counts, noise)."""

    def __init__(self, n_positions=5, frames_per_position=10, seed=100, **kw):
        self.n_positions = n_positions
        self.frames = frames_per_position
        self.seed = seed
        self.kw = kw
        self._count = 0

    def _sample(self):
        i = self._count
        self._count += 1
        position = f"p{i // self.frames % self.n_positions + 1}"
        return generate_sample(seed=self.seed + i, **self.kw), position

    def get(self) -> PointCloudDTO:
        s, position = self._sample()
        return PointCloudDTO(
            points=s["points"], rgb=s["rgb"],
            timestamp=datetime.datetime.now(datetime.timezone.utc),
            ee2base_pose=s["ee2base_pose"], joint_angles=s["joint_angles"],
            id=position, gt_pose=_xyzw_to_wxyz(s["pose"]))

    def get_raw(self) -> RawDTO:
        s, position = self._sample()
        return RawDTO(
            points=s["points"], rgb=s["rgb"],
            timestamp=datetime.datetime.now(datetime.timezone.utc),
            ee2base_pose=s["ee2base_pose"], joint_angles=s["joint_angles"],
            id=position, labels=s["labels"],
            instance_labels=s["instance_labels"],
            pose=_xyzw_to_wxyz(s["pose"]), other={"position": position})
