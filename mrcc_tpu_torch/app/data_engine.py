"""Data engines feeding the calibration app (port of
``mrcc_tpu/app/data_engine.py``): the interface, ``PickleDataEngine``
(labelled sample pickles named by split JSONs) and the synthetic engine
over the port's own scene generator."""

from __future__ import annotations

import datetime
import itertools
import json
import typing

import numpy as np

from ..data.dataset import filter_file, load_sample
from ..data.labels import get_ee_idx
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


def _now():
    return datetime.datetime.now(datetime.timezone.utc)


class PickleDataEngine(DataEngineInterface):
    """The ``split`` entries of one or more split JSONs (``data_path``
    comma-separated), filtered by ``filter_file``, one sample a call; with
    ``cyclic`` the entries repeat, else ``get`` returns None past the last.
    A frame's ``id`` is its entry's ``position``.  Unpickling runs code:
    read only pickles this project wrote."""

    def __init__(self, data_path: str, split: str = "test", cyclic=True):
        entries = []
        for p in data_path.split(","):
            with open(p) as f:
                entries.extend(json.load(f).get(split, []))
        self.entries = [e for e in entries if filter_file(e)]
        assert self.entries, f"no samples in {data_path}:{split}"
        self._iter = (itertools.cycle(self.entries) if cyclic
                      else iter(self.entries))

    def _load(self):
        try:
            entry = next(self._iter)
        except StopIteration:
            return None, None
        path = entry["filepath"] if isinstance(entry, dict) else entry
        other = dict(entry) if isinstance(entry, dict) else {"filepath": path}
        return load_sample(path), other

    def get(self) -> typing.Optional[PointCloudDTO]:
        sample, other = self._load()
        if sample is None:
            return None
        return PointCloudDTO(
            points=np.asarray(sample["points"], np.float32),
            rgb=np.asarray(sample["rgb"], np.float32), timestamp=_now(),
            ee2base_pose=sample.get("ee2base_pose"),
            joint_angles=sample.get("joint_angles"),
            id=other.get("position"),
            gt_pose=(_xyzw_to_wxyz(sample["pose"]) if "pose" in sample
                     else None))

    def get_raw(self) -> typing.Optional[RawDTO]:
        """The labelled frame; a sample with no EE label (2) gets the arm
        points inside the EE box of its pose relabelled 2."""
        sample, other = self._load()
        if sample is None:
            return None
        points = np.asarray(sample["points"], np.float32)
        labels = np.asarray(sample["labels"], np.float32).reshape(-1).copy()
        pose = _xyzw_to_wxyz(sample["pose"])
        if not (labels == 2).any():
            ee_idx = get_ee_idx(
                points, pose,
                ee_dim={"min_z": -0.0, "max_z": 0.13, "min_x": -0.05,
                        "max_x": 0.05, "min_y": -0.14, "max_y": 0.14},
                arm_idx=np.where(labels == 1)[0])
            labels[ee_idx] = 2
        return RawDTO(
            points=points, rgb=np.asarray(sample["rgb"], np.float32),
            timestamp=_now(), ee2base_pose=sample.get("ee2base_pose"),
            joint_angles=sample.get("joint_angles"),
            id=other.get("position"), labels=labels,
            instance_labels=sample.get("instance_labels"), pose=pose,
            other=other)


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
            timestamp=_now(),
            ee2base_pose=s["ee2base_pose"], joint_angles=s["joint_angles"],
            id=position, gt_pose=_xyzw_to_wxyz(s["pose"]))

    def get_raw(self) -> RawDTO:
        s, position = self._sample()
        return RawDTO(
            points=s["points"], rgb=s["rgb"],
            timestamp=_now(),
            ee2base_pose=s["ee2base_pose"], joint_angles=s["joint_angles"],
            id=position, labels=s["labels"],
            instance_labels=s["instance_labels"],
            pose=_xyzw_to_wxyz(s["pose"]), other={"position": position})
