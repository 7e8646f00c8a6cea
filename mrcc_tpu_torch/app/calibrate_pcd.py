"""Calibration from a directory of recorded frames (port of
``mrcc_tpu/app/calibrate_pcd.py``, after the reference's
``app/calibrate_pcd.py``): the frames through the engine in chunks, then
one calibration."""

from __future__ import annotations

import glob
import os

import numpy as np

from ..data.dataset import load_sample
from ..data.rgbd import read_pcd
from ..utils.logger import get_logger
from .data_engine import DataEngineInterface, _xyzw_to_wxyz
from .dto import PointCloudDTO
from .inference_engine import InferenceConfig, InferenceEngine
from .main import MainApp


def _pose_sidecar(path):
    return _xyzw_to_wxyz(np.load(path)) if os.path.isfile(path) else None


class DirectoryDataEngine(DataEngineInterface):
    """The frames of a directory, in this order: ``*.pcd`` (with an
    ``*_pose.npy`` ee2base XYZW sidecar, the reference's PCDDataEngine
    layout), ``*.pickle`` samples, then ``*_points.npy`` + ``*_rgb.npy``
    pairs (with an optional ``*_pose.npy``).  Frame ids are ``f1``, ``f2``,
    ...  Unpickling runs code: read only pickles this project wrote."""

    def __init__(self, directory: str):
        self.items = sorted(glob.glob(os.path.join(directory, "*.pickle")))
        self.npy_items = sorted(glob.glob(os.path.join(directory,
                                                       "*_points.npy")))
        self.pcd_items = sorted(glob.glob(os.path.join(directory, "*.pcd")))
        self._i = 0

    def get(self):
        i = self._i
        n_pcd, n_pickle = len(self.pcd_items), len(self.items)
        if i < n_pcd:
            path = self.pcd_items[i]
            points, rgb = read_pcd(path)
            pose = _pose_sidecar(os.path.splitext(path)[0] + "_pose.npy")
        elif i < n_pcd + n_pickle:
            s = load_sample(self.items[i - n_pcd])
            points = np.asarray(s["points"], np.float32)
            rgb = np.asarray(s["rgb"], np.float32)
            pose = s.get("ee2base_pose")
        elif i < n_pcd + n_pickle + len(self.npy_items):
            base = self.npy_items[i - n_pcd - n_pickle][:-len("_points.npy")]
            points = np.load(base + "_points.npy").astype(np.float32)
            rgb = np.load(base + "_rgb.npy").astype(np.float32)
            pose = _pose_sidecar(base + "_pose.npy")
        else:
            return None
        self._i += 1
        return PointCloudDTO(points=points, rgb=rgb, ee2base_pose=pose,
                             id=f"f{self._i}")


def calibrate_directory(directory: str, engine: InferenceEngine = None,
                        chunk: int = 20, device=None):
    """Predict the directory's frames in chunks of ``chunk`` (one position
    each) and calibrate.  ``engine``: default ``InferenceEngine(
    InferenceConfig(), device=device)``, on the card unless
    ``device="cpu"``."""
    engine = engine or InferenceEngine(InferenceConfig(), device=device)
    app = MainApp(DirectoryDataEngine(directory), engine=engine,
                  num_of_frames=chunk, min_num_of_positions=1)
    n = 0
    while app.collect_position(position_id=f"chunk{n}"):
        n += 1
    calib = app.calibrate()
    get_logger().info(f"calibrated from {n} chunks")
    return calib
