"""The calibration application's headless loop (port of
``mrcc_tpu/app/main.py``, after the reference's ``app/main.py``
``MainApp``): an update loop of frames from a data engine through the
inference engine, a collection phase of ``num_of_frames`` results per
robot position, and a calibration once ``min_num_of_positions`` positions
are in (``INFERENCE.CALIBRATION``: 10 frames, 5 positions).

The engine runs on the card unless it is given one built with
``device="cpu"``.  With ``snapshot_dir`` every frame of the update loop
is also drawn to ``{snapshot_dir}/frame_{id}.png`` (segmentation colours,
the pose's axes, the keypoints; ``utils/visualization.py``, which needs
matplotlib)."""

from __future__ import annotations

import collections
import time
import typing

from ..utils.logger import get_logger
from .dto import CalibrationResultDTO, ResultDTO
from .inference_engine import InferenceConfig, InferenceEngine


class MainApp:
    def __init__(self, data_source, engine: InferenceEngine = None,
                 num_of_frames: int = 10, min_num_of_positions: int = 5,
                 frame_period_s: float = 0.0, snapshot_dir: str = None,
                 device=None):
        """``engine``: default ``InferenceEngine(InferenceConfig(),
        device=device)``."""
        self.data_source = data_source
        self.engine = engine or InferenceEngine(InferenceConfig(),
                                                device=device)
        self.num_of_frames = num_of_frames
        self.min_num_of_positions = min_num_of_positions
        self.frame_period_s = frame_period_s
        self.snapshot_dir = snapshot_dir
        self.collected: typing.Dict[str, list] = collections.defaultdict(list)
        self.log = get_logger()

    def step(self) -> typing.Optional[ResultDTO]:
        """One update-loop iteration: the next frame through the engine,
        paced to ``frame_period_s``; None when the source is exhausted."""
        data = self.data_source.get()
        if data is None:
            return None
        t0 = time.time()
        result = self.engine.predict(data)
        dt = time.time() - t0
        self.log.info(
            f"frame id={data.id} ee_pts="
            f"{int((result.segmentation == 2).sum())} "
            f"confident={result.is_confident} ({dt:.2f}s)")
        if self.snapshot_dir:
            from ..utils.visualization import save_scene_snapshot

            save_scene_snapshot(data, result,
                                f"{self.snapshot_dir}/frame_{data.id}.png")
        if self.frame_period_s and dt < self.frame_period_s:
            time.sleep(self.frame_period_s - dt)
        return result

    def collect_position(self, position_id: str = None) -> int:
        """Up to ``num_of_frames`` results for the current position, under
        ``position_id`` or each frame's id; returns how many."""
        count = 0
        for _ in range(self.num_of_frames):
            data = self.data_source.get()
            if data is None:
                break
            result = self.engine.predict(data)
            self.collected[position_id or data.id or "p1"].append(result)
            count += 1
        self.log.info(f"collected {count} frames for position "
                      f"{position_id or 'auto'}")
        return count

    def calibrate(self) -> CalibrationResultDTO:
        """The extrinsic from the collected positions (a warning below
        ``min_num_of_positions``)."""
        if len(self.collected) < self.min_num_of_positions:
            self.log.warning(
                f"need >= {self.min_num_of_positions} positions, have "
                f"{len(self.collected)}")
        calibration = self.engine.calibrate(dict(self.collected))
        if calibration.pose_camera_link is not None:
            vals = ", ".join(f"{v:.4f}"
                             for v in calibration.pose_camera_link.tolist())
            print(f"Latest calibration: [{vals}]")
        return calibration

    def run(self, n_positions: int = None) -> CalibrationResultDTO:
        """A headless session: collect ``n_positions`` positions (default
        ``min_num_of_positions``), then calibrate."""
        for _ in range(n_positions or self.min_num_of_positions):
            self.collect_position()
        return self.calibrate()
