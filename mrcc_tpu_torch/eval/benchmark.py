"""Offline end-to-end benchmark (port of ``mrcc_tpu/eval/benchmark.py``,
after the reference's ``app/test.py`` ``TestApp``): every labelled frame
of a data engine through ``InferenceEngine.predict``, its segmentation,
network-pose, keypoint-pose, ADD and base-to-camera errors against the
ground truth; the confident frames calibrated per position; the report
written by ``eval.report``.  The engine carries the device (the card
unless it was built with ``device="cpu"``); the metrics are host-side."""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ..app.dto import RawDTO, TestResultDTO
from ..geometry.metrics import (compute_add, compute_pose_metrics,
                                compute_segmentation_metrics)
from ..solve.icp import default_template


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _pose_errors(gt, pred):
    m = compute_pose_metrics(_t(gt), _t(pred))
    return float(m["dist_position"]), float(m["angle_diff"])


class BenchmarkApp:
    """Offline benchmark over ``data_engine.get_raw()`` frames."""

    def __init__(self, engine, data_engine, gt_base_to_cam_pose,
                 n_samples=20, ignore_unconfident=True):
        self.engine = engine
        self.data_engine = data_engine
        self.gt_b2c = np.asarray(gt_base_to_cam_pose, np.float32)
        self.n_samples = n_samples
        self.ignore_unconfident = ignore_unconfident
        self.add_points = default_template(512)

    @staticmethod
    def _position_of(raw) -> str:
        """The frame's position: ``other["position"]``, else a ``pN``
        prefix of its id, else ``"all"``."""
        other = getattr(raw, "other", None) or {}
        if isinstance(other, dict) and other.get("position"):
            return str(other["position"])
        m = re.match(r"^(p\d+)", str(raw.id or ""))
        return m.group(1) if m else "all"

    def run(self, out_path: Optional[str] = None):
        """``{"metrics", "calibration", "positions", "report", "table"}``;
        with ``out_path`` the report is written there."""
        metrics = defaultdict(list)
        position_metrics = defaultdict(lambda: defaultdict(list))
        predictions = defaultdict(list)
        for _ in range(self.n_samples):
            raw: RawDTO = self.data_engine.get_raw()
            if raw is None:
                break
            result = self.engine.predict(raw)
            position = self._position_of(raw)

            def record(name, value):
                metrics[name].append(value)
                position_metrics[position][name].append(value)

            if raw.labels is not None and result.segmentation is not None:
                seg = compute_segmentation_metrics(
                    torch.as_tensor(raw.labels.astype(np.int32)),
                    torch.as_tensor(np.asarray(result.segmentation)))
                record("seg_accuracy", float(seg["accuracy"]))
                record("seg_precision", float(seg["precision"]))
                record("seg_recall", float(seg["recall"]))
                for cls, cr in seg["class_results"].items():
                    record(f"seg_{cls}_precision", float(cr["precision"]))
                    record(f"seg_{cls}_recall", float(cr["recall"]))
            if result.ee_pose is not None and raw.pose is not None:
                t_err, r_err = _pose_errors(raw.pose, result.ee_pose)
                record("nn_translation_m", t_err)
                record("nn_rotation_rad", r_err)
                record("nn_add_m", float(compute_add(
                    _t(self.add_points), _t(raw.pose), _t(result.ee_pose))))
            if result.key_points_pose is not None and raw.pose is not None:
                t_err, r_err = _pose_errors(raw.pose, result.key_points_pose)
                record("kp_translation_m", t_err)
                record("kp_rotation_rad", r_err)
            if raw.ee2base_pose is not None and result.base_pose is not None:
                t_err, r_err = _pose_errors(self.gt_b2c, result.base_pose)
                record("base2cam_translation_m", t_err)
                record("base2cam_rotation_rad", r_err)
            if result.is_confident or not self.ignore_unconfident:
                t = TestResultDTO(segmentation=None,
                                  is_confident=result.is_confident)
                t.ee_pose = result.ee_pose
                t.base_pose = result.base_pose
                t.key_points_pose = result.key_points_pose
                t.key_points_base_pose = result.key_points_base_pose
                predictions[raw.id or "p1"].append(t)

        calibration = (self.engine.calibrate(predictions) if predictions
                       else None)
        calib_err = None
        if (calibration is not None
                and calibration.pose_camera_link is not None):
            t_err, r_err = _pose_errors(self.gt_b2c,
                                        calibration.pose_camera_link)
            calib_err = {"translation_m": t_err, "rotation_rad": r_err}
            metrics["calib_translation_m"].append(t_err)
            metrics["calib_rotation_rad"].append(r_err)
        position_metrics = {p: dict(v) for p, v in position_metrics.items()}
        report_path = table = None
        if out_path:
            from .report import write_report

            report_path, table = write_report(
                dict(metrics), out_path, extra={"calibration": calib_err},
                position_metrics=position_metrics)
        return {"metrics": dict(metrics), "calibration": calib_err,
                "positions": position_metrics, "report": report_path,
                "table": table}
