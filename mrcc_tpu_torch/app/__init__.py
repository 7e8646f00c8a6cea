"""Calibration application (port of ``mrcc_tpu/app``): the inference
engine with its product API, the DTOs, the pickle, synthetic and ROS data
engines, the headless ``MainApp`` (``app/main.py``),
``calibrate_directory`` (``app/calibrate_pcd.py``) and the ArUco baseline
(``app/aruco_calibration.py``)."""

from . import (aruco_calibration, data_engine, dto, freenect_data_engine,
               inference_engine)
from .aruco_calibration import ArucoCalibrationApp
from .data_engine import (DataEngineInterface, PickleDataEngine,
                          SyntheticDataEngine)
from .freenect_data_engine import FreenectDataEngine
from .dto import (CalibrationResultDTO, PointCloudDTO, RawDTO, ResultDTO,
                  TestResultDTO)
from .inference_engine import InferenceConfig, InferenceEngine, measure_seg_caps

__all__ = ["ArucoCalibrationApp", "CalibrationResultDTO",
           "DataEngineInterface", "FreenectDataEngine", "InferenceConfig",
           "InferenceEngine", "PickleDataEngine", "PointCloudDTO", "RawDTO",
           "ResultDTO", "SyntheticDataEngine", "TestResultDTO",
           "aruco_calibration", "data_engine", "dto", "freenect_data_engine",
           "inference_engine", "measure_seg_caps"]
