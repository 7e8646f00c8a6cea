"""Calibration application (port of ``mrcc_tpu/app``): the inference
engine with its product API, the DTOs, the pickle and synthetic data
engines, the headless ``MainApp`` (``app/main.py``) and
``calibrate_directory`` (``app/calibrate_pcd.py``)."""

from . import data_engine, dto, inference_engine
from .data_engine import (DataEngineInterface, PickleDataEngine,
                          SyntheticDataEngine)
from .dto import (CalibrationResultDTO, PointCloudDTO, RawDTO, ResultDTO,
                  TestResultDTO)
from .inference_engine import InferenceConfig, InferenceEngine, measure_seg_caps

__all__ = ["CalibrationResultDTO", "DataEngineInterface", "InferenceConfig",
           "InferenceEngine", "PickleDataEngine", "PointCloudDTO", "RawDTO",
           "ResultDTO",
           "SyntheticDataEngine", "TestResultDTO", "data_engine", "dto",
           "inference_engine", "measure_seg_caps"]
