"""Calibration application (port of ``mrcc_tpu/app``): the inference
engine with its product API, the DTOs and the synthetic data engine."""

from . import data_engine, dto, inference_engine
from .data_engine import DataEngineInterface, SyntheticDataEngine
from .dto import (CalibrationResultDTO, PointCloudDTO, RawDTO, ResultDTO,
                  TestResultDTO)
from .inference_engine import InferenceConfig, InferenceEngine, measure_seg_caps

__all__ = ["CalibrationResultDTO", "DataEngineInterface", "InferenceConfig",
           "InferenceEngine", "PointCloudDTO", "RawDTO", "ResultDTO",
           "SyntheticDataEngine", "TestResultDTO", "data_engine", "dto",
           "inference_engine", "measure_seg_caps"]
