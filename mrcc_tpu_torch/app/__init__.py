"""Inference engine (port of ``mrcc_tpu/app``, batched main path)."""

from .inference_engine import InferenceConfig, InferenceEngine, measure_seg_caps

__all__ = ["InferenceConfig", "InferenceEngine", "measure_seg_caps"]
