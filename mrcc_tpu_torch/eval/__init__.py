"""Evaluation harnesses and benchmark reports (port of
``mrcc_tpu/eval``)."""

from . import benchmark, harness, report  # noqa: F401
from .benchmark import BenchmarkApp  # noqa: F401
from .harness import (evaluate_key_points, evaluate_pose,  # noqa: F401
                      evaluate_segmentation, evaluate_vote)
from .report import build_report_table, write_report  # noqa: F401
