"""Sparse U-Net models (port of ``mrcc_tpu/models``: MinkUNet and the
RobotNet segmentation / encoder heads)."""

from .minkunet import MinkUNetBase, make_minkunet
from .robotnet import RobotNetEncode, RobotNetSegmentation

__all__ = ["MinkUNetBase", "RobotNetEncode", "RobotNetSegmentation",
           "make_minkunet"]
