"""Sparse U-Net models (port of ``mrcc_tpu/models``: MinkUNet and the
RobotNet pose, encoder and segmentation heads)."""

from .minkunet import MinkUNetBase, make_minkunet
from .robotnet import RobotNet, RobotNetEncode, RobotNetSegmentation

__all__ = ["MinkUNetBase", "RobotNet", "RobotNetEncode",
           "RobotNetSegmentation", "make_minkunet"]
