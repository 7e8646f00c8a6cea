"""Sparse U-Net models (port of ``mrcc_tpu/models``: MinkUNet, the
RobotNet pose, encoder, segmentation and voting heads, and FeatureNet)."""

from .featurenet import FeatureNet
from .minkunet import MinkUNetBase, make_minkunet
from .robotnet import (RobotNet, RobotNetEncode, RobotNetSegmentation,
                       RobotNetVote)

__all__ = ["FeatureNet", "MinkUNetBase", "RobotNet", "RobotNetEncode",
           "RobotNetSegmentation", "RobotNetVote", "make_minkunet"]
