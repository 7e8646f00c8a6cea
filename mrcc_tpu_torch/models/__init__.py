"""Sparse U-Net models (port of ``mrcc_tpu/models``: MinkUNet, the
RobotNet pose, encoder, segmentation and voting heads, FeatureNet, the
sparse ResNet / ResFieldNet classifiers and AliveUNet)."""

from .aliveunet import AliveUNet
from .blocks import BLOCKS, EXPANSION, SparseBasicBlock, SparseBottleneck
from .featurenet import FeatureNet
from .minkunet import MinkUNetBase, make_minkunet
from .resnet_sparse import (SparseFieldNetwork, SparseResFieldNet,
                            SparseResNet14, SparseResNet18, SparseResNet34,
                            SparseResNet50, SparseResNet101, SparseResNetBase)
from .robotnet import (RobotNet, RobotNetEncode, RobotNetSegmentation,
                       RobotNetVote)

__all__ = ["AliveUNet", "BLOCKS", "EXPANSION", "FeatureNet", "MinkUNetBase",
           "RobotNet", "RobotNetEncode", "RobotNetSegmentation",
           "RobotNetVote", "SparseBasicBlock", "SparseBottleneck",
           "SparseFieldNetwork", "SparseResFieldNet", "SparseResNet14",
           "SparseResNet18", "SparseResNet34", "SparseResNet50",
           "SparseResNet101", "SparseResNetBase", "make_minkunet"]
