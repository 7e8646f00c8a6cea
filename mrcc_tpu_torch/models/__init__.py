"""Models (port of ``mrcc_tpu/models``): the sparse MinkUNet, the RobotNet
pose, encoder, segmentation and voting heads, FeatureNet, the sparse
ResNet / ResFieldNet classifiers and AliveUNet; the dense PointNet2SSG,
PointNet2MSGEncoder and PointNet."""

from .aliveunet import AliveUNet
from .blocks import BLOCKS, EXPANSION, SparseBasicBlock, SparseBottleneck
from .featurenet import FeatureNet
from .minkunet import MinkUNetBase, make_minkunet
from .pointnet2 import (PointBatchNorm, PointNet, PointNet2MSGEncoder,
                        PointNet2SSG)
from .resnet_sparse import (SparseFieldNetwork, SparseResFieldNet,
                            SparseResNet14, SparseResNet18, SparseResNet34,
                            SparseResNet50, SparseResNet101, SparseResNetBase)
from .robotnet import (RobotNet, RobotNetEncode, RobotNetSegmentation,
                       RobotNetVote)

__all__ = ["AliveUNet", "BLOCKS", "EXPANSION", "FeatureNet", "MinkUNetBase",
           "PointBatchNorm", "PointNet", "PointNet2MSGEncoder",
           "PointNet2SSG", "RobotNet", "RobotNetEncode", "RobotNetSegmentation",
           "RobotNetVote", "SparseBasicBlock", "SparseBottleneck",
           "SparseFieldNetwork", "SparseResFieldNet", "SparseResNet14",
           "SparseResNet18", "SparseResNet34", "SparseResNet50",
           "SparseResNet101", "SparseResNetBase", "make_minkunet"]
