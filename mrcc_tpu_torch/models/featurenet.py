"""FeatureNet: a metric-learning embedding over sparse voxels (port of
``mrcc_tpu/models/featurenet.py``, after the reference's
``model/featurenet.py``): the whole MinkUNet34A forward, its final 1x1 conv
to the embedding width included, then BatchNorm, LeakyReLU 0.01 and a
global average pool.  Trained with ``train.metric_learning``'s mined
triplet loss on object clouds.

The state dict holds the backbone's names at the top level and the
batch norm as ``final_bn``; in the JAX tree ``final_bn`` sits beside the
backbone's ``unet`` scope, not in it (``interop.translate_key``).
"""

from __future__ import annotations

import torch.nn.functional as F

from ..sparse import conv as C
from ..sparse.nn import SparseBatchNorm
from .minkunet import MinkUNetBase, variant


class FeatureNet(MinkUNetBase):
    """``(feats, levels) -> [B, out_channels]`` embeddings."""

    def __init__(self, in_channels: int = 3, out_channels: int = 16,
                 backbone: str = "minkunet34A"):
        super().__init__(in_channels, out_channels, **variant(backbone))
        self.final_bn = SparseBatchNorm(out_channels)

    def forward(self, feats, levels):
        valid = levels[0].valid
        out = self.final_bn(super().forward(feats, levels), valid)
        return C.global_avg_pool(F.leaky_relu(out, 0.01), valid)
