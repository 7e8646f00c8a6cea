"""Sparse residual blocks (port of ``mrcc_tpu/models/blocks.py``).

BasicBlock: conv k3 -> BN -> ReLU -> conv k3 -> BN -> (+ residual, through
a 1x1 conv + BN when the width changes) -> ReLU.  Bottleneck (expansion 4):
1x1 -> BN -> ReLU -> k3 -> BN -> ReLU -> 1x1 to ``4 * planes`` -> BN ->
(+ residual, 1x1 + BN when the width changes) -> ReLU.  Submodule names
follow the reference state dict: ``conv1``, ``norm1``, ``conv2``,
``norm2``, (``conv3``, ``norm3``), ``downsample.0/1``.
"""

from __future__ import annotations

from torch import nn

from ..sparse.nn import SparseBatchNorm, SparseConv1x1, SparseConvK3


class SparseBasicBlock(nn.Module):
    """BasicBlock (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = SparseConvK3(inplanes, planes)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConvK3(planes, planes)
        self.norm2 = SparseBatchNorm(planes)
        self.downsample = None
        if inplanes != planes:
            self.downsample = nn.ModuleList([SparseConv1x1(inplanes, planes),
                                             SparseBatchNorm(planes)])

    def forward(self, feats, level):
        valid = level.valid
        out = self.norm1(self.conv1(feats, level), valid, relu=True)
        out = self.conv2(out, level)
        residual = feats
        if self.downsample is not None:
            conv, norm = self.downsample
            residual = norm(conv(feats, valid), valid)
        return self.norm2(out, valid, relu=True, residual=residual)


class SparseBottleneck(nn.Module):
    """Bottleneck (expansion 4)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = SparseConv1x1(inplanes, planes)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConvK3(planes, planes)
        self.norm2 = SparseBatchNorm(planes)
        self.conv3 = SparseConv1x1(planes, out_ch)
        self.norm3 = SparseBatchNorm(out_ch)
        self.downsample = None
        if inplanes != out_ch:
            self.downsample = nn.ModuleList([SparseConv1x1(inplanes, out_ch),
                                             SparseBatchNorm(out_ch)])

    def forward(self, feats, level):
        valid = level.valid
        out = self.norm1(self.conv1(feats, valid), valid, relu=True)
        out = self.norm2(self.conv2(out, level), valid, relu=True)
        out = self.conv3(out, valid)
        residual = feats
        if self.downsample is not None:
            conv, norm = self.downsample
            residual = norm(conv(feats, valid), valid)
        return self.norm3(out, valid, relu=True, residual=residual)


BLOCKS = {"basic": SparseBasicBlock, "bottleneck": SparseBottleneck}
EXPANSION = {name: cls.expansion for name, cls in BLOCKS.items()}
