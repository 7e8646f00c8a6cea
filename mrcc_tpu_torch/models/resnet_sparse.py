"""Sparse ResNet classifiers and the ResFieldNet front end (port of
``mrcc_tpu/models/resnet_sparse.py``).

stem (k3 s2 map conv + InstanceNorm + ReLU + k2 s2 max pool) -> four
stride-2 residual stages (a strided first block, then ``layers[i] - 1``
blocks on the coarse level) -> dropout -> k3 s3 map conv + InstanceNorm +
GELU (tanh form) -> global max pool -> linear head.  The strided pyramid
is built in the forward pass from the input level with
``sparse.hierarchy.downsample_level`` (rank-kernel child maps and
neighbour tables on every coarse level).  Inference only: the strided map
conv has no backward.

Parameter names are the JAX module's where it has raw parameters
(``stem_kernel``, ``stem_in``, ``drop5``, ``conv5_kernel``, ``in5``,
``final``) and the reference's stage layout elsewhere (``layer1.0.conv1``
for the JAX ``layer1_0/conv1``).  None of the tree sits under the
``unet`` scope of the RobotNet heads (``jax_unet = False``, read by
``interop.jax_path``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..sparse import conv as C
from ..sparse.hierarchy import downsample_level
from ..sparse.nn import (SparseBatchNorm, SparseConv1x1, SparseConvDown,
                         SparseConvK3, SparseDropout, SparseInstanceNorm,
                         gelu, q8_convs)
from .blocks import BLOCKS, EXPANSION


class _StridedBlock(nn.Module):
    """Residual block whose first conv is strided (a ResNet stage's first
    block): fine level -> coarse level.  The residual is the children's max
    pool through a 1x1 conv + BN."""

    def __init__(self, inplanes: int, planes: int, block: str):
        super().__init__()
        self.block = block
        out_ch = planes * EXPANSION[block]
        if block == "basic":
            self.conv1 = SparseConvDown(inplanes, planes)
            self.norm1 = SparseBatchNorm(planes)
            self.conv2 = SparseConvK3(planes, planes)
            self.norm2 = SparseBatchNorm(planes)
        else:
            self.conv1 = SparseConv1x1(inplanes, planes)
            self.norm1 = SparseBatchNorm(planes)
            self.conv2 = SparseConvDown(planes, planes)
            self.norm2 = SparseBatchNorm(planes)
            self.conv3 = SparseConv1x1(planes, out_ch)
            self.norm3 = SparseBatchNorm(out_ch)
        self.downsample = nn.ModuleList([SparseConv1x1(inplanes, out_ch),
                                         SparseBatchNorm(out_ch)])

    def forward(self, feats, fine, coarse):
        cv = coarse.valid
        if self.block == "basic":
            out = torch.relu(self.norm1(self.conv1(feats, fine, coarse), cv))
            out = self.norm2(self.conv2(out, coarse), cv)
        else:
            fv = fine.valid
            out = torch.relu(self.norm1(self.conv1(feats, fv), fv))
            out = torch.relu(self.norm2(self.conv2(out, fine, coarse), cv))
            out = self.norm3(self.conv3(out, cv), cv)
        conv, norm = self.downsample
        residual = norm(conv(C.max_pool_down(feats, fine, coarse), cv), cv)
        return torch.relu(out + residual)


class SparseResNetBase(nn.Module):
    """ResNetBase: ``(feats [B, N, Cin], level0) -> [B, out_channels]``
    logits.  ``level0`` is ``build_hierarchy(voxels, depth=0)[0]``;
    ``stage_caps`` are the seven coarse levels' capacities (default: the
    input capacity halved per level, floor 64)."""

    jax_unet = False
    raw_kernels = ("stem_kernel", "conv5_kernel")

    def __init__(self, in_channels: int, out_channels: int,
                 layers: Tuple[int, ...] = (1, 1, 1, 1),
                 planes: Tuple[int, ...] = (64, 128, 256, 512),
                 block: str = "basic", init_dim: int = 64,
                 dropout: float = 0.5, stage_caps: Tuple[int, ...] = ()):
        super().__init__()
        self.layers = tuple(layers)
        self.stage_caps = tuple(stage_caps)
        exp = EXPANSION[block]
        self.stem_kernel = nn.Parameter(torch.empty(27, in_channels,
                                                    init_dim))
        self.stem_in = SparseInstanceNorm(init_dim)
        inplanes = init_dim
        for s, (p, reps) in enumerate(zip(planes, layers)):
            mods = [_StridedBlock(inplanes, p, block)]
            inplanes = p * exp
            mods += [BLOCKS[block](inplanes, p) for _ in range(1, reps)]
            setattr(self, f"layer{s + 1}", nn.ModuleList(mods))
        self.drop5 = SparseDropout(dropout)
        self.conv5_kernel = nn.Parameter(torch.empty(27, inplanes, inplanes))
        self.in5 = SparseInstanceNorm(inplanes)
        self.final = nn.Linear(inplanes, out_channels)

    def forward(self, feats, level0):
        cap = level0.valid.shape[-1]
        caps = self.stage_caps or tuple(max(cap >> i, 64)
                                        for i in range(1, 8))

        # the k3 order's cue: an int8 net's k3 convs read none
        q8 = (feats.dtype if any(m.q8 for _, m in q8_convs(self))
              else None)

        # stem: k3 s2 conv + IN + ReLU + k2 s2 max pool
        _, l1 = downsample_level(level0, caps[0], stride=2, kernel_size=3,
                                 q8_dtype=q8)
        out = C.conv_kernel_map(feats, self.stem_kernel, l1.child_idx,
                                l1.child_hit, l1.valid)
        out = torch.relu(self.stem_in(out, l1.valid))
        f1, l2 = downsample_level(l1, caps[1], stride=2, kernel_size=2,
                                  q8_dtype=q8)
        cur = C.max_pool_down(out, f1, l2)

        cur_level = l2
        for s in range(len(self.layers)):
            blocks = getattr(self, f"layer{s + 1}")
            fine, coarse = downsample_level(cur_level, caps[2 + s], stride=2,
                                            kernel_size=2, q8_dtype=q8)
            cur = blocks[0](cur, fine, coarse)
            for blk in blocks[1:]:
                cur = blk(cur, coarse)
            cur_level = coarse

        # conv5: dropout + k3 s3 conv + IN + GELU
        cur = self.drop5(cur)
        _, l5 = downsample_level(cur_level, max(64, caps[-1]), stride=3,
                                 kernel_size=3, q8_dtype=q8)
        cur = C.conv_kernel_map(cur, self.conv5_kernel, l5.child_idx,
                                l5.child_hit, l5.valid)
        cur = gelu(self.in5(cur, l5.valid))
        return self.final(C.global_max_pool(cur, l5.valid).float())


def SparseResNet14(in_channels, out_channels, **kw):
    return SparseResNetBase(in_channels, out_channels, layers=(1, 1, 1, 1),
                            **kw)


def SparseResNet18(in_channels, out_channels, **kw):
    return SparseResNetBase(in_channels, out_channels, layers=(2, 2, 2, 2),
                            **kw)


def SparseResNet34(in_channels, out_channels, **kw):
    return SparseResNetBase(in_channels, out_channels, layers=(3, 4, 6, 3),
                            **kw)


def SparseResNet50(in_channels, out_channels, **kw):
    return SparseResNetBase(in_channels, out_channels, layers=(3, 4, 6, 3),
                            block="bottleneck", **kw)


def SparseResNet101(in_channels, out_channels, **kw):
    return SparseResNetBase(in_channels, out_channels, layers=(3, 4, 23, 3),
                            block="bottleneck", **kw)


class SparseFieldNetwork(nn.Module):
    """Sinusoidal per-point feature front end (ResFieldNetBase): two
    sin + linear stages with masked BN and ReLU, the raw features
    concatenated before the second.  Dense layers compute in f32 like
    flax's ``nn.Dense`` over f32 parameters."""

    def __init__(self, in_channels: int, out_channels: int = 64):
        super().__init__()
        self.sin1 = nn.Linear(in_channels, 32)
        self.bn1 = SparseBatchNorm(32)
        self.lin1 = nn.Linear(32, 32)
        self.bn2 = SparseBatchNorm(32)
        self.sin2 = nn.Linear(32 + in_channels, out_channels)
        self.bn3 = SparseBatchNorm(out_channels)
        self.lin2 = nn.Linear(out_channels, out_channels)
        self.bn4 = SparseBatchNorm(out_channels)

    def forward(self, feats, valid):
        x = feats.float()
        h = torch.relu(self.bn1(torch.sin(self.sin1(x)), valid))
        h = torch.relu(self.bn2(self.lin1(h), valid))
        h = torch.cat([h, x], dim=-1)
        h = torch.relu(self.bn3(torch.sin(self.sin2(h)), valid))
        return torch.relu(self.bn4(self.lin2(h), valid))


class SparseResFieldNet(nn.Module):
    """ResFieldNet: the field network on the raw per-voxel features, then
    the ResNet (64 input channels) over the voxelized cloud."""

    jax_unet = False

    def __init__(self, in_channels: int, out_channels: int,
                 layers: Tuple[int, ...] = (1, 1, 1, 1),
                 block: str = "basic"):
        super().__init__()
        self.field = SparseFieldNetwork(in_channels)
        self.resnet = SparseResNetBase(64, out_channels, layers=layers,
                                       block=block)

    def forward(self, feats, level0):
        return self.resnet(self.field(feats, level0.valid), level0)
