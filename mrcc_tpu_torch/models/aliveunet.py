"""AliveUNet: the config-driven deeper sparse U-Net (port of
``mrcc_tpu/models/aliveunet.py``).

``depth`` down / up stages over the ``depth + 1`` levels of
``build_hierarchy(voxels, depth)``: conv0 (k3) + BN + ReLU, then per stage
a k2 s2 down conv + BN + ReLU and ``block_reps`` blocks of width
``m * (i + 1)``; the decoder mirrors it with k2 s2 transpose convs, the
skip concatenated before its blocks; a final 1x1 conv with bias.  Blocks
are BasicBlocks or Bottlenecks (``block``).

Module names are the JAX module's (``conv0``, ``bn0``, ``down0``,
``bn_down0``, ``enc0.1`` for ``enc0_1``, ``up0``, ``bn_up0``, ``dec0.1``,
``final``); the tree sits at the top level, not under the RobotNet heads'
``unet`` scope (``jax_unet = False``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..sparse import conv as C
from ..sparse.nn import (SparseBatchNorm, SparseConv1x1, SparseConvDown,
                         SparseConvK3, SparseConvTranspose)
from .blocks import BLOCKS, EXPANSION


class AliveUNet(nn.Module):
    """``(feats [B, N0, Cin], levels) -> [B, N0, out_channels]``."""

    jax_unet = False

    def __init__(self, in_channels: int, out_channels: int, m: int = 32,
                 depth: int = 7, block_reps: int = 2,
                 block: str = "bottleneck",
                 init_dim: Optional[int] = None):
        super().__init__()
        self.depth = depth
        block_cls = BLOCKS[block]
        exp = EXPANSION[block]
        init_dim = init_dim or m
        planes = self.planes = tuple(m * i for i in range(1, depth + 1))
        planes = planes + planes[::-1]

        def blocks(width, p):
            mods = []
            for _ in range(block_reps):
                mods.append(block_cls(width, p))
                width = p * exp
            return nn.ModuleList(mods), width

        self.conv0 = SparseConvK3(in_channels, init_dim)
        self.bn0 = SparseBatchNorm(init_dim)
        width, skips = init_dim, []
        for i in range(depth):
            setattr(self, f"down{i}", SparseConvDown(width, width))
            setattr(self, f"bn_down{i}", SparseBatchNorm(width))
            mods, width = blocks(width, planes[i])
            setattr(self, f"enc{i}", mods)
            skips.append(width)
        for i in range(depth):
            j = depth - 1 - i
            setattr(self, f"up{i}", SparseConvTranspose(width,
                                                        planes[depth + i]))
            setattr(self, f"bn_up{i}", SparseBatchNorm(planes[depth + i]))
            skip = skips[j - 1] if j > 0 else init_dim
            mods, width = blocks(planes[depth + i] + skip, planes[depth + i])
            setattr(self, f"dec{i}", mods)
        self.final = SparseConv1x1(width, out_channels, bias=True)

    def forward(self, feats, levels: Tuple):
        d = self.depth
        if len(levels) < d + 1:
            raise ValueError(f"AliveUNet depth {d}: need {d + 1} hierarchy "
                             f"levels, got {len(levels)}")

        def run(mods, x, level):
            for blk in mods:
                x = blk(x, level)
            return x

        l0 = levels[0]
        stem = torch.relu(self.bn0(self.conv0(feats, l0), l0.valid))
        out, skips = stem, []
        for i in range(d):
            fine, coarse = levels[i], levels[i + 1]
            out = getattr(self, f"down{i}")(out, fine, coarse)
            out = torch.relu(getattr(self, f"bn_down{i}")(out, coarse.valid))
            out = run(getattr(self, f"enc{i}"), out, coarse)
            skips.append(out)
        for i in range(d):
            j = d - 1 - i
            coarse, fine = levels[j + 1], levels[j]
            out = getattr(self, f"up{i}")(out, coarse, fine)
            out = torch.relu(getattr(self, f"bn_up{i}")(out, fine.valid))
            out = C.cat(out, skips[j - 1] if j > 0 else stem, fine.valid)
            out = run(getattr(self, f"dec{i}"), out, fine)
        return self.final(out, l0.valid)
