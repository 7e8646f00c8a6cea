"""MinkUNet family on the sparse core (port of ``mrcc_tpu/models/minkunet.py``).

conv0 (k3 s1) -> [k2 s2 down + blocks] x4 -> [k2 s2 transpose + skip cat +
blocks] x4 -> final 1x1 conv, over the 5-level hierarchy of
``build_hierarchy(voxels, depth=4)``.  Module names are the reference's
(``conv0p1s1``, ``bn0``, ``block1.0``, ``convtr4p16s2``, ``final``, ...).
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from ..sparse import conv as C
from ..sparse.nn import (SparseBatchNorm, SparseConv1x1, SparseConvDown,
                         SparseConvK3, SparseConvTranspose)
from .blocks import BLOCKS

DEPTH = 4  # stride-2 downsamplings

_VARIANTS = {
    "minkunet14": dict(layers=(1,) * 8, block="basic"),
    "minkunet18": dict(layers=(2,) * 8, block="basic"),
    "minkunet34": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), block="basic"),
    "minkunet50": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), block="bottleneck"),
    "minkunet101": dict(layers=(2, 3, 4, 23, 2, 2, 2, 2), block="bottleneck"),
}
_PLANES = {
    "A": (32, 64, 128, 256, 128, 128, 96, 96),
    "B": (32, 64, 128, 256, 128, 128, 128, 128),
    "C": (32, 64, 128, 256, 192, 192, 128, 128),
    "D": (32, 64, 128, 256, 384, 384, 384, 384),
    "34A": (32, 64, 128, 256, 256, 128, 64, 64),
    "34B": (32, 64, 128, 256, 256, 128, 64, 32),
    "34C": (32, 64, 128, 256, 256, 128, 96, 96),
}
DEFAULT_PLANES = (32, 64, 128, 256, 256, 128, 96, 96)


def variant(name: str) -> dict:
    """``planes``/``layers``/``block`` of a named variant: 'minkunet18D',
    'minkunet14A', 'minkunet34C', 'minkunet18' (default planes) or bare
    'minkunet' (-> 18D, the reference default)."""
    name = name.lower()
    if name == "minkunet":
        name = "minkunet18d"
    base, letter = name[:-1], name[-1].upper()
    if letter not in "ABCD":
        base, letter = name, None
    cfg = dict(_VARIANTS[base])
    cfg["planes"] = DEFAULT_PLANES
    if letter is not None:
        cfg["planes"] = _PLANES[base.replace("minkunet", "") + letter
                                if base == "minkunet34" else letter]
    return cfg


class MinkUNetBase(nn.Module):
    """Configurable sparse U-Net.  ``encoder_only`` builds the stem and the
    four encoder stages only (RobotNetEncode); ``with_final=False`` leaves
    out the final 1x1 conv (RobotNet, which reads ``forward_except_final``).
    ``inplanes`` is the width of the last stage's output."""

    def __init__(self, in_channels: int, out_channels: int,
                 planes: Tuple[int, ...] = DEFAULT_PLANES,
                 layers: Tuple[int, ...] = (2,) * 8, block: str = "basic",
                 init_dim: int = 32, encoder_only: bool = False,
                 with_final: bool = True):
        super().__init__()
        block_cls = BLOCKS[block]
        exp = block_cls.expansion
        self.inplanes = init_dim

        def blocks(planes_i, reps):
            mods = []
            for _ in range(reps):
                mods.append(block_cls(self.inplanes, planes_i))
                self.inplanes = planes_i * exp
            return nn.ModuleList(mods)

        self.conv0p1s1 = SparseConvK3(in_channels, init_dim)
        self.bn0 = SparseBatchNorm(init_dim)
        self.conv1p1s2 = SparseConvDown(init_dim, init_dim)
        self.bn1 = SparseBatchNorm(init_dim)
        self.block1 = blocks(planes[0], layers[0])
        for s in (2, 3, 4):
            stride = 1 << (s - 1)
            setattr(self, f"conv{s}p{stride}s2",
                    SparseConvDown(self.inplanes, self.inplanes))
            setattr(self, f"bn{s}", SparseBatchNorm(self.inplanes))
            setattr(self, f"block{s}", blocks(planes[s - 1], layers[s - 1]))
        if encoder_only:
            return
        skips = (planes[2] * exp, planes[1] * exp, planes[0] * exp, init_dim)
        for i, s in enumerate((4, 5, 6, 7)):
            stride = 1 << (8 - s)
            setattr(self, f"convtr{s}p{stride}s2",
                    SparseConvTranspose(self.inplanes, planes[s]))
            setattr(self, f"bntr{s}", SparseBatchNorm(planes[s]))
            self.inplanes = planes[s] + skips[i]
            setattr(self, f"block{s + 1}", blocks(planes[s], layers[s]))
        if with_final:
            self.final = SparseConv1x1(self.inplanes, out_channels, bias=True)

    @staticmethod
    def _run(blocks, feats, level):
        for blk in blocks:
            feats = blk(feats, level)
        return feats

    def _encoder(self, feats, levels):
        """Stem and encoder; returns the stride-1..16 outputs."""
        l0 = levels[0]
        out = self.bn0(self.conv0p1s1(feats, l0), l0.valid, relu=True)
        skips = [out]
        for s in (1, 2, 3, 4):
            fine, coarse = levels[s - 1], levels[s]
            down = getattr(self, f"conv{s}p{(1 << (s - 1))}s2")
            bn = getattr(self, f"bn{s}")
            out = bn(down(out, fine, coarse), coarse.valid, relu=True)
            out = self._run(getattr(self, f"block{s}"), out, coarse)
            skips.append(out)
        return skips

    def encode(self, feats, levels):
        """Encoder-only forward through block4 (stride 16, level 4)."""
        return self._encoder(feats, levels)[-1]

    def forward_except_final(self, feats, levels):
        """U-Net forward up to the final 1x1 conv: [B, N0, planes[7]]."""
        skips = self._encoder(feats, levels)
        out = skips[-1]
        for s in (4, 5, 6, 7):
            coarse, fine = levels[8 - s], levels[7 - s]
            up = getattr(self, f"convtr{s}p{(1 << (8 - s))}s2")
            bn = getattr(self, f"bntr{s}")
            out = bn(up(out, coarse, fine), fine.valid, relu=True)
            out = C.cat(out, skips[7 - s], fine.valid)
            out = self._run(getattr(self, f"block{s + 1}"), out, fine)
        return out

    def forward(self, feats, levels):
        return self.final(self.forward_except_final(feats, levels),
                          levels[0].valid)


def make_minkunet(name: str, in_channels: int, out_channels: int,
                  encoder_only: bool = False) -> MinkUNetBase:
    """Factory for named variants (see :func:`variant`)."""
    return MinkUNetBase(in_channels, out_channels, encoder_only=encoder_only,
                        **variant(name))


# the JAX package's named constructors (``mrcc_tpu/models/minkunet.py``)
def MinkUNet18D(in_channels, out_channels):
    return make_minkunet("minkunet18D", in_channels, out_channels)


def MinkUNet14A(in_channels, out_channels):
    return make_minkunet("minkunet14A", in_channels, out_channels)


def MinkUNet34C(in_channels, out_channels):
    return make_minkunet("minkunet34C", in_channels, out_channels)


def MinkUNet34A(in_channels, out_channels):
    return make_minkunet("minkunet34A", in_channels, out_channels)


def MinkUNet101(in_channels, out_channels):
    return make_minkunet("minkunet101", in_channels, out_channels)
