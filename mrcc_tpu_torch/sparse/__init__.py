"""Sparse voxel core (port of ``mrcc_tpu/sparse``): keys, voxelize, the
level hierarchy, convolutions and layers."""

from .hierarchy import (K2_OFFSETS, K3_OFFSETS, Level, build_hierarchy,
                        hierarchy_caps)
from .quantize import slice_to_points, voxelize
from .types import KEY_PAD, SparseVoxels, pack_key, unpack_key

__all__ = ["K2_OFFSETS", "K3_OFFSETS", "KEY_PAD", "Level", "SparseVoxels",
           "build_hierarchy", "hierarchy_caps", "pack_key", "slice_to_points",
           "unpack_key", "voxelize"]
