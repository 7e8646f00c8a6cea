"""Sparse voxel core (port of ``mrcc_tpu/sparse``): keys, voxelize, the
level hierarchy, convolutions and layers."""

from .hierarchy import (K2_OFFSETS, K3_OFFSETS, Level, build_hierarchy,
                        downsample_level, hierarchy_caps, neighbor_tables,
                        train_uses_k3_tables, uses_k3_tables)
from .quantize import slice_to_points, voxelize
from .types import KEY_PAD, SparseVoxels, pack_key, unpack_key

__all__ = ["K2_OFFSETS", "K3_OFFSETS", "KEY_PAD", "Level", "SparseVoxels",
           "build_hierarchy", "downsample_level", "hierarchy_caps",
           "neighbor_tables", "pack_key", "slice_to_points", "train_uses_k3_tables", "unpack_key",
           "uses_k3_tables", "voxelize"]
