"""Fixed-capacity sparse voxel containers (port of ``mrcc_tpu/sparse/types.py``).

Every batch item owns a row block ``[B, N, ...]`` with a validity mask;
voxels are sorted by a packed 30-bit key.  Offset coordinates
``off = coord + 512`` lie in ``[0, 1024)`` (10 bits per axis) and pack as
``key = off_x << 20 | off_y << 10 | off_z``.  ``KEY_PAD`` (2**30) marks
padding rows and sorts after every valid key.
"""

from __future__ import annotations

import dataclasses

import torch

COORD_BITS = 10
COORD_RANGE = 1 << COORD_BITS  # 1024
COORD_OFFSET = COORD_RANGE // 2  # 512
KEY_PAD = 1 << (3 * COORD_BITS)  # 2**30, sorts after all valid keys


def pack_key(off: torch.Tensor) -> torch.Tensor:
    """Pack non-negative offset coords ``(..., 3)`` into int32 keys."""
    off = off.to(torch.int32)
    return ((off[..., 0] << (2 * COORD_BITS)) | (off[..., 1] << COORD_BITS)
            | off[..., 2])


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_key` -> ``(..., 3)``; padding unpacks to 0."""
    key = key.to(torch.int32)
    mask = COORD_RANGE - 1
    return torch.stack([(key >> (2 * COORD_BITS)) & mask,
                        (key >> COORD_BITS) & mask, key & mask], dim=-1)


@dataclasses.dataclass(frozen=True)
class SparseVoxels:
    """A batch of sparse voxel grids with per-item fixed capacity.

    off:   int32 [B, N, 3] offset coords (zeros at padding rows).
    key:   int32 [B, N] packed keys, ascending per item; KEY_PAD at padding.
    feats: float [B, N, C] features; zeros at padding rows.
    valid: bool  [B, N].
    count: int32 [B] number of valid voxels per item.
    """

    off: torch.Tensor
    key: torch.Tensor
    feats: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor

    def coords(self) -> torch.Tensor:
        """Signed level-0 voxel coordinates (int32 [B, N, 3])."""
        return self.off - COORD_OFFSET
