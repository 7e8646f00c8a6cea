"""Batched key argsort for the sparse core (port of
``mrcc_tpu/sparse/sorting.py``).

One chokepoint for every key sort of the voxel pipeline (voxelize's point
keys, each downsample's parent keys): K1 on the card, its plain twin on the
CPU (``ops/sort.py``).
"""

from __future__ import annotations

from ..ops.sort import argsort


def argsort_keys(key):
    """Stable ascending argsort of packed keys ``[B, N]`` int32.

    Returns ``(sorted_key [B, N], order [B, N] int32)`` with
    ``sorted_key == key.gather(-1, order)`` and index order among equal keys.
    """
    return argsort(key)
