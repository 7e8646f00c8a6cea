"""The JAX package's uniform draws without JAX: ``jax.random.uniform(
jax.random.PRNGKey(seed), shape)`` bit for bit, in numpy.

The recipe of JAX 0.9 with ``jax_threefry_partitionable`` (its default;
``jax/_src/prng.py``): each element's counter is its flat index, split
into hi and lo 32-bit words; the bits are ``x0 ^ x1`` of
``threefry2x32(key, (hi, lo))``; the float is the 23 high bits under the
exponent of 1.0, minus 1.  The dense keypoint stage orders its crop by
these draws (``mrcc_tpu/app/inference_engine.py:533-535``).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (``jax._src.prng._threefry2x32``) of
    the counter words ``x0, x1`` (uint32 arrays) under ``key`` (two
    uint32)."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    seed = int(seed)
    return (np.uint32((seed >> 32) & 0xFFFFFFFF),
            np.uint32(seed & 0xFFFFFFFF))


def uniform(shape, seed: int = 0) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape)``: float32
    draws in [0, 1)."""
    count = int(np.prod(shape))
    idx = np.arange(count, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        x0, x1 = threefry2x32(prng_key(seed), hi, lo)
    bits = (x0 ^ x1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(floats, np.float32(0.0)).reshape(shape)
