"""The NN kernel's target splits (``csrc/nn_search.cu``), emulated in numpy.

The emulation runs the card kernel's plan with the wrapper's own split
(``ops.nn.nn_splits``: S splits of L targets from ``NN_THREADS``,
``NN_POINTS``, ``NN_BLOCKS`` and ``NN_MIN_SPLIT``) in float32, each product
and sum rounded on its own in the kernel's order: per split the first
minimum of its targets, then the splits merged in ascending order on a
strictly smaller d2.  It must give the bits of one sequential scan: it is
held bit for bit against numpy's ``argmin`` over the whole row (the same
expression) and against the plain twin ``nn_search`` on the CPU, and
against the JAX package's ``nn_search_pallas`` (interpret mode) with
``tests/test_torch_nn.py``'s tolerance (d2 within 1e-5, indices equal
except at near-ties: JAX sums the dot product in another order).  Cases:
equal minima on both sides of a split edge and in far splits (the lower
index wins), a row whose targets are all invalid (idx 0, d2 = |a|^2 + 1e30
rounded), M and N that are multiples of neither the tile nor the split,
B = 1, and N = 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.ops import nn_pallas
from mrcc_tpu_torch.ops import nn

F = np.float32


def _d2(tmpl, tgt, mask):
    """The kernel's d2 [B, M, N] in float32, in its order."""
    b = np.where(mask[..., None], tgt, F(0))
    bx, by, bz = (b[:, None, :, c] for c in range(3))
    ax, ay, az = (tmpl[:, :, None, c] for c in range(3))
    sqs = (ax * ax + ay * ay) + az * az
    sqt = np.where(mask[:, None, :], (bx * bx + by * by) + bz * bz, F(1e30))
    return (sqs - F(2) * ((ax * bx + ay * by) + az * bz)) + sqt


def emulate(tmpl, tgt, mask):
    """The kernel's plan: ``(idx, d2, S)``."""
    b, m, _ = tmpl.shape
    n = tgt.shape[1]
    splits, length = nn.nn_splits(b, m, n)
    assert (splits - 1) * length < n <= splits * length
    d2 = _d2(tmpl, tgt, mask)
    best = np.full((b, m), np.inf, F)
    best_j = np.zeros((b, m), np.int64)
    for s in range(splits):
        part = d2[..., s * length:(s + 1) * length]
        j = part.argmin(-1)                  # the split's first minimum
        d = np.take_along_axis(part, j[..., None], -1)[..., 0]
        better = d < best
        best = np.where(better, d, best)
        best_j = np.where(better, j + s * length, best_j)
    return best_j, best, splits


def _points(rng, shape):
    return (rng.normal(size=shape) * 0.1 + 1.0).astype(F)


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "split-edge-ties":
        b, m, n = 2, 300, 1000
        tmpl, tgt = _points(rng, (b, m, 3)), _points(rng, (b, n, 3))
        mask = np.ones((b, n), bool)
        length = nn.nn_splits(b, m, n)[1]
        # copies of a target on both sides of the first split edge and in
        # the last split, and template points on them
        for lo, hi in ((length - 1, length), (length + 3, n - 1)):
            tgt[:, hi] = tgt[:, lo]
        tmpl[:, :40] = tgt[:, length - 1][:, None]
        tmpl[:, 40:80] = tgt[:, length + 3][:, None] + F(1e-4)
        return tmpl, tgt, mask
    if name == "all-invalid-row":
        b, m, n = 3, 200, 700
        mask = rng.random((b, n)) > 0.3
        mask[1] = False
        return _points(rng, (b, m, 3)), _points(rng, (b, n, 3)), mask
    if name == "ragged":
        b, m, n = 2, 700, 1111
    elif name == "one-item":
        b, m, n = 1, 1024, 2048
    elif name == "one-target":
        b, m, n = 2, 5, 1
    else:
        raise KeyError(name)
    mask = rng.random((b, n)) > 0.25
    mask[:, 0] = True
    return _points(rng, (b, m, 3)), _points(rng, (b, n, 3)), mask


@pytest.mark.parametrize("name", ["split-edge-ties", "all-invalid-row",
                                  "ragged", "one-item", "one-target"])
def test_nn_splits_emulation(name):
    tmpl, tgt, mask = _case(name)
    idx, d2, splits = emulate(tmpl, tgt, mask)
    assert splits > 1 or tgt.shape[1] < 2 * nn.NN_MIN_SPLIT
    full = _d2(tmpl, tgt, mask)
    np.testing.assert_array_equal(idx, full.argmin(-1))
    np.testing.assert_array_equal(d2.view(np.uint32),
                                  full.min(-1).view(np.uint32))
    p_idx, p_d2 = nn.nn_search(*(torch.as_tensor(a)
                                 for a in (tmpl, tgt, mask)))
    np.testing.assert_array_equal(p_idx.numpy(), idx)
    np.testing.assert_array_equal(p_d2.numpy().view(np.uint32),
                                  d2.view(np.uint32))
    if name == "split-edge-ties":
        length = nn.nn_splits(*tmpl.shape[:2], tgt.shape[1])[1]
        assert (idx[:, :40] == length - 1).all()
        assert (idx[:, 40:80] == length + 3).all()
    if name == "all-invalid-row":
        sqs = (tmpl[1, :, 0] * tmpl[1, :, 0] + tmpl[1, :, 1] * tmpl[1, :, 1]
               ) + tmpl[1, :, 2] * tmpl[1, :, 2]
        assert (idx[1] == 0).all() and (d2[1] == sqs + F(1e30)).all()
    for b in range(tmpl.shape[0]):   # the JAX kernel, interpret mode
        w_idx, w_d2 = nn_pallas.nn_search_pallas(
            jnp.asarray(tmpl[b]), jnp.asarray(tgt[b]), jnp.asarray(mask[b]),
            tile_m=tmpl.shape[1], interpret=True)
        np.testing.assert_allclose(d2[b], np.asarray(w_d2), atol=1e-5)
        two = np.sort(full[b], axis=1)[:, :2] if full.shape[2] > 1 else \
            np.concatenate([full[b], full[b] + 1], 1)
        tie = (two[:, 1] - two[:, 0]) <= 1e-6 * (tmpl[b] ** 2).sum(-1)
        differ = idx[b] != np.asarray(w_idx)
        assert not (differ & ~tie).any(), np.flatnonzero(differ & ~tie)
