"""``sparse.hierarchy.downsample_level`` and the rank kernel's child-table
mode (``ops.rank.child_tables``) vs the JAX package (CPU).

The same numpy-seeded levels go through the JAX ``downsample_level``
(``"xla"`` impl: ``_downsample_sort`` / ``_downsample_one`` and the
searchsorted ``_child_table_one``) and the port.  Parents, counts, parent
links and ``parent_ok`` are exactly equal; the strided child maps and the
coarse level's neighbour tables have equal ``hit`` and equal ``idx`` where
``hit`` (a miss's ``idx`` is each side's own clamped rank, ROADMAP C15).
The levels hold voxels on the coordinate window's borders (0 and 1023), so
the scaled border masks decide some queries.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.sparse.hierarchy import Level as JaxLevel
from mrcc_tpu.sparse.hierarchy import _child_table_one
from mrcc_tpu.sparse.hierarchy import downsample_level as jax_downsample
from mrcc_tpu_torch.ops.rank import (INT32_MAX, INT32_MIN, child_query_base,
                                     child_tables)
from mrcc_tpu_torch.sparse import KEY_PAD, Level, downsample_level, pack_key
from mrcc_tpu_torch.sparse.hierarchy import (child_table_plain, k3_bits,
                                             kernel_offsets)

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: under the suite's
    parallel workers torch's default of a thread a core oversubscribes the
    CPU (one small engine call took 185 s at six-way contention on an
    8-core CPU, 1.8 s at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _level(n, seed, fill=0.7):
    """[B, n] sorted unique voxels (about ``fill * n`` valid per item) in a
    small box plus corners of the coordinate window."""
    rng = np.random.default_rng(seed)
    offs, keys, valid = [], [], []
    for b in range(B):
        m = int(n * fill) - 8 * b
        box = rng.integers(0, 24, size=(3 * m, 3)) + rng.integers(0, 3) * 300
        border = np.array([[0, 0, 0], [1023, 1023, 1023], [0, 1023, 5],
                           [1022, 1, 1023], [1021, 1021, 1021],
                           [1020, 0, 0]])
        off = np.unique(np.concatenate([border, box]), axis=0)[:m]
        key = (off[:, 0] << 20) | (off[:, 1] << 10) | off[:, 2]
        order = np.argsort(key)
        off, key = off[order], key[order]
        pad = n - len(key)
        offs.append(np.concatenate([off, np.zeros((pad, 3), int)]))
        keys.append(np.concatenate([key, np.full(pad, KEY_PAD)]))
        valid.append(np.arange(n) < len(key))
    off = np.stack(offs).astype(np.int32)
    key = np.stack(keys).astype(np.int32)
    valid = np.stack(valid)
    return off, key, valid


def _pair(off, key, valid):
    count = valid.sum(1).astype(np.int32)
    jl = JaxLevel(off=jnp.asarray(off), key=jnp.asarray(key),
                  valid=jnp.asarray(valid), count=jnp.asarray(count))
    pl = Level(off=torch.as_tensor(off), key=torch.as_tensor(key),
               valid=torch.as_tensor(valid), count=torch.as_tensor(count))
    return jl, pl


def _same_hits(idx, hit, want_idx, want_hit):
    want_hit = np.asarray(want_hit)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(np.where(want_hit, idx.numpy(), -1),
                                  np.where(want_hit, np.asarray(want_idx), -1))


def _check_levels(jf, jc, fine, coarse, build_k3):
    for name in ("off", "key", "valid", "count"):
        np.testing.assert_array_equal(getattr(coarse, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    for name in ("parent_idx", "parent_ok", "octant"):
        np.testing.assert_array_equal(getattr(fine, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(fine.row_ok.numpy(),
                                  np.asarray(jf.valid & jf.parent_ok))
    _same_hits(coarse.child_idx, coarse.child_hit, jc.child_idx,
               jc.child_hit)
    if build_k3:
        _same_hits(coarse.nbr_idx, coarse.nbr_hit, jc.nbr_idx, jc.nbr_hit)
        np.testing.assert_array_equal(
            coarse.kbits.numpy(),
            k3_bits(coarse.off, coarse.valid).numpy())
    else:
        assert coarse.nbr_idx is None and coarse.kbits is None


@pytest.mark.parametrize("stride,kernel", [(2, 2), (2, 3), (3, 3)])
@pytest.mark.parametrize("capacity", [512, 96])
def test_downsample_level_matches_jax(stride, kernel, capacity):
    off, key, valid = _level(640, seed=stride * 10 + kernel)
    jl, pl = _pair(off, key, valid)
    jf, jc = jax.jit(partial(jax_downsample, capacity=capacity,
                             stride=stride, kernel_size=kernel))(jl)
    fine, coarse = downsample_level(pl, capacity, stride=stride,
                                    kernel_size=kernel)
    _check_levels(jf, jc, fine, coarse, build_k3=True)
    k = 8 if kernel == 2 else 27
    assert coarse.child_idx.shape == (k, B, capacity)
    hit = coarse.child_hit.numpy()
    if stride == 2:  # every parent's children lie in its window
        assert hit.any(axis=0)[coarse.valid.numpy()].all()
    else:  # centred k=3 s=3: a child at 3p + 2 lies outside p's window
        assert hit.any(axis=0)[coarse.valid.numpy()].mean() > 0.5
    if capacity == 96:
        # the capacity overflows: some children lose their parent, and no
        # map entry names them
        ok = fine.parent_ok.numpy()
        assert (~ok & valid).any()
        named = np.zeros_like(valid)
        idx = coarse.child_idx.numpy()
        for b in range(B):
            named[b, idx[:, b][hit[:, b]]] = True
        if kernel == 2:
            np.testing.assert_array_equal(named, ok & valid)
        else:
            assert not (named & ~valid).any()


def test_downsample_level_without_tables():
    off, key, valid = _level(256, seed=5)
    jl, pl = _pair(off, key, valid)
    jf, jc = jax_downsample(jl, 256, stride=2, kernel_size=3,
                            build_k3=False)
    fine, coarse = downsample_level(pl, 256, stride=2, kernel_size=3,
                                    build_k3=False)
    _check_levels(jf, jc, fine, coarse, build_k3=False)


def test_stride2_k2_map_equals_the_scatter_map():
    """The rank kernel's k=2 s=2 map equals build_hierarchy's scatter map
    on hits (both sides of ROADMAP C15's miss contract aside)."""
    from mrcc_tpu_torch.sparse.hierarchy import downsample

    off, key, valid = _level(512, seed=9)
    _, pl = _pair(off, key, valid)
    _, coarse = downsample_level(pl, 300, stride=2, kernel_size=2,
                                 build_k3=False)
    scatter, *_ = downsample(pl.off, pl.valid, 300)
    np.testing.assert_array_equal(coarse.child_hit.numpy(),
                                  scatter.child_hit.numpy())
    h = scatter.child_hit.numpy()
    np.testing.assert_array_equal(np.where(h, coarse.child_idx.numpy(), -1),
                                  np.where(h, scatter.child_idx.numpy(), -1))


@pytest.mark.parametrize("stride,kernel", [(2, 2), (2, 3), (3, 3)])
def test_child_tables_match_child_table_one(stride, kernel):
    off, key, valid = _level(384, seed=40 + stride + kernel)
    _, pl = _pair(off, key, valid)
    _, coarse = downsample_level(pl, 256, stride=stride, kernel_size=2,
                                 build_k3=False)
    offsets = kernel_offsets(kernel)
    idx, hit = child_tables(coarse.off, coarse.key, coarse.valid, pl.key,
                            offsets, stride=stride)
    plain_idx, plain_hit = child_table_plain(coarse.off, coarse.valid,
                                             pl.key, offsets, stride=stride)
    want_idx, want_hit = jax.vmap(
        partial(_child_table_one, offsets=offsets, stride=stride),
        out_axes=(1, 1))(jnp.asarray(coarse.off.numpy()),
                         jnp.asarray(coarse.valid.numpy()),
                         jnp.asarray(key))
    _same_hits(idx, hit, want_idx, want_hit)
    # the plain twin is the JAX function: idx equal on misses too
    np.testing.assert_array_equal(plain_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(plain_hit.numpy(), np.asarray(want_hit))
    assert hit.sum() > coarse.valid.sum()


@pytest.mark.parametrize("stride", [2, 3])
def test_padded_parent_rows_query_key_pad(stride):
    """C15: a padding parent row's query base is KEY_PAD itself, never a
    shifted or multiplied KEY_PAD (which wraps to INT32_MIN); it hits
    nothing, and no block of the rank kernel takes a wrapping window."""
    off, key, valid = _level(256, seed=7, fill=0.4)
    _, pl = _pair(off, key, valid)
    _, coarse = downsample_level(pl, 256, stride=stride, kernel_size=3,
                                 build_k3=False)
    pad = ~coarse.valid
    assert pad.any() and (coarse.key[pad] == KEY_PAD).all()
    qbase = child_query_base(coarse.key, coarse.valid, stride)
    assert (qbase[pad] == KEY_PAD).all()
    assert (qbase >= 0).all()
    np.testing.assert_array_equal(
        qbase[~pad].numpy(),
        pack_key(coarse.off * stride)[~pad].numpy())
    assert not coarse.child_hit[:, pad].any()
    # no query of the kernel wraps around int32 (its whole-row windows)
    deltas = torch.as_tensor(kernel_offsets(3) @ np.array(
        [1 << 20, 1 << 10, 1]))
    q = qbase.long()[None] + deltas[:, None, None]
    assert (q > INT32_MIN).all() and (q <= INT32_MAX).all()
