"""The rank kernel's block windows (``csrc/rank.cu``), emulated in numpy.

The emulation runs the card kernel's plan with the wrapper's own constants
(``ops.rank.RANK_ROWS`` query rows a block, ``RANK_WINDOW`` staged keys):
per block, chained group (``rank_groups``) and row set (the rows under the
block's largest base, and the rows at it) the window
``[lower_bound(qlo + d0), lower_bound(qhi + d1)]`` of the set's bases
(found from a sample of the keys and a 7-ary search, as the kernel finds
it; the whole row where a query can wrap around int32), staged in shared memory
where it holds at most ``RANK_WINDOW`` keys and the windows before it leave
room, searched in global memory otherwise (testing the window's end keys
first); then each row's chain, reading keys only through its branch's
source (a read outside a staged window fails the test).  It
is held, exactly, against numpy's ``searchsorted`` (left, clamped to N - 1)
and ``isin``, against the plain twin ``rank_lookup`` (CPU), and on sorted
levels against the JAX package's XLA tables
(``hierarchy._neighbor_table_one``: ``hit`` exact, ``idx`` where ``hit``).
``rank_windows`` (which ``chip_smoke.py`` reads for the share of global
windows) gives the emulation's branches.  Cases: sorted levels (a partial
last block, padding runs whose windows fit and ones that do not), query
bases that are not the keys (Nq != N) with an arbitrary delta set,
unsorted query bases, sorted but sparse ones (windows over
``RANK_WINDOW``), and queries that wrap around int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.sparse.hierarchy import K3_OFFSETS as JAX_K3_OFFSETS
from mrcc_tpu.sparse.hierarchy import _neighbor_table_one
from mrcc_tpu_torch.ops import rank
from mrcc_tpu_torch.sparse import KEY_PAD, pack_key
from mrcc_tpu_torch.sparse.hierarchy import K3_DELTAS, k3_bits


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


I32 = np.iinfo(np.int32)
OTHER_DELTAS = (-3, 5, 4, 0, 1, 2, 9, -4, 1 << 10)


def _wrap(q):
    """int64 -> the int32 two's-complement sum the kernel and twin form."""
    return (q - I32.min) % (1 << 32) + I32.min


# csrc/rank.cu's window search: a sample of every stride-th key, then a
# segment of SEG lanes searching the stride (a 7-ary search)
SEG, SAMPLE_STRIDE, MAX_SAMPLES = 6, 256, 1024


def _window_end(kr, q):
    """lower_bound of q in the key row as the kernel finds it: the samples
    under q, then SEG pivots a step inside the stride, the lanes under q a
    prefix of them."""
    n = len(kr)
    stride = max(SAMPLE_STRIDE, -(-n // MAX_SAMPLES))
    a = int(np.searchsorted(kr[::stride], q))
    lo, hi = ((a - 1) * stride + 1 if a else 0,
              a * stride if a < -(-n // stride) else n)
    while lo < hi:
        pivots = [lo + (r + 1) * (hi - lo) // (SEG + 1) for r in range(SEG)]
        c = sum(int(kr[p] < q) for p in pivots)
        assert all(kr[p] < q for p in pivots[:c])  # a prefix
        lo, hi = (pivots[c - 1] + 1 if c else lo,
                  pivots[c] if c < SEG else hi)
    return lo


def emulate(keys, qbase, deltas, qbits):
    """The kernel's plan; returns ``(idx, hit, wide [B, blocks, G, 2])``."""
    order, ds, _ = rank.rank_plan(deltas)
    groups = rank.rank_groups(deltas)
    nb_, n = keys.shape
    nq = qbase.shape[1]
    rows = rank.RANK_ROWS
    idx = np.full((len(deltas), nb_, nq), -1, np.int64)
    hit = np.zeros((len(deltas), nb_, nq), bool)
    wide = np.zeros((nb_, -(-nq // rows), len(groups), 2), bool)
    for b in range(nb_):
        kr = keys[b].astype(np.int64)
        for blk, r0 in enumerate(range(0, nq, rows)):
            qb = qbase[b, r0:r0 + rows].astype(np.int64)
            bits = qbits[b, r0:r0 + rows].astype(np.int64)
            at_max = qb == qb.max()
            # the windows in (group, set) order: set 0 the rows under the
            # block's largest base, set 1 the rows at it
            windows, staged = [], 0
            for j0, j1 in groups:
                for part in (qb[~at_max], qb[at_max]):
                    if not len(part):
                        lo = hi = n
                    elif (part.min() + ds[j0] < I32.min
                          or part.max() + ds[j1 - 1] > I32.max):
                        lo, hi = 0, n
                    else:
                        lo, hi = (_window_end(kr, part.min() + ds[j0]),
                                  _window_end(kr, part.max() + ds[j1 - 1]))
                    length = min(hi, n - 1) - lo + 1
                    fits = length <= rank.RANK_WINDOW
                    staged += length if fits else 0
                    windows.append(_Window(kr, lo, hi, length, not fits
                                           or staged > rank.RANK_WINDOW))
            for g, (j0, j1) in enumerate(groups):
                for v in (0, 1):
                    wide[b, blk, g, v] = windows[2 * g + v].far
                for i in range(len(qb)):
                    _row(windows[2 * g + int(at_max[i])], int(qb[i]),
                         int(bits[i]), ds, order, j0, j1,
                         idx[:, b, r0 + i], hit[:, b, r0 + i])
    return idx, hit, wide


class _Window:
    """A block's window: keys read through it stay inside [lo, lo + len)
    unless it is searched in global memory (``far``)."""

    def __init__(self, kr, lo, hi, length, far):
        self.kr, self.lo, self.hi, self.len, self.far = kr, lo, hi, length, far

    def __getitem__(self, j):
        assert self.far or self.lo <= j < self.lo + self.len, "window"
        return self.kr[j]

    def lower_bound(self, a, z, q):
        """First position in [a, z) with key >= q: in global memory the end
        keys first, then the binary search (the kernel's reads)."""
        if self.far and a < z:
            if self[a] >= q:
                return a
            if self[z - 1] < q:
                return z
            a, z = a + 1, z - 1
        while a < z:
            mid = (a + z) >> 1
            a, z = (mid + 1, z) if self[mid] < q else (a, mid)
        return a


def _row(win, qb, bits, ds, order, j0, j1, idx, hit):
    """One row's chained group: the first delta searched in the window,
    each next rank from the previous one (a search again only where q
    repeats or after q = INT32_MAX); writes ``idx[k]`` / ``hit[k]``."""
    n = len(win.kr)
    r, q_prev, eq_prev = win.lo, 0, False
    for j in range(j0, j1):
        q = int(_wrap(qb + ds[j]))
        if j == j0 or q_prev == I32.max:
            r = win.lower_bound(win.lo, win.hi, q)
        elif eq_prev:
            r += 1
            if r < n and win[r] == q_prev:
                r = win.lower_bound(r, win.hi, q)
        eq = r < n and win[r] == q
        k = order[j]
        idx[k] = min(r, n - 1)
        hit[k] = eq and bool((bits >> k) & 1)
        q_prev, eq_prev = q, eq


def reference(keys, qbase, deltas, qbits):
    """numpy: clamped left ranks and membership of the wrapped queries."""
    q = _wrap(qbase[None].astype(np.int64)
              + np.asarray(deltas, np.int64)[:, None, None])
    n = keys.shape[1]
    idx = np.stack([np.minimum(np.searchsorted(keys[b], q[:, b]), n - 1)
                    for b in range(keys.shape[0])], axis=1)
    found = np.stack([np.isin(q[:, b], keys[b])
                      for b in range(keys.shape[0])], axis=1)
    bits = (qbits[None].astype(np.int64)
            >> np.arange(len(deltas))[:, None, None]) & 1
    return idx, found & bits.astype(bool)


def _level(n, m, seed):
    """Two items of m unique voxels (a sphere's surface and border voxels
    at coordinates 0 / 1, 1022 / 1023, which alias across the packed
    fields) in sorted key order, padded with KEY_PAD to n rows."""
    rng = np.random.default_rng(seed)
    offs, keys, valid = [], [], []
    for _ in range(2):
        v = rng.normal(size=(4 * m, 3))
        sphere = np.rint(512 + 60 * v / np.linalg.norm(v, axis=1,
                                                       keepdims=True))
        border = np.stack([rng.integers(0, 8, 64), rng.integers(0, 8, 64),
                           rng.choice([0, 1, 1022, 1023], 64)], 1)
        pts = np.unique(np.concatenate([sphere, border]).astype(np.int32),
                        axis=0)
        pts = pts[rng.permutation(len(pts))[:m]]
        key = pack_key(torch.as_tensor(pts)).numpy()
        order = np.argsort(key)
        off = np.zeros((n, 3), np.int32)
        off[:m] = pts[order]
        k = np.full((n,), KEY_PAD, np.int32)
        k[:m] = key[order]
        offs.append(off)
        keys.append(k)
        valid.append(np.arange(n) < m)
    return np.stack(offs), np.stack(keys), np.stack(valid)


def _level_case(n, m, seed):
    off, key, valid = _level(n, m, seed)
    bits = k3_bits(torch.as_tensor(off), torch.as_tensor(valid)).numpy()
    return dict(keys=key, qbase=key, deltas=K3_DELTAS, qbits=bits,
                level=(off, key, valid))


def _bits(rng, shape):
    return rng.integers(I32.min, I32.max, size=shape, endpoint=True,
                        dtype=np.int64).astype(np.int32)


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "level":          # every window fits, padding rows included
        return _level_case(1024, 768, 1)
    if name == "level-ragged":   # a partial last block
        return _level_case(1700, 1300, 2)
    if name == "padding":        # padding windows over RANK_WINDOW
        return _level_case(6000, 3000, 3)
    if name == "queries-not-keys":  # Nq != N, an arbitrary delta set
        keys = _level(1024, 700, 4)[1]
        qb = np.concatenate([keys[:, :700:3] + rng.integers(-2, 3, (2, 234)),
                             np.full((2, 466), KEY_PAD)], 1)
        return dict(keys=keys, qbase=np.sort(qb, 1).astype(np.int32),
                    deltas=OTHER_DELTAS, qbits=_bits(rng, (2, 700)))
    if name == "unsorted":
        keys = _level(4096, 3600, 5)[1]
        qb = keys[:, rng.permutation(4096)] + rng.integers(-1, 2, (2, 4096))
        return dict(keys=keys, qbase=qb.astype(np.int32), deltas=K3_DELTAS,
                    qbits=_bits(rng, (2, 4096)))
    if name == "sparse":         # sorted, but a block spans 4096 keys
        keys = np.sort(rng.choice(1 << 16, size=(2, 8192), replace=False),
                       1).astype(np.int32)
        return dict(keys=keys, qbase=keys[:, ::16] + 1,
                    deltas=(0, 1, 2, -7, 40), qbits=_bits(rng, (2, 512)))
    if name == "wrap":           # queries past INT32_MAX / under INT32_MIN
        keys = np.sort(rng.integers(I32.min, I32.max, size=(2, 3000),
                                    dtype=np.int64), 1)
        keys[:, :3] = I32.min
        keys[:, -3:] = I32.max
        qb = np.concatenate([keys[:, :6], rng.integers(
            I32.min, I32.max, size=(2, 600), dtype=np.int64),
            keys[:, -6:] - 1], 1)
        return dict(keys=keys.astype(np.int32),
                    qbase=np.sort(qb, 1).astype(np.int32),
                    deltas=(-5, 0, 1, 2, 3, 1 << 30, -(1 << 30)),
                    qbits=_bits(rng, (2, 612)))
    raise KeyError(name)


# the branches each case must take (at least): "shared", "global" or both
BRANCHES = {"level": {"shared"}, "level-ragged": {"shared"},
            "padding": {"shared", "global"},
            "queries-not-keys": {"shared"}, "unsorted": {"global"},
            "sparse": {"global"}, "wrap": {"shared", "global"}}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_rank_windows_emulation(name):
    c = _case(name)
    keys, qbase, deltas, qbits = c["keys"], c["qbase"], c["deltas"], \
        c["qbits"]
    idx, hit, wide = emulate(keys, qbase, deltas, qbits)
    taken = {"global" if w else "shared" for w in wide.ravel()}
    assert BRANCHES[name] <= taken, taken
    want_idx, want_hit = reference(keys, qbase, deltas, qbits)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(hit, want_hit)
    assert hit.any() and not hit.all()
    # the plain twin, and the windows chip_smoke.py reports
    t_args = [torch.as_tensor(a) for a in (keys, qbase)]
    p_idx, p_hit = rank.rank_lookup(t_args[0], t_args[1], deltas,
                                    torch.as_tensor(qbits))
    np.testing.assert_array_equal(p_idx.numpy(), idx)
    np.testing.assert_array_equal(p_hit.numpy(), hit)
    _, _, t_wide = rank.rank_windows(*t_args, deltas)
    np.testing.assert_array_equal(t_wide.numpy(),
                                  wide.transpose(2, 3, 0, 1))
    if "level" in c:  # the JAX package's XLA tables
        off, key, valid = c["level"]
        j_idx, j_hit = jax.vmap(
            lambda o, k, v: _neighbor_table_one(o, k, v, JAX_K3_OFFSETS),
            out_axes=(1, 1))(jnp.asarray(off), jnp.asarray(key),
                             jnp.asarray(valid))
        j_hit = np.asarray(j_hit)
        np.testing.assert_array_equal(hit, j_hit)
        np.testing.assert_array_equal(np.where(hit, idx, -1),
                                      np.where(j_hit, np.asarray(j_idx), -1))
