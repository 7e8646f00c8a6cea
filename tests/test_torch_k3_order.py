"""A level's k3 order (``ops/k3_order.py``) on the CPU: the plain twin of
the order's build, which the card's kernels are held to integer for
integer (``tests/test_torch_kernels.py``), against a numpy reckoning.

- Masks, each segment's stable order, each tile's rows with their flags,
  neighbours and compacted offsets with their 16-row group masks, and each
  (segment, item)'s count of tiles with rows equal a
  loop over rows and offsets in numpy, for three and nine segments, one
  segment sorted by the whole mask and the one-segment identity order, on
  levels with padding rows and with border rows whose ``kbits`` bits are
  off; the key search and the level's neighbour tables give the same
  order.
- Every (row, offset) hit lies in exactly one tile of its segment, and
  every row with no hit in exactly one tile of segment 0.
- On a benchmark scene's level 0 (``mrccbench/data/scenes.py``, 0.01 m
  voxels) the order cuts the tile's ring stages per hit at least 2x
  (``ops.conv.k3_tile_stages``), so a regression of the grouping shows;
  its count of the one-pass tile's stages from the masks alone is the
  identity order's.
- ``build_hierarchy`` builds the order only for card levels (the plain
  twins of the convs need none); a CPU conv given an order is the conv
  without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.ops import conv, k3_order
from mrcc_tpu_torch.sparse import build_hierarchy, neighbor_tables, voxelize
from mrcc_tpu_torch.sparse import conv as sconv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(pts, rgb, mask, q, capacity, caps):
    vox, _ = voxelize(torch.as_tensor(pts), torch.as_tensor(rgb),
                      torch.as_tensor(mask), q, capacity)
    return build_hierarchy(vox, len(caps), capacities=caps)


@pytest.fixture(scope="module")
def synthetic():
    """Two synthetic clouds: level 0 of 1500 rows (not a multiple of 64,
    padding after the voxels), level 1 of 1000 and level 2 of 500."""
    pts, rgb, mask = build_batch(2, 2048, seed=11)
    return _levels(pts, rgb, mask, 1 / 40.0, 1500, (1000, 500))


@pytest.fixture(scope="module")
def border():
    """Keys over the whole 10-bit window: rows at 0 and 1023 on an axis,
    whose out-of-window offsets have their ``kbits`` bit off."""
    ax = np.array([0, 1, 2, 511, 512, 1021, 1022, 1023])
    off = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pts = ((off - 512 + 0.5) * 0.01).astype(np.float32)
    pts = np.stack([pts, pts[::-1].copy()])
    rgb = np.random.default_rng(0).random(pts.shape, np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 400:] = False
    return _levels(pts, rgb, mask, 0.01, 640, (320,))


def _deltas():
    off = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]
    return [(dx << 20) + (dy << 10) + dz for dx, dy, dz in off]


def reckon(key, kbits, segments, sort):
    """The order of numpy arrays key / kbits [B, N], row by row."""
    key, kbits = np.asarray(key), np.asarray(kbits)
    b_n, n = key.shape
    ks = 27 // segments
    tiles = -(-n // 64)
    out = np.zeros((segments, b_n, tiles, k3_order.order_list_ints(ks)),
                   np.int64)
    masks = np.zeros((b_n, n), np.int64)
    counts = np.zeros((segments, b_n), np.int64)
    for b in range(b_n):
        where = {int(k): i for i, k in enumerate(key[b])}
        nbr = np.full((n, 27), -1)
        for i in range(n):
            for k, d in enumerate(_deltas()):
                if (kbits[b, i] >> k) & 1:
                    nbr[i, k] = where.get(int(key[b, i]) + d, -1)
        mask = [sum(1 << k for k in range(27) if nbr[i, k] >= 0)
                for i in range(n)]
        masks[b] = mask
        for s in range(segments):
            def sub(i):
                return (mask[i] >> (s * ks)) & ((1 << ks) - 1)
            if sort:
                members = [i for i in range(n)
                           if sub(i) or (s == 0 and mask[i] == 0)]
                members.sort(key=lambda i: (sub(i), i))
            else:
                members = list(range(n))
            for t in range(tiles):
                lst = out[s, b, t]
                lst[:ks * 64] = -1
                rows = members[64 * t:64 * t + 64]
                row_part = np.full(64, -1)
                for r, i in enumerate(rows):
                    flag = 0
                    if mask[i] & ((1 << (s * ks)) - 1):
                        flag |= k3_order.ROW_LOAD
                    if mask[i] >> ((s + 1) * ks) == 0:
                        flag |= k3_order.ROW_FINAL
                    row_part[r] = i | flag
                    for j in range(ks):
                        lst[j * 64 + r] = nbr[i, s * ks + j]
                lst[ks * 64:ks * 64 + 64] = row_part
                klist = []
                for j in range(ks):
                    groups = 0
                    for r in range(len(rows)):
                        if lst[j * 64 + r] >= 0:
                            groups |= 1 << (r // 16)
                    if groups:
                        klist.append(j | groups << 8)
                base = ks * 64 + 64
                lst[base:base + len(klist)] = klist
                lst[base + ks] = len(klist)
                lst[base + ks + 1] = len(rows)
            counts[s, b] = -(-len(members) // 64)
    return masks, out, counts


ORDERS = [(3, True), (9, True), (1, True), (1, False)]


@pytest.mark.parametrize("segments,sort", ORDERS)
@pytest.mark.parametrize("which,l", [("synthetic", 0), ("synthetic", 2),
                                     ("border", 0), ("border", 1)])
def test_order_equals_numpy(request, which, l, segments, sort):
    lv = request.getfixturevalue(which)[l]
    if which == "border":
        assert int((lv.kbits[lv.valid] != (1 << 27) - 1).sum()) > 0
    assert bool((~lv.valid).any())
    got = k3_order.build_k3_order(lv.key, lv.kbits, segments=segments,
                                  sort=sort)
    mask, lists, counts = reckon(lv.key.numpy(), lv.kbits.numpy(), segments,
                                 sort)
    assert np.array_equal(got.mask.numpy(), mask)
    assert got.lists.dtype == got.counts.dtype == torch.int32
    assert np.array_equal(got.lists.numpy(), lists)
    assert np.array_equal(got.counts.numpy(), counts)
    tables = neighbor_tables(lv)
    on_tables = k3_order.build_k3_order(lv.key, lv.kbits, *tables,
                                        segments=segments, sort=sort)
    assert torch.equal(on_tables.lists, got.lists)
    assert torch.equal(on_tables.counts, got.counts)
    assert torch.equal(on_tables.mask, got.mask)


@pytest.mark.parametrize("which,l", [("synthetic", 0), ("synthetic", 1),
                                     ("border", 0)])
def test_every_hit_in_one_tile_of_its_segment(request, which, l):
    lv = request.getfixturevalue(which)[l]
    order = k3_order.level_order(lv)
    nbr, rows, klist, count, live = order.fields()
    b, n = lv.key.shape
    ks = order.offsets
    seen = torch.zeros((b, n, 27), dtype=torch.int64)
    zero_rows = torch.zeros((b, n), dtype=torch.int64)
    for s in range(order.segments):
        for bi in range(b):
            r = rows[s, bi]                                 # [T, 64]
            ok = r >= 0
            idx = (r & k3_order.ROW_INDEX)[ok].long()
            assert int(live[s, bi].sum()) == len(idx)
            hit = (nbr[s, bi].transpose(1, 2)[ok] >= 0).long()  # [M, ks]
            seen[bi].index_add_(0, idx, torch.nn.functional.pad(
                hit, (s * ks, 27 - (s + 1) * ks)))
            if s == 0:
                zero_rows[bi].index_add_(0, idx, (order.mask[bi][idx] == 0)
                                         .long())
    bits = (order.mask[..., None] >> torch.arange(27)) & 1
    assert torch.equal(seen, bits.long())
    assert torch.equal(zero_rows, (order.mask == 0).long())
    assert bool((order.mask[~lv.valid] == 0).all())
    assert bool((count <= ks).all())


@pytest.mark.parametrize("which,l", [("synthetic", 0), ("synthetic", 2),
                                     ("border", 0)])
def test_key_order_stages_are_the_identity_orders(request, which, l):
    """The one-pass tile's stages counted from the masks alone equal those
    of the one-segment identity order, its own schedule."""
    lv = request.getfixturevalue(which)[l]
    identity = k3_order.build_k3_order(lv.key, lv.kbits, segments=1,
                                       sort=False)
    assert k3_order.key_order_stages(identity.mask) == \
        k3_order.tile_stages(identity)
    assert k3_order.tile_stages(identity)[0] > 0


def test_order_cuts_stages_on_a_benchmark_scene():
    """Level 0 of one ``scenes24k-b8`` scene: ~4.2 ring stages a hit in
    row order, ~1.4 in the order (a 64-row tile, 27 offsets in three
    segments); the cut must stay at least 2x."""
    from mrccbench.data import scenes

    batch = scenes.train_batch(scenes.scene_seeds(0, 1), 32768, 4096, 6000,
                               14000)
    lv = _levels(batch["points"], batch["feats"], batch["mask"], 0.01,
                 16384, (8192,))[0]
    st = conv.k3_tile_stages(lv)
    assert st["hits"] > 0
    assert st["stages_row_order"] >= 2 * st["stages_ordered"]
    assert st["mma_row_order"] >= 2 * st["mma_ordered"]
    assert st["stages_ordered"] >= 1.0 and st["mma_ordered"] >= 1.0


def test_cpu_levels_carry_no_order_and_convs_ignore_one(synthetic):
    lv = synthetic[0]
    assert all(level.k3_order is None for level in synthetic)
    ordered = dataclasses.replace(lv, k3_order=k3_order.level_order(lv))
    gen = torch.Generator().manual_seed(0)
    f = torch.randn(lv.key.shape + (12,), generator=gen)
    w = torch.randn((27, 12, 20), generator=gen)
    assert torch.equal(sconv.conv_k3(f, w, ordered), sconv.conv_k3(f, w, lv))
