"""Card-only tests: each CUDA kernel of mrcc_tpu_torch vs its plain twin.

Marked ``gpu``; each test skips where ``torch.cuda.is_available()`` is
false.  This file imports no JAX (the card's machine has none), so it runs
there on its own:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the sort is exact (at any N: 2^18 and a 640 x 480 frame are
past the first kernel's limit); f32 convs and dW kernels agree with the
plain twin to relative norm 1e-5 (summation order; the self-keyed conv's
f32 route is a 3xTF32 split on tensor cores), bf16 ones with the f32
twin to 2e-2 (K3's down and up also in their stages: the list kernel's
K3 instantiation exact, the list GEMM at the conv tolerances, the child
sum exact; two calls bit-equal); the int8 convs agree with their plain
twins bit for bit (their int32 sums are exact; two calls give the same
bits, and so do the k3-table and the self-keyed int8 routes at equal
groups), their quantised operands equal the quantisation's twin bit for
bit, each call launches its kernels by kind (conv, quantisation, lists,
child sum) as counted, and they agree with the f32 plain conv to 3e-2.  The dW kernels are
deterministic (no float atomics): two launches give the same bits.  The
autograd Functions' backward on the card agrees with autograd through
the plain forward twins to 1e-5.  The rank
kernel equals its plain twin exactly; the k3-table convs hold the conv
tolerances above; the nearest-neighbour kernel's d2 is within 1e-5 of its
twin and its indices equal except at near-ties (the two smallest d2 of a
row within 1e-6 of |a|^2, the scale of the f32 rounding of
|a|^2 - 2ab + |b|^2).  The k3-table dW kernel holds the dW tolerances and
``K3MapConvFn`` the backward one.  The hit lists of every map kind
(``ops.hit_lists``) equal their plain twin integer for integer (border
keys, overflowed parents, a level of padding rows), and the self-keyed
and table dW give the same bits on one level.  A segmentation train step
launches the list kernel once a map of its hierarchy, and every reader
over a level's held lists gives the bits of the same call listing its map
itself.  One vote step (self-keyed)
and one metric-learning step (every level on tables) hold the card
against the exact step (the CPU's in float64) at the train-step gates
(loss 1e-5, gradients 1e-4, the update 1e-3, BN statistics 1e-5).  The
strided map conv holds the conv tolerances (two launches bit-equal), the
child tables equal the rank kernel's plain twin, and the reduced
SparseResNet50 (f32 1e-4, bf16 2e-2) and AliveUNet (f32 1e-4) hold the
card against the CPU.  B7's k3-table,
down and up modes on f32 features (an int8 engine at f32 compute) equal
their twins bit for bit; ``evaluate_segmentation`` at a reduced size
holds the card against the CPU (metrics 1e-3).  The engine on a 1-rank
NCCL mesh gives the engine's own bits; the host runtime's voxels
(``native``) equal the card voxelizer's (feature means 1e-5).  The k3
order's kernels equal their plain twin integer for integer (both row
sources; two launches a build, one build a level in ``build_hierarchy``),
and K2 and the k3-table conv over it give the same bits (``torch.equal``)
as over the one-segment identity order and as the one-pass tile, f32 and
bf16, forward and data cotangent, padding rows and rows with no hit 0.
"""

import numpy as np
import pytest
import torch

from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.ops import (conv, conv_q8, hit_lists, k3_order, nn, norm,
                                rank, sort)
from mrcc_tpu_torch.sparse import (KEY_PAD, build_hierarchy, neighbor_tables,
                                   voxelize)
from mrcc_tpu_torch.sparse.hierarchy import K3_DELTAS

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def levels(cuda):
    pts, rgb, mask = build_batch(2, 4096, seed=3)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 100.0, 3072)
    return build_hierarchy(vox, 4, capacities=(2048, 1024, 512, 256))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _check_argsort(key):
    before = sort.SORT.launches
    got = sort.argsort(key)
    assert sort.SORT.launches == before + 1
    want = torch.sort(key, dim=-1, stable=True)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1].to(torch.int32))


@pytest.mark.parametrize("n", [1, 2, 77, 4095, 4096, 12544, 16384, 16385,
                               40000, 1 << 17, (1 << 17) + 1, 1 << 18,
                               307200])
def test_argsort_exact(cuda, n):
    """Duplicate-heavy keys with a quarter KEY_PAD rows; 2^18 and 307200
    (a 640 x 480 frame) are past the first kernel's 2^17 limit."""
    gen = torch.Generator().manual_seed(n)
    key = torch.randint(0, max(n // 4, 2), (3, n), generator=gen,
                        dtype=torch.int32)
    key[:, torch.rand(n, generator=gen) < 0.25] = KEY_PAD
    _check_argsort(key.to(cuda))


@pytest.mark.parametrize("kind", ["equal", "pad", "negative"])
@pytest.mark.parametrize("n", [4095, 307200])
def test_argsort_key_kinds(cuda, kind, n):
    """All-equal rows, all-KEY_PAD rows, and negative keys down to the
    int32 limits (the sign flip)."""
    gen = torch.Generator().manual_seed(n + len(kind))
    if kind == "equal":
        key = torch.full((2, n), 12345, dtype=torch.int32)
    elif kind == "pad":
        key = torch.full((2, n), KEY_PAD, dtype=torch.int32)
    else:
        key = torch.randint(-(1 << 31), (1 << 31) - 1, (2, n), generator=gen,
                            dtype=torch.int32)
        key[:, ::7] = -3
        key[:, 1::11] = torch.iinfo(torch.int32).min
        key[:, 2::13] = torch.iinfo(torch.int32).max
    _check_argsort(key.to(cuda))


def test_argsort_rejects(cuda):
    with pytest.raises(ValueError):
        sort.argsort(torch.zeros((2, 8), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        sort.argsort(torch.zeros((2, 8, 3), dtype=torch.int32, device=cuda))


def _feats(level, c, dtype=torch.float32):
    x = torch.randn(level.key.shape + (c,), device=level.key.device)
    return torch.where(level.valid[..., None], x, 0.0).to(dtype)


@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (130, 70)])
@pytest.mark.parametrize("l", [0, 3])
def test_conv_sk(cuda, levels, l, cin, cout):
    lv = levels[l]
    f = _feats(lv, cin)
    w = torch.randn((27, cin, cout), device=cuda) / 9
    want = conv.gather_gemm_sk_plain(f, w, lv.key, lv.kbits)
    before = conv.SK.launches
    got = conv.gather_gemm_sk(f, w, lv.key, lv.kbits)
    assert conv.SK.launches == before + 1
    assert _rel(got, want) <= 1e-5
    got16 = conv.gather_gemm_sk(f.bfloat16(), w.bfloat16(), lv.key, lv.kbits)
    assert got16.dtype == torch.bfloat16 and _rel(got16, want) <= 2e-2


@pytest.fixture(scope="module")
def ragged_level(cuda):
    """A level 0 of 3300 rows (not a multiple of the 64-row tile) with
    3130 / 3030 voxels and padding after them."""
    pts, rgb, mask = build_batch(2, 4096, seed=4)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 100.0, 3300)
    return build_hierarchy(vox, 1, capacities=(1024,))[0]


def _check_sk(lv, cin, cout, scale=1.0):
    f = _feats(lv, cin)
    w = torch.randn((27, cin, cout), device=lv.key.device) * scale / cin**0.5
    want = conv.gather_gemm_sk_plain(f, w, lv.key, lv.kbits)
    before = conv.SK.launches
    got = conv.gather_gemm_sk(f, w, lv.key, lv.kbits)
    assert conv.SK.launches == before + 1
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5
    got16 = conv.gather_gemm_sk(f.bfloat16(), w.bfloat16(), lv.key, lv.kbits)
    assert got16.dtype == torch.bfloat16 and _rel(got16, want) <= 2e-2
    return got, got16


@pytest.mark.parametrize("cout", [32, 96, 256, 384])
@pytest.mark.parametrize("cin", [3, 32, 96, 384, 416])
def test_conv_sk_widths(cuda, ragged_level, cin, cout):
    """The main paths' widths (ragged Cin 3, Cin / Cout not multiples of
    the MMA tile) over 3300 rows: f32 (3xTF32) 1e-5, bf16 2e-2."""
    assert ragged_level.key.shape[1] % 64 != 0
    _check_sk(ragged_level, cin, cout)


@pytest.mark.parametrize("case", ["border", "scattered"])
def test_conv_sk_wide_span(cuda, case):
    """C4: keys over the whole 10-bit window (border keys alias across the
    packed fields; the bitmap gates them) and blobs far apart in key
    order."""
    gen = torch.Generator().manual_seed(len(case))
    if case == "border":
        ax = torch.tensor([0, 1, 2, 3, 511, 512, 1020, 1021, 1022, 1023])
        off = torch.cartesian_prod(ax, ax, ax).float()
    else:
        centres = torch.randint(40, 984, (8, 1, 3), generator=gen)
        off = (centres + torch.randint(-4, 5, (8, 90, 3), generator=gen)) \
            .reshape(-1, 3).float()
    pts = ((off - 512 + 0.5) * 0.01)[None].expand(2, -1, -1).contiguous()
    rgb = torch.rand(pts.shape, generator=gen)
    vox, _ = voxelize(pts.to(cuda), rgb.to(cuda),
                      torch.ones(pts.shape[:2], dtype=torch.bool,
                                 device=cuda), 0.01, 1024)
    lv = build_hierarchy(vox, 1, capacities=(512,))[0]
    _check_sk(lv, 40, 72)


def test_conv_sk_all_padding(cuda, ragged_level):
    """Rows whose bitmap is 0 (padding) hit nothing and come out 0."""
    import dataclasses

    lv = dataclasses.replace(ragged_level,
                             kbits=torch.zeros_like(ragged_level.kbits))
    f = _feats(ragged_level, 96)
    w = torch.randn((27, 96, 256), device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = conv.gather_gemm_sk(f.to(dtype), w.to(dtype), lv.key, lv.kbits)
        assert got.dtype == dtype and not got.any()


def _counts():
    return tuple(c.launches for c in (conv.DOWN, conv.UP, hit_lists.LISTS,
                                      conv.K3_SUM))


def _check_down_up(fine, coarse, cin, cout, row_ok=None, child_hit=None):
    """K3 down over the coarse level's child map and up over the fine
    level's parent map against their plain twins (f32 1e-5, bf16 2e-2 of
    the f32 twin), two calls bit-equal, one launch a call on each counter
    (the list stage and the child sum on theirs).  Returns the f32 down and
    up outputs."""
    row_ok = fine.valid & fine.parent_ok if row_ok is None else row_ok
    child_hit = coarse.child_hit if child_hit is None else child_hit
    w = torch.randn((8, cin, cout), device=fine.key.device) / cin**0.5
    outs = []
    for fn, plain, f, maps, add in (
            (conv.gather_gemm_down, conv.gather_gemm_down_plain,
             _feats(fine, cin), (coarse.child_idx, child_hit), (1, 0, 1, 1)),
            (conv.gather_gemm_up, conv.gather_gemm_up_plain,
             _feats(coarse, cin), (fine.parent_idx, row_ok, fine.octant),
             (0, 1, 1, 0))):
        want = plain(f, w, *maps)
        before = _counts()
        got = fn(f, w, *maps)
        assert _counts() == tuple(a + b for a, b in zip(before, add))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= 1e-5 if want.any() else not got.any()
        assert torch.equal(fn(f, w, *maps), got)  # deterministic
        f16, w16 = f.bfloat16(), w.bfloat16()
        got16 = fn(f16, w16, *maps)
        assert got16.dtype == torch.bfloat16
        assert _rel(got16, want) <= 2e-2 if want.any() else not got16.any()
        assert torch.equal(fn(f16, w16, *maps), got16)
        outs.append(got)
    return outs


@pytest.mark.parametrize("cin,cout", [(32, 32), (20, 90), (130, 70)])
@pytest.mark.parametrize("l", [0, 2])
def test_conv_down_up(cuda, levels, l, cin, cout):
    _check_down_up(levels[l], levels[l + 1], cin, cout)


@pytest.mark.parametrize("l", [0, 2])
def test_k3_stages(cuda, levels, l):
    """K3's stages: the lists of its maps (one launch of the list kernel),
    the list GEMM and the child sum, each against its plain twin: lists
    exact, the GEMM 1e-5 (f32) / 2e-2 (bf16), the child sum exact (the same
    f32 adds in the same order)."""
    fine, coarse = levels[l], levels[l + 1]
    b, nf = fine.key.shape
    nc = coarse.key.shape[1]
    for kind, n_in, maps in (
            ("down", nf, (coarse.child_idx, coarse.child_hit)),
            ("up", nc, (fine.parent_idx, fine.valid & fine.parent_ok,
                        fine.octant))):
        maps = [m.contiguous() for m in maps]
        before = hit_lists.LISTS.launches
        held = hit_lists.HitLists(kind, n_in, *maps)
        lists, count = held.lists, held.count
        assert hit_lists.LISTS.launches == before + 1
        fidx, gidx, want = hit_lists.hit_lists_plain(kind, n_in, *maps)
        assert torch.equal(count, want)
        for k, c in enumerate(want.tolist()):
            assert torch.equal(lists[0, k, :c], fidx[k, :c])
            assert torch.equal(lists[1, k, :c], gidx[k, :c])
        f = _feats(fine if kind == "down" else coarse, 72)
        w = torch.randn((8, 72, 40), device=cuda) / 8
        dst = fidx if kind == "down" else gidx
        rows = b * (nf if kind == "down" else fine.key.shape[1])
        plain = conv.list_gemm_plain(f, w, fidx, dst, want, rows)
        got = conv.list_gemm(f, w, fidx, dst, want, rows)
        assert got.dtype == torch.float32 and _rel(got, plain) <= 1e-5
        got16 = conv.list_gemm(f.bfloat16(), w.bfloat16(), fidx, dst, want,
                               rows)
        assert got16.dtype == torch.float32 and _rel(got16, plain) <= 2e-2
        if kind == "down":
            y = got.reshape(b, nf, -1)
            before = conv.K3_SUM.launches
            for dtype in (torch.float32, torch.bfloat16):
                s = conv.child_sum(y, coarse.child_idx, coarse.child_hit,
                                   dtype)
                assert s.dtype == dtype and torch.equal(
                    s, conv.child_sum_plain(y, coarse.child_idx,
                                            coarse.child_hit, dtype))
            assert conv.K3_SUM.launches == before + 2


@pytest.fixture(scope="module")
def train_pair(cuda):
    """Levels 0 and 1 of the training step's shape: 8 scenes at 1 cm,
    8 x 16384 rows each."""
    pts, rgb, mask = build_batch(8, 24576, seed=6)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 0.01, 16384)
    return build_hierarchy(vox, 1, capacities=(16384,))


@pytest.mark.parametrize("cin,cout", [(416, 384), (384, 416)])
def test_conv_down_up_wide(cuda, train_pair, cin, cout):
    """The decoder's widest K3 shapes on a level pair of 8 x 16384 rows
    each (a product 416 deep, Y 416 wide)."""
    fine, coarse = train_pair
    assert fine.key.shape == coarse.key.shape == (8, 16384)
    _check_down_up(fine, coarse, cin, cout)


@pytest.mark.parametrize("case", ["overflow", "padding"])
def test_conv_down_up_zero_rows(cuda, levels, case):
    """Overflowed parents' children (row_ok false) come out of the up conv
    as zero rows; a level of padding rows (no hit) gives zero outputs."""
    if case == "overflow":
        fine, coarse = _list_hierarchy(cuda, "overflow")[:2]
        dropped = fine.valid & ~fine.parent_ok
        assert bool(dropped.any())
        _, up = _check_down_up(fine, coarse, 40, 72)
        assert not up[dropped].any()
        assert bool(up[fine.valid & fine.parent_ok].abs().sum(-1).gt(0).all())
    else:
        fine, coarse = levels[1], levels[2]
        down, up = _check_down_up(fine, coarse, 40, 72,
                                  row_ok=fine.valid & False,
                                  child_hit=coarse.child_hit & False)
        assert not down.any() and not up.any()


def test_conv_rejects(cuda, levels):
    lv = levels[0]
    f = _feats(lv, 8).double()
    with pytest.raises(ValueError):
        conv.gather_gemm_sk(f, torch.zeros((27, 8, 8), dtype=torch.float64,
                                           device=cuda), lv.key, lv.kbits)
    with pytest.raises(ValueError):
        conv.gather_gemm_sk(f.float(), torch.zeros((27, 8, 8),
                                                   device=cuda).bfloat16(),
                            lv.key, lv.kbits)


@pytest.fixture(scope="module")
def big_levels(cuda):
    """A level 0 of 40000 rows (two ~49k-point scenes at 5 mm)."""
    pts, rgb, mask = build_batch(2, 65536, seed=5)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 200.0, 40000)
    return build_hierarchy(vox, 4, capacities=(32768, 16384, 8192, 4096))


def _check_dw(fn, plain, counter, f, g, maps):
    want = plain(f, g, *maps)
    before = counter.launches
    got = fn(f, g, *maps)
    assert counter.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-5
    assert torch.equal(fn(f, g, *maps), got)  # deterministic
    got16 = fn(f.bfloat16(), g.bfloat16(), *maps)
    assert got16.dtype == torch.float32 and _rel(got16, want) <= 2e-2


def _dw_cases(lv_all, l, cin, cout):
    fine, coarse = lv_all[l], lv_all[l + 1]
    row_ok = fine.valid & fine.parent_ok
    return {
        "k3map": (conv.dw_k3_map, conv.dw_k3_map_plain, conv.DW_K3MAP,
                  _feats(fine, cin), _feats(fine, cout),
                  neighbor_tables(fine)),
        "sk": (conv.dw_sk, conv.dw_sk_plain, conv.DW_SK, _feats(fine, cin),
               _feats(fine, cout), (fine.key, fine.kbits)),
        "down": (conv.dw_down, conv.dw_down_plain, conv.DW_DOWN,
                 _feats(fine, cin), _feats(coarse, cout),
                 (coarse.child_idx, coarse.child_hit)),
        "up": (conv.dw_up, conv.dw_up_plain, conv.DW_UP, _feats(coarse, cin),
               _feats(fine, cout), (fine.parent_idx, row_ok, fine.octant)),
    }


@pytest.mark.parametrize("kind", ["sk", "down", "up", "k3map"])
@pytest.mark.parametrize("cin,cout", [(3, 32), (20, 90), (130, 70)])
@pytest.mark.parametrize("l", [0, 2])
def test_dw_kernels(cuda, levels, kind, l, cin, cout):
    _check_dw(*_dw_cases(levels, l, cin, cout)[kind])


@pytest.mark.parametrize("kind", ["sk", "down", "up", "k3map"])
def test_dw_kernels_at_40000_rows(cuda, big_levels, kind):
    assert big_levels[0].key.shape[1] == 40000
    _check_dw(*_dw_cases(big_levels, 0, 130, 70)[kind])


def test_dw_rejects(cuda, levels):
    lv = levels[0]
    f = _feats(lv, 8)
    with pytest.raises(ValueError):
        conv.dw_sk(f.double(), f.double(), lv.key, lv.kbits)
    with pytest.raises(ValueError):
        conv.dw_sk(f, f.bfloat16(), lv.key, lv.kbits)
    idx, hit = neighbor_tables(lv)
    with pytest.raises(ValueError):
        conv.dw_k3_map(f.double(), f.double(), idx, hit)
    with pytest.raises(ValueError):
        conv.dw_k3_map(f, f.bfloat16(), idx, hit)
    with pytest.raises(ValueError):
        conv.dw_k3_map(f, f, idx.long(), hit)
    with pytest.raises(ValueError):
        conv.dw_k3_map(f, f, idx[:8], hit[:8])


def _list_hierarchy(cuda, case):
    """Two clouds of C4's wide-span kinds: ``border`` (keys at offset
    coords 0 and 1023 alias across the packed fields) and ``overflow`` (a
    blob whose parents overflow the coarse capacities: ``row_ok`` false)."""
    gen = torch.Generator().manual_seed(len(case))
    if case == "border":
        ax = torch.tensor([0, 1, 2, 3, 511, 512, 1020, 1021, 1022, 1023])
        off = torch.cartesian_prod(ax, ax, ax).float()
        cap, caps = 1024, (512, 256)
    else:
        off = torch.round(torch.randn((900, 3), generator=gen) * 6 + 512)
        cap, caps = 512, (128, 64)
    pts = ((off - 512 + 0.5) * 0.01)[None].expand(2, -1, -1).contiguous()
    vox, _ = voxelize(pts.to(cuda), torch.rand(pts.shape, generator=gen)
                      .to(cuda), torch.ones(pts.shape[:2], dtype=torch.bool,
                                            device=cuda), 0.01, cap)
    return build_hierarchy(vox, 2, capacities=caps)


def _list_maps(lv_all, kind, padding=False):
    """``(n_in, maps)`` of one dW kind on levels 0 / 1; ``padding``: the
    maps of a level whose every row is padding (no hit anywhere)."""
    fine, coarse = lv_all[0], lv_all[1]
    if kind == "sk":
        kbits = torch.zeros_like(fine.kbits) if padding else fine.kbits
        return fine.key.shape[1], (fine.key, kbits)
    if kind == "k3map":
        idx, hit = neighbor_tables(fine)
        return fine.key.shape[1], (idx, hit & (not padding))
    if kind == "down":
        return fine.key.shape[1], (coarse.child_idx,
                                   coarse.child_hit & (not padding))
    row_ok = fine.valid & fine.parent_ok & (not padding)
    return coarse.key.shape[1], (fine.parent_idx, row_ok, fine.octant)


@pytest.mark.parametrize("kind", ["sk", "down", "up", "k3map"])
@pytest.mark.parametrize("case", ["levels", "border", "overflow", "padding"])
def test_dw_hit_lists_exact(cuda, levels, case, kind):
    """The list kernel equals its plain twin, integer for integer."""
    lv_all = (levels if case in ("levels", "padding")
              else _list_hierarchy(cuda, case))
    n_in, maps = _list_maps(lv_all, kind, padding=case == "padding")
    if case == "overflow" and kind == "up":
        assert not bool(maps[1][lv_all[0].valid].all())
    before = hit_lists.LISTS.launches
    got = hit_lists.HitLists(kind, n_in, *maps).entries()
    assert hit_lists.LISTS.launches == before + 1
    want = hit_lists.hit_lists_plain(kind, n_in, *maps)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(hit_lists.HitLists(kind, n_in, *maps).entries()[0],
                       got[0])
    if case == "padding":
        assert not bool(got[2].any())
        fine, coarse = lv_all[0], lv_all[1]
        src, dst = {"down": (fine, coarse), "up": (coarse, fine)}.get(
            kind, (fine, fine))
        fn = {"sk": conv.dw_sk, "k3map": conv.dw_k3_map,
              "down": conv.dw_down, "up": conv.dw_up}[kind]
        for dtype in (torch.float32, torch.bfloat16):
            dw = fn(_feats(src, 40, dtype), _feats(dst, 72, dtype), *maps)
            assert dw.shape == (got[0].shape[0], 40, 72) and not dw.any()
    else:
        assert bool(got[2].any())


@pytest.mark.parametrize("self_keyed", [True, False])
def test_train_step_lists_each_map_once(cuda, self_keyed):
    """One segmentation train step (minkunet14A, depth 4, B = 2, every
    level self-keyed or every level on tables) launches the list kernel
    once a map of its hierarchy: the k3 map of each of its 5 levels and
    the child and parent maps of each of its 4 level pairs, 13 in all,
    whoever reads a map first; its K3 down / up and dW calls launch as
    many times as before."""
    from mrcc_tpu_torch.data.dataset import AliveV2Dataset, DataConfig
    from mrcc_tpu_torch.data.synthetic import generate_sample
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step

    data = AliveV2Dataset(
        samples=[generate_sample(seed=31 + i, n_ee=1024, n_arm=1024,
                                 n_bg=2048) for i in range(2)],
        cfg=DataConfig(max_points=4096))
    batch = data.collate([data[0], data[1]])
    model = init_parameters(RobotNetSegmentation(backbone="minkunet14A"), 8)
    step, _ = make_segmentation_train_step(
        model, DataConfig(max_points=4096),
        TrainConfig(k3_self_keyed=self_keyed), 2048, device=cuda)
    counters = (hit_lists.LISTS, conv.DOWN, conv.UP, conv.DW_SK,
                conv.DW_K3MAP, conv.DW_DOWN, conv.DW_UP)
    before = [c.launches for c in counters]
    step(batch, 1e-4)
    torch.cuda.synchronize()
    lists, down, up, dw_sk, dw_k3map, dw_down, dw_up = (
        c.launches - b for c, b in zip(counters, before))
    assert lists == 5 + 4 * 2
    # forward and data cotangent of each down and up conv of 4 pairs
    assert (down, up, dw_down, dw_up) == (8, 8, 4, 4)
    assert (dw_sk == 0) != self_keyed and dw_sk + dw_k3map > 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [0, 2])
def test_readers_on_held_lists(cuda, l, dtype):
    """Every reader of a map's lists over the lists a level holds
    (``sparse.conv``: listed at the first read, once a map) gives the bits
    of the same call listing the map itself: K3 down and up, their int8
    counterparts, the four dW wrappers (the k3 dW kernels on either k3
    kind's lists)."""
    from mrcc_tpu_torch.sparse import conv as C

    pts, rgb, mask = build_batch(2, 4096, seed=5)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 100.0, 3072)
    lvs = build_hierarchy(vox, 4, capacities=(2048, 1024, 512, 256))
    fine, coarse = lvs[l], lvs[l + 1]
    nf, nc = fine.key.shape[1], coarse.key.shape[1]
    tables = neighbor_tables(fine)
    before = hit_lists.LISTS.launches
    held = {"down": C._child_lists(fine, coarse),
            "up": C._parent_lists(fine, coarse),
            "sk": C._held(fine, "sk", nf, fine.key, fine.kbits)}
    assert C._child_lists(fine, coarse) is held["down"]
    assert hit_lists.LISTS.launches == before  # listed at the first read
    child = (coarse.child_idx, coarse.child_hit)
    parent = (fine.parent_idx, fine.row_ok, fine.octant)
    f_fine, f_coarse = _feats(fine, 40, dtype), _feats(coarse, 72, dtype)
    w_down = torch.randn((8, 40, 72), device=cuda) / 40
    w_up = torch.randn((8, 72, 40), device=cuda) / 72
    g_fine, g_coarse = _feats(fine, 24, dtype), _feats(coarse, 24, dtype)
    calls = (
        (conv.gather_gemm_down, (f_fine, w_down.to(dtype), *child), "down"),
        (conv.gather_gemm_up, (f_coarse, w_up.to(dtype), *parent), "up"),
        (conv_q8.gather_gemm_down_q8, (f_fine, w_down, *child, None), "down"),
        (conv_q8.gather_gemm_up_q8, (f_coarse, w_up, *parent, None), "up"),
        (conv.dw_down, (f_fine, g_coarse, *child), "down"),
        (conv.dw_up, (f_coarse, g_fine, *parent), "up"),
        (conv.dw_sk, (f_fine, g_fine, fine.key, fine.kbits), "sk"),
        (conv.dw_k3_map, (f_fine, g_fine, *tables), "sk"))
    for fn, args, kind in calls:
        got = fn(*args, held[kind])
        own = hit_lists.LISTS.launches
        want = fn(*args)
        assert hit_lists.LISTS.launches == own + 1
        assert got.dtype == want.dtype and torch.equal(got, want), fn
    # three maps listed once each over the eight held calls
    assert hit_lists.LISTS.launches == before + 3 + len(calls)
    k3map = hit_lists.HitLists("k3map", nf, *tables)
    assert torch.equal(conv.dw_sk(f_fine, g_fine, fine.key, fine.kbits,
                                  k3map),
                       conv.dw_sk(f_fine, g_fine, fine.key, fine.kbits))
    with pytest.raises(ValueError):
        conv.dw_down(f_fine, g_coarse, *child, held["up"])


@pytest.fixture(scope="module")
def train_level(cuda):
    """A level 0 of 8 x 16384 rows, the training step's shape (8 scenes at
    1 cm, ~15k voxels each)."""
    pts, rgb, mask = build_batch(8, 24576, seed=6)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 0.01, 16384)
    return build_hierarchy(vox, 1, capacities=(4096,))[0]


@pytest.fixture(scope="module")
def scene_level(cuda):
    """A level 0 of 2 x 65536 rows (the scene-scale training level)."""
    pts, rgb, mask = build_batch(2, 131072, seed=7)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 200.0, 65536)
    return build_hierarchy(vox, 1, capacities=(16384,))[0]


@pytest.mark.parametrize("which", ["levels", "big_levels", "train", "scene"])
def test_dw_sk_equals_dw_k3_map(cuda, request, which):
    """The self-keyed search and the level's k3 tables give the same
    lists, so the two dW routes give the same bits."""
    name = {"train": "train_level", "scene": "scene_level"}.get(which, which)
    lv = request.getfixturevalue(name)
    lv = lv if name.endswith("_level") else lv[0]
    cin, cout = (416, 384) if name.endswith("_level") else (130, 70)
    tables = neighbor_tables(lv)
    for dtype in (torch.float32, torch.bfloat16):
        f, g = _feats(lv, cin, dtype), _feats(lv, cout, dtype)
        assert torch.equal(conv.dw_sk(f, g, lv.key, lv.kbits),
                           conv.dw_k3_map(f, g, *tables))


@pytest.mark.parametrize("kind", ["sk", "k3map"])
@pytest.mark.parametrize("which", ["train", "scene"])
def test_dw_kernels_wide(cuda, request, which, kind):
    """The decoder's widest dW (416 x 384) at 8 x 16384 and 2 x 65536
    rows: f32 1e-5 (a product dimension of ~10^5 hits a offset), bf16
    2e-2, repeated calls bit-equal."""
    lv = request.getfixturevalue(f"{which}_level")
    f, g = _feats(lv, 416), _feats(lv, 384)
    if kind == "sk":
        _check_dw(conv.dw_sk, conv.dw_sk_plain, conv.DW_SK, f, g,
                  (lv.key, lv.kbits))
    else:
        _check_dw(conv.dw_k3_map, conv.dw_k3_map_plain, conv.DW_K3MAP, f, g,
                  neighbor_tables(lv))


@pytest.mark.parametrize("kind", ["k3", "k3map", "down", "up"])
def test_conv_function_backward(cuda, levels, kind):
    """The Functions' backward (kernels) vs autograd of the plain twins."""
    import dataclasses

    from mrcc_tpu_torch.sparse import conv as C

    fine, coarse = levels[1], levels[2]
    cin, cout = 48, 40
    if kind == "k3map":
        lv = dataclasses.replace(fine, **dict(zip(
            ("nbr_idx", "nbr_hit"), neighbor_tables(fine))))
        taps, src, dst = 27, lv, lv
        fn = lambda f, w: C.conv_k3(f, w, lv)  # noqa: E731
        plain = lambda f, w: conv.gather_gemm_k3_map_plain(  # noqa: E731
            f, w, lv.nbr_idx, lv.nbr_hit)
    elif kind == "k3":
        taps, src, dst = 27, fine, fine
        fn = lambda f, w: C.conv_k3(f, w, fine)  # noqa: E731
        plain = lambda f, w: conv.gather_gemm_sk_plain(  # noqa: E731
            f, w, fine.key, fine.kbits)
    elif kind == "down":
        taps, src, dst = 8, fine, coarse
        fn = lambda f, w: C.conv_down(f, w, fine, coarse)  # noqa: E731
        plain = lambda f, w: conv.gather_gemm_down_plain(  # noqa: E731
            f, w, coarse.child_idx, coarse.child_hit)
    else:
        taps, src, dst = 8, coarse, fine
        fn = lambda f, w: C.conv_transpose_up(f, w, coarse, fine)  # noqa
        plain = lambda f, w: conv.gather_gemm_up_plain(  # noqa: E731
            f, w, fine.parent_idx, fine.valid & fine.parent_ok, fine.octant)
    f0 = _feats(src, cin)
    w0 = torch.randn((taps, cin, cout), device=cuda) / 5
    ct = _feats(dst, cout)
    grads = []
    for run in (fn, plain):
        f = f0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        (run(f, w) * ct).sum().backward()
        grads.append((f.grad, w.grad))
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("cin,cout", [(3, 32), (96, 256), (416, 384)])
def test_sk_conv_fn_backward_widths(cuda, ragged_level, cin, cout):
    """SkConvFn's backward (K2 with W[26 - k]^T for dfeats, the dW kernel)
    vs autograd through the plain twin: 1e-5 in f32."""
    from mrcc_tpu_torch.sparse import conv as C

    lv = ragged_level
    f0 = _feats(lv, cin)
    w0 = torch.randn((27, cin, cout), device=cuda) / cin**0.5
    ct = _feats(lv, cout)
    grads = []
    for run in (lambda f, w: C.conv_k3(f, w, lv),
                lambda f, w: conv.gather_gemm_sk_plain(f, w, lv.key,
                                                       lv.kbits)):
        f = f0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        (run(f, w) * ct).sum().backward()
        grads.append((f.grad, w.grad))
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------- int8


def _ulps(got, want):
    """Largest |got - want| in ulps of the output type at the larger
    magnitude (bf16: 8 significant bits, f32: 24)."""
    bits = 8 if got.dtype == torch.bfloat16 else 24
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - (bits - 1))
    return float(((g - w).abs() / ulp).max())


_Q8_KINDS = (conv_q8.SK_Q8, conv_q8.K3MAP_Q8, conv_q8.DOWN_Q8, conv_q8.UP_Q8,
             conv_q8.Q8_QUANT, hit_lists.LISTS, conv_q8.Q8_SUM)
_Q8_MODE = {"conv_sk_q8": "k3", "conv_k3map_q8": "k3_table",
            "conv_down_q8": "down", "conv_up_q8": "up"}


def _q8_launches(fn, *args, **kw):
    before = {c.name: c.launches for c in _Q8_KINDS}
    out = fn(*args, **kw)
    return out, {c.name: c.launches - before[c.name] for c in _Q8_KINDS
                 if c.launches != before[c.name]}


def _check_q8(fn, plain, counter, unquantised, f, w, maps):
    """The kernel equals its plain twin bit for bit (exact int32 sums), is
    within 3e-2 of the f32 conv, gives the same bits twice and with a
    calibrated absmax equal to the dynamic one; its launches by kind; the
    quantisation kernels equal their twin bit for bit (dynamic and a
    clipping calibrated absmax)."""
    mode = _Q8_MODE[counter.name]
    want = plain(f, w, *maps)
    got, launched = _q8_launches(fn, f, w, *maps)
    expect = {counter.name: 1, "q8_quantize": 3}
    if mode in ("down", "up"):
        expect["hit_lists"] = 1
    if mode == "down":
        expect["q8_child_sum"] = 1
    assert launched == expect
    assert got.dtype == f.dtype and got.shape == want.shape
    assert torch.equal(got, want), _ulps(got, want)
    assert _rel(got, unquantised(f.float(), w, *maps)) <= 3e-2
    assert torch.equal(fn(f, w, *maps), got)
    amax = f.float().abs().amax(dim=(0, 1))  # calibrated == dynamic
    again, launched = _q8_launches(fn, f, w, *maps, act_absmax=amax)
    assert launched["q8_quantize"] == 2 and torch.equal(again, got)
    n_table = f.shape[1]
    for cal in (None, amax * 0.75):
        ops = conv_q8.quantize_operands(mode, f, w, n_table, cal,
                                        per_octant=mode == "up")
        twin = conv_q8.quantize_operands_plain(
            mode, f.cpu(), w.cpu(), n_table,
            None if cal is None else cal.cpu(), per_octant=mode == "up")
        assert ops.groups == twin.groups and ops.gw == twin.gw
        for a, b in zip(ops[:3], twin[:3]):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (256, 40),
                                      (416, 96), (20, 90), (130, 70)])
def test_conv_sk_q8(cuda, levels, cin, cout, dtype):
    """Cin 3 is the stem (packed K); 256 and 416 split into 128-channel
    groups; 20 and 130 are not whole 16-channel chunks."""
    lv = levels[0]
    assert len(conv_q8.q8_channel_groups("k3", lv.key.shape[1], cin)) == \
        -(-cin // 128)
    _check_q8(conv_q8.gather_gemm_sk_q8, conv_q8.gather_gemm_sk_q8_plain,
              conv_q8.SK_Q8, conv.gather_gemm_sk_plain, _feats(lv, cin, dtype),
              torch.randn((27, cin, cout), device=cuda) / 9,
              (lv.key, lv.kbits))


@pytest.mark.parametrize("cin,cout", [(32, 32), (20, 90), (896, 40),
                                      (130, 70), (416, 256)])
@pytest.mark.parametrize("l", [0, 2])
def test_conv_down_up_q8(cuda, levels, l, cin, cout):
    """896 channels split 768 + 128 (the int8 k-lane cap); Cout 256 spans
    two column tiles."""
    fine, coarse = levels[l], levels[l + 1]
    w = torch.randn((8, cin, cout), device=cuda) / 3
    _check_q8(conv_q8.gather_gemm_down_q8, conv_q8.gather_gemm_down_q8_plain,
              conv_q8.DOWN_Q8, conv.gather_gemm_down_plain,
              _feats(fine, cin, torch.bfloat16), w,
              (coarse.child_idx, coarse.child_hit))
    # octants with weights of different scale keep their own scales
    w = w * torch.arange(1, 9, device=cuda)[:, None, None]
    _check_q8(conv_q8.gather_gemm_up_q8, conv_q8.gather_gemm_up_q8_plain,
              conv_q8.UP_Q8, conv.gather_gemm_up_plain,
              _feats(coarse, cin, torch.bfloat16), w,
              (fine.parent_idx, fine.row_ok, fine.octant))


def test_conv_down_q8_table_split(cuda, big_levels):
    """A 40000-row table over the 5 MiB budget at 384 channels: three
    128-channel groups."""
    fine, coarse = big_levels[0], big_levels[1]
    assert conv_q8.q8_channel_groups("down", fine.key.shape[1], 384) == (
        (0, 128), (128, 256), (256, 384))
    _check_q8(conv_q8.gather_gemm_down_q8, conv_q8.gather_gemm_down_q8_plain,
              conv_q8.DOWN_Q8, conv.gather_gemm_down_plain,
              _feats(fine, 384, torch.bfloat16),
              torch.randn((8, 384, 64), device=cuda) / 9,
              (coarse.child_idx, coarse.child_hit))


@pytest.mark.parametrize("pack", [2, 4])
def test_conv_up_q8_lane_packed_groups(cuda, levels, monkeypatch, pack):
    """An up conv from a table over the (shrunk) budget: 64-channel (pack
    2) or 32-channel (pack 4) groups, as the JAX wrapper's lane-packed
    plan."""
    fine, coarse = levels[1], levels[2]
    n = coarse.key.shape[1]
    monkeypatch.setattr(conv_q8, "_TABLE_BUDGET", n * 128 // pack)
    width = 128 // pack
    assert conv_q8.q8_channel_groups("up", n, 160) == tuple(
        (a, min(a + width, 160)) for a in range(0, 160, width))
    _check_q8(conv_q8.gather_gemm_up_q8, conv_q8.gather_gemm_up_q8_plain,
              conv_q8.UP_Q8, conv.gather_gemm_up_plain,
              _feats(coarse, 160, torch.bfloat16),
              torch.randn((8, 160, 40), device=cuda) / 9,
              (fine.parent_idx, fine.row_ok, fine.octant))


def test_conv_q8_padding_level(cuda, levels):
    """A level of padding rows (no neighbour, no child, no parent) gives
    zeros from every int8 conv."""
    lv, coarse = levels[3], levels[4]
    f = _feats(lv, 130, torch.bfloat16)
    out = conv_q8.gather_gemm_sk_q8(f, torch.randn((27, 130, 70),
                                                   device=cuda),
                                    lv.key, torch.zeros_like(lv.kbits))
    assert not out.any()
    out = conv_q8.gather_gemm_down_q8(f, torch.randn((8, 130, 70),
                                                     device=cuda),
                                      coarse.child_idx, coarse.child_hit & False)
    assert not out.any()
    out = conv_q8.gather_gemm_up_q8(_feats(coarse, 130, torch.bfloat16),
                                    torch.randn((8, 130, 70), device=cuda),
                                    lv.parent_idx, lv.row_ok & False,
                                    lv.octant)
    assert not out.any()


def test_conv_q8_rejects(cuda, levels):
    lv = levels[0]
    w = torch.zeros((27, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        conv_q8.gather_gemm_sk_q8(_feats(lv, 8, torch.float16), w, lv.key,
                                  lv.kbits)
    with pytest.raises(ValueError):
        conv_q8.gather_gemm_sk_q8(_feats(lv, 8, torch.bfloat16),
                                  w.bfloat16(), lv.key, lv.kbits)
    with pytest.raises(ValueError):
        conv_q8.gather_gemm_down_q8(_feats(lv, 8, torch.float64),
                                    w[:8].double(), levels[1].child_idx,
                                    levels[1].child_hit)


# ------------------------------------------------------- k3 tables, ICP


@pytest.mark.parametrize("n,nq,query", [
    pytest.param(n, nq, "sorted", id=f"{n}-{nq}")
    for n, nq in ((1, 5), (300, 300), (4096, 1000), (72448, 72448))] + [
    (4096, 4096, "unsorted"), (40000, 2000, "sparse"),
    (72448, 72448, "one-item")])
def test_rank_exact(cuda, n, nq, query):
    """Unique keys, repeated KEY_PAD padding and KEY_PAD query bases.
    Sorted query bases take the shared windows (and the global branch
    where padding windows hold over ``rank.RANK_WINDOW`` keys); unsorted
    ones and sorted ones that jump across the keys take the global branch;
    one item (B = 1)."""
    gen = torch.Generator().manual_seed(n)
    keys = torch.randperm(1 << 22, generator=gen)[:n].sort().values
    keys = keys.to(torch.int32)
    keys[int(0.8 * n):] = KEY_PAD
    pick = torch.randint(0, n, (nq,), generator=gen)
    if query == "sparse":
        pick = torch.arange(nq) * (n // nq)
    qbase = keys[pick] if query == "unsorted" else keys[pick].sort().values
    qbase = qbase + torch.randint(-1, 2, (nq,), generator=gen,
                                  dtype=torch.int32)
    if query != "unsorted":
        qbase[int(0.9 * nq):] = KEY_PAD
    qbits = torch.randint(-(1 << 31), 1 << 31, (2, nq), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    args = (torch.stack([keys, keys.flip(0).sort().values]).to(cuda),
            torch.stack([qbase, qbase]).to(cuda), qbits.to(cuda))
    if query == "one-item":
        args = tuple(a[:1] for a in args)
    for deltas in (K3_DELTAS, (0, 1, 2, 3, 7, -5)):
        want = rank.rank_lookup_plain(args[0], args[1], deltas, args[2])
        before = rank.RANK.launches
        got = rank.rank_lookup(args[0], args[1], deltas, args[2])
        assert rank.RANK.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        wide = rank.rank_windows(args[0], args[1], deltas)[2]
        if query in ("unsorted", "sparse"):
            assert bool(wide.any())


@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (130, 70)])
@pytest.mark.parametrize("l", [0, 3])
def test_conv_k3_map(cuda, levels, l, cin, cout):
    lv = levels[l]
    idx, hit = neighbor_tables(lv)
    f = _feats(lv, cin)
    w = torch.randn((27, cin, cout), device=cuda) / 9
    want = conv.gather_gemm_sk_plain(f, w, lv.key, lv.kbits)
    assert _rel(conv.gather_gemm_k3_map_plain(f, w, idx, hit), want) <= 1e-6
    before = conv.K3MAP.launches
    got = conv.gather_gemm_k3_map(f, w, idx, hit)
    assert conv.K3MAP.launches == before + 1
    assert _rel(got, want) <= 1e-5
    got16 = conv.gather_gemm_k3_map(f.bfloat16(), w.bfloat16(), idx, hit)
    assert got16.dtype == torch.bfloat16 and _rel(got16, want) <= 2e-2


# ------------------------------------------------------- the k3 order


def _orders(lv):
    """The level's three-segment order, a nine-segment one and the
    one-segment identity order (the one-pass tile's own schedule), each
    built on the card."""
    maps = (lv.key, lv.kbits, lv.nbr_idx, lv.nbr_hit)
    return (k3_order.level_order(lv),
            k3_order.build_k3_order(*maps, segments=9),
            k3_order.build_k3_order(*maps, segments=1, sort=False))


@pytest.mark.parametrize("l", [0, 2])
def test_k3_order_equals_twin(cuda, levels, l):
    """The order's kernels (rows, K1, lists) equal the plain twin integer
    for integer on both row sources, for three segments, one sorted
    segment and the identity order: two launches on ``k3_order`` a build
    and one K1 sort where it sorts."""
    lv = levels[l]
    tables = neighbor_tables(lv)
    cpu = [t.cpu() for t in (lv.key, lv.kbits, *tables)]
    for segments, srt in ((3, True), (9, True), (1, True), (1, False)):
        want = k3_order.build_k3_order_plain(*cpu[:2], segments=segments,
                                             sort=srt)
        for maps in ((), tables):
            before = (k3_order.K3_ORDER.launches, sort.SORT.launches)
            got = k3_order.build_k3_order(lv.key, lv.kbits, *maps,
                                          segments=segments, sort=srt)
            assert (k3_order.K3_ORDER.launches, sort.SORT.launches) == (
                before[0] + 2, before[1] + int(srt))
            assert torch.equal(got.mask.cpu(), want.mask)
            assert torch.equal(got.lists.cpu(), want.lists)
            assert torch.equal(got.counts.cpu(), want.counts)


def test_k3_order_one_build_a_level(cuda):
    """``build_hierarchy`` builds each level's order once (two launches on
    ``k3_order``); the k3 convs over it launch none."""
    from mrcc_tpu_torch.sparse import conv as C

    pts, rgb, mask = build_batch(2, 4096, seed=3)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 100.0, 3072)
    before = k3_order.K3_ORDER.launches
    lvs = build_hierarchy(vox, 4, capacities=(2048, 1024, 512, 256))
    assert k3_order.K3_ORDER.launches == before + 2 * len(lvs)
    assert all(lv.k3_order is not None for lv in lvs)
    f = _feats(lvs[0], 48).requires_grad_()
    w = torch.randn((27, 48, 40), device=cuda, requires_grad=True)
    before = k3_order.K3_ORDER.launches
    C.conv_k3(f, w, lvs[0]).sum().backward()
    assert k3_order.K3_ORDER.launches == before


def test_k3_order_where_the_k3_convs_read_it(cuda):
    """One rule for both level builders (``with_k3_order``): a level gets
    its order unless its k3 convs take the int8 route, every self-keyed
    level of an int8 stage and its table levels that ``q8_route``
    accepts; ``downsample_level``'s coarse levels (the sparse ResNets')
    get theirs too."""
    from mrcc_tpu_torch.sparse import downsample_level
    from mrcc_tpu_torch.sparse.hierarchy import k3_takes_q8

    pts, rgb, mask = build_batch(2, 4096, seed=3)
    vox, _ = voxelize(torch.as_tensor(pts, device=cuda),
                      torch.as_tensor(rgb, device=cuda),
                      torch.as_tensor(mask, device=cuda), 1 / 100.0, 3072)
    caps, tables = (2048, 1000, 512, 256), (True, True, True, False, False)
    bf16 = build_hierarchy(vox, 4, capacities=caps, k3_tables=tables)
    q8 = build_hierarchy(vox, 4, capacities=caps, k3_tables=tables,
                         q8_dtype=torch.bfloat16)
    assert all(lv.k3_order is not None for lv in bf16)
    int8 = [k3_takes_q8(lv, 2) for lv in q8]
    assert int8 == [True, True, False, True, True]
    assert [lv.k3_order is None for lv in q8] == int8
    assert torch.equal(q8[2].k3_order.lists, bf16[2].k3_order.lists)
    for cap, q8_dtype in ((1000, None), (1024, None), (1000, torch.bfloat16),
                          (1024, torch.bfloat16)):
        _, coarse = downsample_level(bf16[0], cap, stride=2, kernel_size=2,
                                     q8_dtype=q8_dtype)
        assert coarse.nbr_idx is not None
        assert (coarse.k3_order is None) == (q8_dtype is not None
                                             and cap == 1024)


def _check_ordered(fn, plain, maps, lv, cin, cout, counter):
    """One k3 conv over the level's three-segment order, over a
    nine-segment one, over the identity order and with no order (the
    one-pass tile), forward and data cotangent (W[26 - k]^T): all four
    bit-equal (``torch.equal``) in f32 and bf16, one launch a call, f32
    within 1e-5 and bf16 within 2e-2 of the plain twin; padding rows come
    out 0."""
    orders = _orders(lv) + (None,)
    w0 = torch.randn((27, cin, cout), device=lv.key.device) / cin**0.5
    for w, c in ((w0, cin), (w0.flip(0).transpose(1, 2), cout)):
        f = _feats(lv, c)
        want = plain(f, w, *maps)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            fd, wd = f.to(dtype), w.to(dtype)
            before = counter.launches
            outs = [fn(fd, wd, *maps, order) for order in orders]
            assert counter.launches == before + len(orders)
            assert all(o.dtype == dtype for o in outs)
            assert all(torch.equal(outs[0], o) for o in outs[1:])
            assert _rel(outs[0], want) <= tol
            assert not outs[0][~lv.valid].any()


@pytest.mark.parametrize("cin,cout", [(48, 64), (130, 70), (96, 256),
                                      (384, 384)])
@pytest.mark.parametrize("l", [0, 2])
@pytest.mark.parametrize("route", ["sk", "k3map"])
def test_ordered_k3_convs_bit_equal(cuda, levels, route, l, cin, cout):
    lv = levels[l]
    if route == "sk":
        _check_ordered(conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
                       (lv.key, lv.kbits), lv, cin, cout, conv.SK)
    else:
        _check_ordered(conv.gather_gemm_k3_map, conv.gather_gemm_k3_map_plain,
                       neighbor_tables(lv), lv, cin, cout, conv.K3MAP)


@pytest.mark.parametrize("which", ["train", "scene"])
def test_ordered_k3_convs_at_the_cells_level_0(cuda, request, which):
    """The cells' widest k3 conv (416 -> 384) at their level 0: 8 x 16384
    rows self-keyed, 2 x 65536 on tables; the order cuts the stages at
    least 2x (``k3_tile_stages``)."""
    lv = request.getfixturevalue(f"{which}_level")
    if which == "train":
        _check_ordered(conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
                       (lv.key, lv.kbits), lv, 416, 384, conv.SK)
    else:
        _check_ordered(conv.gather_gemm_k3_map, conv.gather_gemm_k3_map_plain,
                       neighbor_tables(lv), lv, 416, 384, conv.K3MAP)
    st = conv.k3_tile_stages(lv)
    assert st["stages_row_order"] >= 2 * st["stages_ordered"] >= 2


def test_ordered_k3_conv_rows_with_no_hit(cuda, ragged_level):
    """Rows whose bitmap is 0 hit nothing: over an order built from such a
    bitmap every row lies in segment 0 with no offset and comes out 0."""
    import dataclasses

    lv = dataclasses.replace(ragged_level,
                             kbits=torch.zeros_like(ragged_level.kbits))
    order = k3_order.level_order(lv)
    f = _feats(ragged_level, 96)
    w = torch.randn((27, 96, 256), device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = conv.gather_gemm_sk(f.to(dtype), w.to(dtype), lv.key, lv.kbits,
                                  order)
        assert got.dtype == dtype and not got.any()
        got = conv.gather_gemm_k3_map(f.to(dtype), w.to(dtype),
                                      *neighbor_tables(lv), order)
        assert not got.any()


@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (384, 40),
                                      (130, 70), (416, 90)])
def test_conv_k3_map_q8(cuda, levels, cin, cout):
    """384 and 416 channels split 256 + the rest (the int8 k-lane cap of 27
    offsets).  At equal groups the table route gives B6's bits."""
    lv = levels[0]
    idx, hit = neighbor_tables(lv)
    groups = conv_q8.q8_channel_groups("k3_table", lv.key.shape[1], cin)
    assert len(groups) == (2 if cin >= 384 else 1)
    f = _feats(lv, cin, torch.bfloat16)
    w = torch.randn((27, cin, cout), device=cuda) / 9
    table = conv_q8.gather_gemm_k3_map_q8(f, w, idx, hit)
    sk = conv_q8._tile_launch(conv_q8.SK_Q8_LIB, "mrcc_conv_sk_q8", f, w,
                              (lv.key, lv.kbits), "k3", None, groups=groups)
    assert torch.equal(table, sk)
    _check_q8(conv_q8.gather_gemm_k3_map_q8,
              conv_q8.gather_gemm_k3_map_q8_plain, conv_q8.K3MAP_Q8,
              conv.gather_gemm_k3_map_plain, f, w, (idx, hit))


@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (384, 40)])
def test_conv_map_q8_f32_features(cuda, levels, cin, cout):
    """An int8 engine at ``compute_dtype="float32"``: B7's k3-table, down
    and up modes on f32 features (the f32 instantiations of the
    quantisation, the tile, the list GEMM, the child sum and the zero
    pass) equal their twins bit for bit."""
    lv = levels[0]
    idx, hit = neighbor_tables(lv)
    _check_q8(conv_q8.gather_gemm_k3_map_q8,
              conv_q8.gather_gemm_k3_map_q8_plain, conv_q8.K3MAP_Q8,
              conv.gather_gemm_k3_map_plain, _feats(lv, cin, torch.float32),
              torch.randn((27, cin, cout), device=cuda) / 9, (idx, hit))
    fine, coarse = levels[1], levels[2]
    w = torch.randn((8, cin, cout), device=cuda) / 3
    _check_q8(conv_q8.gather_gemm_down_q8, conv_q8.gather_gemm_down_q8_plain,
              conv_q8.DOWN_Q8, conv.gather_gemm_down_plain,
              _feats(fine, cin, torch.float32), w,
              (coarse.child_idx, coarse.child_hit))
    _check_q8(conv_q8.gather_gemm_up_q8, conv_q8.gather_gemm_up_q8_plain,
              conv_q8.UP_Q8, conv.gather_gemm_up_plain,
              _feats(coarse, cin, torch.float32), w,
              (fine.parent_idx, fine.row_ok, fine.octant))


def test_segmentation_evaluator_card_vs_cpu(cuda, tmp_path):
    """``evaluate_segmentation`` at a reduced size (minkunet14A, capacity
    1024, three samples, f32 on tables) on the card against the CPU, same
    weights: K1, the rank kernel, the k3-table conv and K3 down / up
    launched; per-instance metrics within 1e-3."""
    from mrcc_tpu_torch.data.dataset import AliveV2Dataset, DataConfig
    from mrcc_tpu_torch.data.synthetic import write_sample_set
    from mrcc_tpu_torch.eval import evaluate_segmentation
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters

    splits = write_sample_set(tmp_path, n=3, n_ee=400, n_arm=500, n_bg=700)
    ds = AliveV2Dataset(files=splits["train"] + splits["val"]
                        + splits["test"], cfg=DataConfig(
                            data_type=None, max_points=2048, scale=200.0))
    model = init_parameters(RobotNetSegmentation(
        backbone="minkunet14A", in_channels=3, num_classes=3), 0)
    counters = (sort.SORT, rank.RANK, conv.K3MAP, conv.DOWN, conv.UP)
    before = [c.launches for c in counters]
    got = evaluate_segmentation(model, ds, voxel_capacity=1024,
                                device="cuda")
    assert all(c.launches > b for c, b in zip(counters, before))
    want = evaluate_segmentation(model, ds, voxel_capacity=1024,
                                 device="cpu")
    assert len(got["instances"]) == len(want["instances"]) == 3
    for g, w in zip(got["instances"], want["instances"]):
        for k in ("accuracy", "precision", "recall"):
            assert abs(g[k] - w[k]) <= 1e-3, (k, g[k], w[k])


@pytest.mark.parametrize("b,m,n", [(2, 256, 512), (3, 100, 1500),
                                   (2, 1024, 8192), (8, 1024, 2048),
                                   (1, 700, 1111), (2, 5, 1), (1, 513, 33)])
def test_nn_search(cuda, b, m, n):
    """Bit-equal to the twin, and to itself on a second call.  Item 0
    holds copies of a target on both sides of the first split edge with
    template points on them (the lower index wins); item 1 (where B > 1)
    has no valid target (idx 0, d2 = |a|^2 + 1e30 rounded)."""
    gen = torch.Generator().manual_seed(m + n)
    tmpl = torch.randn((b, m, 3), generator=gen) * 0.1 + 1
    tgt = torch.randn((b, n, 3), generator=gen) * 0.1 + 1
    mask = torch.rand((b, n), generator=gen) > 0.3
    mask[:, 0] = True
    length = nn.nn_splits(b, m, n)[1]
    if length < n:
        mask[0, length - 1:length + 1] = True
        tgt[0, length] = tgt[0, length - 1]
        tmpl[0, :3] = tgt[0, length - 1]
    if b > 1:
        mask[1] = False
    tmpl, tgt, mask = tmpl.to(cuda), tgt.to(cuda), mask.to(cuda)
    before = nn.NN.launches
    idx, d2 = nn.nn_search(tmpl, tgt, mask)
    assert nn.NN.launches == before + 1
    w_idx, w_d2 = nn.nn_search_plain(tmpl, tgt, mask)
    assert torch.equal(idx, w_idx) and torch.equal(d2, w_d2)
    some = mask.any(1)
    assert bool(mask.gather(1, idx.long())[some].all())
    if length < n:
        assert bool((idx[0, :3] == length - 1).all())
    if b > 1:
        assert not bool(idx[1].any()) and bool((d2[1] >= 1e30).all())
    again = nn.nn_search(tmpl, tgt, mask)
    assert torch.equal(again[0], idx) and torch.equal(again[1], d2)


def test_predict_and_calibrate_run_the_kernels(cuda, monkeypatch):
    """One synthetic frame (over the point capacity) through ``predict``
    and ``calibrate`` on the card, bf16: the sort (K1), the self-keyed conv
    (K2) and the down / up convs (K3) launch, and no plain twin runs."""
    from mrcc_tpu_torch.app import (InferenceConfig, InferenceEngine,
                                    SyntheticDataEngine)

    calls = []
    for mod in (sort, conv, conv_q8, rank, nn):
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(
                    mod, name, lambda *a, _n=name, _f=getattr(mod, name),
                    **k: calls.append(_n) or _f(*a, **k))
    cfg = InferenceConfig(
        point_capacity=4096, seg_voxel_capacity=3072,
        seg_hierarchy_caps=(2048, 1024, 512, 256), ee_point_capacity=1024,
        ee_voxel_capacity=1024, ee_hierarchy_caps=(512, 256, 128, 128),
        kp_voxel_capacity=1024, kp_hierarchy_caps=(768, 640, 384, 128),
        seg_backbone="minkunet14A", rot_backbone="minkunet14A",
        kp_backbone="minkunet14A", icp_iterations=5,
        icp_template_points=256, ee_point_counts_threshold=16,
        sanity_min_num_of_ee_points=16, rot_6d=True,
        compute_confidence=True, rot_flip_disambiguation=True,
        translation_z_percentile=2.0)
    engine = InferenceEngine(cfg, device=cuda)
    frame = SyntheticDataEngine(seed=7, n_ee=1024, n_arm=1500,
                                n_bg=3000).get()
    assert len(frame.points) > cfg.point_capacity
    counters = (sort.SORT, conv.SK, conv.DOWN, conv.UP)
    for ctr in counters:
        ctr.launches = 0
    result = engine.predict(frame)
    launches = {ctr.name: ctr.launches for ctr in counters}
    calib = engine.calibrate({"p1": [result, result]})
    assert min(launches.values()) > 0, launches
    assert not calls, calls
    assert result.segmentation.shape == (len(frame.points),)
    assert (calib.pose_camera_link is None) == (not result.is_confident)


def _step_on(model, device, head, batch):
    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.train import (TrainConfig,
                                      make_metric_learning_train_step,
                                      make_segmentation_train_step)

    if head == "vote":
        return make_segmentation_train_step(
            model, DataConfig(voting_enabled=True), TrainConfig(), 1024,
            device=device)[0](batch, 1e-4)
    cfg = DataConfig(data_type=None, max_points=1024, scale=200)
    return make_metric_learning_train_step(model, cfg, TrainConfig(), 1024,
                                           device=device)[0](batch, 1e-4)


def _pair_errors(cpu, gpu, before, zero_grad):
    """(gradient, update) errors in relative norm of the card model against
    the CPU one after a step from ``before``: the update where |g| is above
    1 % of its tensor's rms; the tensors of ``zero_grad`` (exact gradient
    0: FeatureNet's ``final.bias`` before a train-mode BN) held under 1e-4
    of the gradients' rms instead (``inf`` where not); and the largest
    BN-statistic error."""
    gq = dict(gpu.named_parameters())
    g_all = torch.cat([p.grad.flatten() for p in cpu.parameters()])
    rms = float(g_all.pow(2).mean().sqrt())
    gd, ud, un = 0.0, 0.0, 0.0
    for name, p in cpu.named_parameters():
        g, h = p.grad, gq[name].grad.cpu()
        gd += float((h - g).norm() ** 2)
        if name in zero_grad:
            if max(float(g.abs().max()), float(h.abs().max())) > 1e-4 * rms:
                return float("inf"), float("inf"), float("inf")
            continue
        keep = (g == 0) | (g.abs() > 1e-2 * g.pow(2).mean().sqrt())
        u = (p.detach() - before[name])[keep]
        v = (gq[name].detach().cpu() - before[name])[keep]
        ud += float((v - u).norm() ** 2)
        un += float(u.norm() ** 2)
    bufs = dict(gpu.named_buffers())
    bn = max(_rel(bufs[n].cpu(), b) for n, b in cpu.named_buffers())
    return ((gd / float(g_all.norm() ** 2)) ** 0.5, (ud / un) ** 0.5, bn)


@pytest.mark.parametrize("head", ["vote", "feature"])
def test_vote_and_feature_steps_card_vs_cpu(cuda, monkeypatch, head):
    """One train step of RobotNetVote (minkunet14A, 2 classes, B = 2 EE
    crops with cross-section labels, capacity 1024, self-keyed) and of
    FeatureNet (minkunet14A, the mined triplet loss, B = 4 clouds of two
    classes, capacity 1024, every level on tables) on the card against the
    exact step from the same weights: loss 1e-5, gradients 1e-4 and Adam's
    first update 1e-3 in relative norm (the update where |g| is above 1 %
    of its tensor's rms), BN statistics 1e-5.  The exact step is the CPU's
    in float64 (weights and features cast exactly: a second f32 step adds
    its own rounding, and the triplet loss moves by up to 1.5e-5 between
    f32 steps) at the batch or, where a ReLU gate sits within f32 rounding
    of 0, at the batch's features moved by +-1e-7 relative (seeded draws,
    tried in turn; ROADMAP C21).  The card step launches its route's
    kernels and no plain twin, the norm's included."""
    import copy

    import numpy as np

    from mrcc_tpu_torch.data.dataset import AliveV2Dataset, DataConfig
    from mrcc_tpu_torch.data.synthetic import generate_sample
    from mrcc_tpu_torch.data.ycb import YCBDataset
    from mrcc_tpu_torch.models import FeatureNet, RobotNetVote
    from mrcc_tpu_torch.sparse.nn import init_parameters

    if head == "vote":
        data = AliveV2Dataset(
            samples=[generate_sample(seed=23 + i, n_ee=2048, n_arm=1024,
                                     n_bg=2048) for i in range(2)],
            cfg=DataConfig(max_points=2048, voting_enabled=True))
        batch = data.collate([data[0], data[1]])
        model = RobotNetVote(backbone="minkunet14A")
        route, off = (conv.SK, conv.DW_SK), (rank.RANK, conv.K3MAP)
    else:
        data = YCBDataset(num_classes=2, samples_per_class=2,
                          max_points=1024, seed=4)
        batch = data.collate([data[i] for i in range(4)])
        model = FeatureNet(backbone="minkunet14A")
        route, off = (rank.RANK, conv.K3MAP, conv.DW_K3MAP), (conv.SK,)
    start = init_parameters(model, 6)
    before = {n: p.detach().clone() for n, p in start.named_parameters()}

    calls = []
    for mod in (sort, conv, conv_q8, rank, nn, norm):
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(
                    mod, name, lambda *a, _n=name, _f=getattr(mod, name),
                    **k: calls.append(_n) or _f(*a, **k))
    for ctr in route + off:
        ctr.launches = 0
    gpu = copy.deepcopy(start)
    got = float(_step_on(gpu, cuda, head, batch)["loss"])
    assert not calls, calls
    assert all(c.launches > 0 for c in route), [c.launches for c in route]
    assert not any(c.launches for c in off), [c.launches for c in off]
    monkeypatch.undo()

    tried = []
    feats = batch["feats"].astype(np.float64)
    for draw, sign in [(None, 0)] + [(d, s) for d in range(3)
                                     for s in (1, -1)]:
        moved = dict(batch, feats=feats if draw is None else feats * (
            1 + sign * 1e-7 * np.random.default_rng(draw).standard_normal(
                feats.shape)))
        cpu = copy.deepcopy(start).double()
        want = float(_step_on(cpu, "cpu", head, moved)["loss"])
        errs = (abs(got - want) / want,) + _pair_errors(
            cpu, gpu, before, () if head == "vote" else ("final.bias",))
        tried.append(errs)
        if want > 0 and all(e <= t for e, t in
                            zip(errs, (1e-5, 1e-4, 1e-3, 1e-5))):
            return
    raise AssertionError(f"no CPU reference holds the card step: {tried}")


# ----------------------------------------- the strided pyramid (ResNet)

RESNET_CAPS = (6272, 3136, 1568, 784, 392, 196, 98)


@pytest.fixture(scope="module")
def resnet_levels(cuda):
    """The full-width ResNet's pyramid: level 0 of B = 8 x 12544 rows (the
    bench profile's voxels), the k3 s2 stem level, the k2 s2 levels down to
    196 rows and conv5's k3 s3 level of 98 rows, built on the card."""
    from mrcc_tpu_torch.geometry import center_at_origin
    from mrcc_tpu_torch.sparse import downsample_level

    pts, rgb, mask = build_batch(8, 16384, seed=0)
    m = torch.as_tensor(mask, device=cuda)
    c, _ = center_at_origin(torch.as_tensor(pts, device=cuda), mask=m)
    vox, _ = voxelize(c, torch.as_tensor(rgb, device=cuda), m, 1 / 200.0,
                      12544)
    (level,) = build_hierarchy(vox, 0)
    out = [level]
    for cap, (stride, k) in zip(RESNET_CAPS, [(2, 3)] + [(2, 2)] * 5
                                + [(3, 3)]):
        _, level = downsample_level(level, cap, stride=stride, kernel_size=k)
        out.append((level, stride, k))
    return out


def _level_of(resnet_levels, i):
    entry = resnet_levels[i]
    return entry if i == 0 else entry[0]


@pytest.mark.parametrize("i", [1, 2, 6, 7])
def test_child_tables(cuda, resnet_levels, i):
    """The child-table mode on the card: equal to the rank kernel's plain
    twin (idx included) and to the searchsorted twin on hits, at the stem
    (k3 s2), the first pool (k2 s2), the last stage (k2 s2) and conv5
    (k3 s3)."""
    from mrcc_tpu_torch.sparse.hierarchy import (child_table_plain,
                                                 kernel_offsets)

    fine = _level_of(resnet_levels, i - 1)
    coarse, stride, k = resnet_levels[i]
    offsets = kernel_offsets(k)
    args = (coarse.off, coarse.key, coarse.valid, fine.key, offsets)
    before = rank.RANK.launches
    idx, hit = rank.child_tables(*args, stride=stride)
    assert rank.RANK.launches == before + 1
    assert torch.equal(idx, coarse.child_idx)
    assert torch.equal(hit, coarse.child_hit)
    qbase = rank.child_query_base(coarse.key, coarse.valid, stride)
    deltas = [int(d) for d in offsets @ np.array([1 << 20, 1 << 10, 1])]
    qbits = rank.border_bits(coarse.off, coarse.valid, offsets, stride)
    want = rank.rank_lookup_plain(fine.key, qbase, deltas, qbits)
    assert torch.equal(idx, want[0]) and torch.equal(hit, want[1])
    p_idx, p_hit = child_table_plain(coarse.off, coarse.valid, fine.key,
                                     offsets, stride=stride)
    assert torch.equal(hit, p_hit)
    assert torch.equal(torch.where(hit, idx, -1), torch.where(hit, p_idx, -1))
    assert int(hit.sum()) >= int(coarse.valid.sum())


@pytest.mark.parametrize("case", ["stem", "conv5", "k2-ragged", "k3-wide"])
def test_conv_map(cuda, resnet_levels, case):
    """The strided map conv against its plain twin: the stem (3 -> 64 at
    8 x 12544 -> 6272), conv5 (2048 -> 2048 at 8 x 196 -> 98), an 8-offset
    map with ragged widths (130 -> 70) and a 27-offset one past a column
    tile (96 -> 200); f32 1e-5, bf16 2e-2, two launches bit-equal."""
    i, cin, cout = {"stem": (1, 3, 64), "conv5": (7, 2048, 2048),
                    "k2-ragged": (2, 130, 70), "k3-wide": (1, 96, 200)}[case]
    fine = _level_of(resnet_levels, i - 1)
    coarse = resnet_levels[i][0]
    maps = (coarse.child_idx, coarse.child_hit)
    taps = maps[0].shape[0]
    f = _feats(fine, cin)
    w = torch.randn((taps, cin, cout), device=cuda) / np.sqrt(taps * cin)
    want = conv.gather_gemm_map_plain(f, w, *maps)
    before = conv.MAP.launches
    got = conv.gather_gemm_map(f, w, *maps)
    assert conv.MAP.launches == before + 1
    assert got.shape == (8, coarse.key.shape[1], cout)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(conv.gather_gemm_map(f, w, *maps), got)
    got16 = conv.gather_gemm_map(f.bfloat16(), w.bfloat16(), *maps)
    assert got16.dtype == torch.bfloat16 and _rel(got16, want) <= 2e-2
    assert not got[~coarse.valid].any()


def test_conv_map_rejects(cuda, resnet_levels):
    coarse = resnet_levels[1][0]
    f = _feats(resnet_levels[0], 3)
    w = torch.randn((27, 3, 8), device=cuda)
    idx, hit = coarse.child_idx, coarse.child_hit
    with pytest.raises(ValueError):
        conv.gather_gemm_map(f, w[:8], idx, hit)          # K mismatch
    with pytest.raises(ValueError):
        conv.gather_gemm_map(f, w.bfloat16(), idx, hit)   # dtype mismatch
    with pytest.raises(ValueError):
        conv.gather_gemm_map(f, torch.randn((28, 3, 8), device=cuda),
                             torch.cat([idx, idx[:1]]),
                             torch.cat([hit, hit[:1]]))   # K > 27
    with pytest.raises(ValueError):
        conv.gather_gemm_map(f, w, idx.long(), hit)       # index dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet50_card_vs_cpu(cuda, dtype):
    """A narrow SparseResNet50 on the card against the same weights on the
    CPU: logits f32 1e-4, bf16 2e-2; every child map equal on hits."""
    import copy

    from mrcc_tpu_torch.models import SparseResNet50
    from mrcc_tpu_torch.sparse import downsample_level
    from mrcc_tpu_torch.sparse.nn import init_parameters

    pts, rgb, mask = build_batch(2, 4096, seed=5)
    args = [torch.as_tensor(a) for a in (pts, rgb, mask)]
    cpu_vox, _ = voxelize(*args, 1 / 100.0, 2048)
    gpu_vox, _ = voxelize(*(a.to(cuda) for a in args), 1 / 100.0, 2048)
    (l0c,) = build_hierarchy(cpu_vox, 0)
    (l0g,) = build_hierarchy(gpu_vox, 0)
    net = init_parameters(SparseResNet50(3, 7, planes=(8, 16, 16, 32),
                                         init_dim=16), 1).eval()
    gnet = copy.deepcopy(net).to(cuda)
    launches = conv.MAP.launches, rank.RANK.launches
    with torch.no_grad():
        want = net(cpu_vox.feats.to(dtype), l0c)
        got = gnet(gpu_vox.feats.to(dtype), l0g)
    assert conv.MAP.launches == launches[0] + 2       # stem, conv5
    assert rank.RANK.launches >= launches[1] + 14     # maps and tables
    assert _rel(got.cpu(), want) <= (1e-4 if dtype == torch.float32
                                     else 2e-2)
    lc, lg = l0c, l0g
    for cap, stride, k in ((1024, 2, 3), (512, 2, 2), (256, 2, 2),
                           (64, 3, 3)):
        _, lc = downsample_level(lc, cap, stride=stride, kernel_size=k)
        _, lg = downsample_level(lg, cap, stride=stride, kernel_size=k)
        h = lc.child_hit
        assert torch.equal(lg.child_hit.cpu(), h)
        assert torch.equal(torch.where(h, lg.child_idx.cpu(), -1),
                           torch.where(h, lc.child_idx, -1))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_aliveunet_card_vs_cpu(cuda, block):
    """AliveUNet (depth 4, m = 8) on a build_hierarchy pyramid, the card
    against the CPU with the same weights, f32: 1e-4 in relative norm,
    padding rows exactly 0."""
    import copy

    from mrcc_tpu_torch.models import AliveUNet
    from mrcc_tpu_torch.sparse.nn import init_parameters

    pts, rgb, mask = build_batch(2, 4096, seed=7)
    args = [torch.as_tensor(a) for a in (pts, rgb, mask)]
    caps = (1024, 512, 256, 128)
    cpu_vox, _ = voxelize(*args, 1 / 100.0, 2048)
    gpu_vox, _ = voxelize(*(a.to(cuda) for a in args), 1 / 100.0, 2048)
    net = init_parameters(AliveUNet(3, 5, m=8, depth=4, block=block), 2)
    gnet = copy.deepcopy(net).to(cuda)
    with torch.no_grad():
        want = net.eval()(cpu_vox.feats, build_hierarchy(cpu_vox, 4, caps))
        got = gnet.eval()(gpu_vox.feats, build_hierarchy(gpu_vox, 4, caps))
    assert _rel(got.cpu(), want) <= 1e-4
    assert not got[~gpu_vox.valid].any()


# ------------------------------------------------ the dense PointNet2 path


def _dense_engines(cuda, method):
    """A small f32 engine pair with the dense keypoint stage (crops of 1024
    rows, 512 dense inputs), the same weights on the card and the CPU."""
    from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine

    cfg = InferenceConfig(
        point_capacity=2048, seg_voxel_capacity=1536, ee_point_capacity=1024,
        ee_voxel_capacity=1024, seg_backbone="minkunet14A",
        rot_backbone="minkunet14A", kp_backbone="pointnet2",
        kp_sampling_method=method, num_of_dense_input_points=512,
        icp_iterations=5, icp_template_points=256, compute_dtype="float32")
    cpu = InferenceEngine(cfg, device="cpu", seed=3)
    gpu = InferenceEngine(cfg, device=cuda, seed=5)
    for stage, model in gpu.models().items():
        model.load_state_dict(cpu.models()[stage].state_dict())
    return cpu, gpu


def _index_calls(monkeypatch):
    """Record every FPS and ball query's inputs and output, in order."""
    from mrcc_tpu_torch.ops import points

    calls = []
    fps, ball = points.farthest_point_sample, points.query_ball_point
    monkeypatch.setattr(points, "farthest_point_sample",
                        lambda xyz, k, start_idx=0: calls.append(
                            ("fps", None, fps(xyz, k, start_idx)))
                        or calls[-1][2])
    monkeypatch.setattr(points, "query_ball_point",
                        lambda r, k, xyz, q: calls.append(
                            ("ball", (r, xyz, q), ball(r, k, xyz, q)))
                        or calls[-1][2])
    return calls


@pytest.mark.parametrize("method", ["uniform", "farthest"])
def test_dense_engine_card_vs_cpu(cuda, monkeypatch, method):
    """The dense keypoint stage on the card against the CPU from the same
    crop and weights: every FPS index equal; ball groups equal except rows
    with a member whose f64 squared distance lies within 1e-6 of r^2;
    keypoints found and their coordinates equal, poses 1e-3; the whole
    ``predict_batch_arrays``' integer outputs equal."""
    cpu, gpu = _dense_engines(cuda, method)
    pts, rgb, mask = build_batch(2, 2048, seed=11)
    ee = cpu.seg_stage(*[torch.as_tensor(a) for a in (pts, rgb, mask)])[2:5]
    calls = _index_calls(monkeypatch)
    want = cpu.kp_stage(*ee)
    n = len(calls)
    got = [t.cpu() for t in gpu.kp_stage(*[t.to(cuda) for t in ee])]
    assert n and len(calls) == 2 * n
    for (kind, args, w), (_, _, g) in zip(calls[:n], calls[n:]):
        g = g.cpu()
        if kind == "fps":
            assert torch.equal(g, w)
            continue
        radius, xyz, q = args
        for b, s in (g != w).any(-1).nonzero().tolist():
            d2 = ((xyz[b].double() - q[b, s].double()) ** 2).sum(-1)
            assert ((d2 - radius ** 2).abs() < 1e-6).any(), (b, s)
    for i in (1, 2, 3):
        assert torch.equal(got[i], want[i])
    assert (got[0] - want[0])[:, :3].abs().max() <= 1e-3
    monkeypatch.undo()
    full_g = gpu.predict_batch_arrays(pts, rgb, mask)
    full_c = cpu.predict_batch_arrays(pts, rgb, mask)
    for k in ("segmentation", "ee_count", "kp_found", "kp_ok"):
        assert torch.equal(full_g[k].cpu(), full_c[k]), k


def test_dense_stage_ignores_tf32(cuda, monkeypatch):
    """With ``torch.backends.cuda.matmul.allow_tf32 = True`` the dense
    stage's FPS and ball-query indices, keypoints and confidences are the
    bits it gives with TF32 off (its distance matmuls and its net run at
    full f32 precision)."""
    _, gpu = _dense_engines(cuda, "farthest")
    pts, rgb, mask = build_batch(2, 2048, seed=12)
    ee = gpu.seg_stage(*[torch.as_tensor(a, device=cuda)
                         for a in (pts, rgb, mask)])[2:5]
    calls = _index_calls(monkeypatch)
    off = gpu.kp_stage(*ee)
    n = len(calls)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    on = gpu.kp_stage(*ee)
    assert torch.backends.cuda.matmul.allow_tf32
    assert len(calls) == 2 * n
    assert all(torch.equal(a[2], b[2]) for a, b in zip(calls[:n], calls[n:]))
    for i in (1, 2, 3, 4):
        assert torch.equal(on[i], off[i])


@pytest.mark.parametrize("head", ["key_points", "kp_to_pose"])
def test_dense_steps_card_vs_cpu(cuda, head):
    """One dense keypoint step (PointNet2SSG) and one keypoint-to-pose step
    (frozen PointNet2SSG -> PointNet) on the card against the CPU from the
    same weights, batch (B = 2 x 512) and dropout masks, in float64: loss
    1e-5, gradients 1e-4 and the update 1e-3 in relative norm (the update
    where |g| is above 1 % of its tensor's rms), running statistics 1e-5.
    In f32 the dense nets' gradients move by tens of per cent under a 1e-7
    relative move of the input (ROADMAP C31), so f32 is not held here."""
    import copy

    import numpy as np

    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.data.dense import AliveV2DenseDataset
    from mrcc_tpu_torch.data.synthetic import generate_sample
    from mrcc_tpu_torch.models import PointNet, PointNet2SSG
    from mrcc_tpu_torch.sparse.nn import SparseDropout, init_parameters
    from mrcc_tpu_torch.train import (TrainConfig,
                                      make_dense_key_point_train_step,
                                      make_kp_to_pose_train_step)

    data = AliveV2DenseDataset(
        samples=[generate_sample(seed=70 + i, n_ee=1200, n_arm=600,
                                 n_bg=600) for i in range(2)],
        cfg=DataConfig(keypoints_enabled=True), num_points=512,
        sampling="uniform" if head == "kp_to_pose" else "farthest")
    batch = data.collate([data[0], data[1]])
    batch = dict(batch, **{k: batch[k].astype(np.float64)
                           for k in ("points", "feats", "pose")})
    kp = init_parameters(PointNet2SSG(num_classes=6), 0).double()
    if head == "key_points":
        start = kp
    else:
        with torch.no_grad():
            kp.conv2.weight.mul_(300.0)   # so that classes pass 0.75
        start = init_parameters(PointNet(out_channels=7), 1).double()
    masks = {}

    def fixed(name, rate, feats):
        """One mask per dropout and shape, drawn on the CPU."""
        key = (name, feats.shape)
        if key not in masks:
            masks[key] = torch.rand(feats.shape, generator=torch.Generator(
            ).manual_seed(len(masks))) < 1 - rate
        return torch.where(masks[key].to(feats.device), feats / (1 - rate),
                           0.0)

    out = {}
    for dev in ("cpu", cuda):
        model = copy.deepcopy(start)
        for name, mod in model.named_modules():
            if isinstance(mod, SparseDropout):
                mod.forward = (lambda f, _n=name, _r=mod.rate:
                               fixed(_n, _r, f))
        if head == "key_points":
            step, _ = make_dense_key_point_train_step(model, TrainConfig(),
                                                      device=dev)
        else:
            step, _ = make_kp_to_pose_train_step(model, copy.deepcopy(kp),
                                                 TrainConfig(), True,
                                                 device=dev)
        loss = float(step(batch, 1e-4)["loss"])
        out[str(dev)] = (loss, {n: p.grad.cpu() for n, p in
                                model.named_parameters()},
                         {n: p.detach().cpu() for n, p in
                          model.named_parameters()},
                         {n: b.cpu() for n, b in model.named_buffers()})
    (lc, gc, pc, bc), (lg, gg, pg, bg) = out["cpu"], out[str(cuda)]
    assert lc > 0 and abs(lg - lc) <= 1e-5 * abs(lc)
    zero = ("conv1.bias",) if head == "key_points" else ()
    num = sum(float((gg[n] - gc[n]).norm() ** 2) for n in gc if n not in zero)
    den = sum(float(gc[n].norm() ** 2) for n in gc if n not in zero)
    assert (num / den) ** 0.5 <= 1e-4
    ud = un = 0.0
    for n, p0 in start.named_parameters():
        if n in zero:
            continue
        g = gc[n]
        keep = (g == 0) | (g.abs() > 1e-2 * g.pow(2).mean().sqrt())
        u_c = (pc[n] - p0.detach())[keep]
        u_g = (pg[n] - p0.detach())[keep]
        ud += float((u_g - u_c).norm() ** 2)
        un += float(u_c.norm() ** 2)
    assert (ud / un) ** 0.5 <= 1e-3
    for n in bc:
        assert _rel(bg[n], bc[n]) <= 1e-5, n


def test_mesh_engine_equals_engine(cuda):
    """A 1-rank NCCL mesh: ``predict_batch_arrays`` on the plain batch and
    on ``fleet.globalize`` of it gives the engine's own bits (bf16, every
    kernel of its path launched)."""
    import torch.distributed as dist

    from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
    from mrcc_tpu_torch.parallel import fleet, make_mesh

    cfg = InferenceConfig(
        point_capacity=4096, seg_voxel_capacity=3072,
        seg_hierarchy_caps=(2048, 1024, 512, 256), ee_point_capacity=1024,
        ee_voxel_capacity=1024, ee_hierarchy_caps=(512, 256, 128, 128),
        kp_voxel_capacity=1024, kp_hierarchy_caps=(768, 640, 384, 128),
        seg_backbone="minkunet14A", rot_backbone="minkunet14A",
        kp_backbone="minkunet14A", icp_iterations=5, icp_template_points=256)
    pts, rgb, mask = (torch.as_tensor(x, device=cuda)
                      for x in build_batch(2, 4096, seed=3))
    engine = InferenceEngine(cfg, device=cuda)
    want = engine.predict_batch_arrays(pts, rgb, mask)
    engine.mesh = make_mesh(1, "cuda")
    try:
        assert dist.get_backend() == "nccl"
        for ctr in (sort.SORT, conv.SK, conv.DOWN, conv.UP):
            ctr.launches = 0
        got = engine.predict_batch_arrays(pts, rgb, mask)
        assert min(c.launches for c in (sort.SORT, conv.SK, conv.DOWN,
                                        conv.UP)) > 0
        glob = engine.predict_batch_arrays(*fleet.globalize(
            engine.mesh, pts, rgb, mask))
    finally:
        dist.destroy_process_group()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(glob[k].to_local(), v), k


def test_native_matches_card_voxelizer(cuda):
    """The host runtime's voxels (``native.voxelize_host``, built with the
    host compiler) against the card voxelizer's on one cloud: the same
    voxel set, feature means 1e-5, labels equal."""
    from mrcc_tpu_torch import native

    rng = np.random.default_rng(5)
    # inside voxels, away from their borders (where x * (1 / q) and x / q
    # may round to different sides)
    cells = np.floor(rng.normal(size=(20000, 3)) * 15)
    pts = ((cells + rng.uniform(0.1, 0.9, (20000, 3))) * 0.02).astype(
        np.float32)
    feats = rng.random((20000, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 20000).astype(np.int32)
    labels[:10000] = 1
    coords, hf, hl, _, nv = native.voxelize_host(pts, feats, 0.02, 20000,
                                                 labels=labels)
    vox, _, vl = voxelize(*(torch.as_tensor(x, device=cuda)[None]
                            for x in (pts, feats)),
                          torch.ones((1, 20000), dtype=torch.bool,
                                     device=cuda), 0.02, 20000,
                          labels=torch.as_tensor(labels, device=cuda)[None])
    n = int(vox.count[0])
    card = {tuple(k): i for i, k in
            enumerate(vox.coords()[0, :n].cpu().numpy())}
    cf, cl = vox.feats[0].cpu().numpy(), vl[0].cpu().numpy()
    assert nv == n and set(card) == {tuple(k) for k in coords}
    for i, k in enumerate(map(tuple, coords)):
        np.testing.assert_allclose(hf[i], cf[card[k]], atol=1e-5)
        assert hl[i] == cl[card[k]]
