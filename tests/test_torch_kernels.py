"""Card-only tests: each CUDA kernel of mrcc_tpu_torch vs its plain twin.

Marked ``gpu``; each test skips where ``torch.cuda.is_available()`` is
false.  This file imports no JAX (the card's machine has none), so it runs
there on its own:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the sort is exact; f32 convs and dW kernels agree with the
plain twin to relative norm 1e-5 (summation order), bf16 ones with the f32
twin to 2e-2; the int8 convs agree with their plain twins to 1 ulp of the
output type elementwise (their int32 sums are exact) and with the f32
plain conv to 3e-2.  The dW kernels are deterministic (no float atomics): two
launches give the same bits.  The autograd Functions' backward on the card
agrees with autograd through the plain forward twins to 1e-5.  The rank
kernel equals its plain twin exactly; the k3-table convs hold the conv
tolerances above; the nearest-neighbour kernel's d2 is within 1e-5 of its
twin and its indices equal except at near-ties (the two smallest d2 of a
row within 1e-6 of |a|^2, the scale of the f32 rounding of
|a|^2 - 2ab + |b|^2).
"""

import pytest
import torch

from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.ops import conv, conv_q8, nn, rank, sort
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


@pytest.mark.parametrize("n", [1, 77, 4096, 16384, 16385, 40000, 1 << 17])
def test_argsort_exact(cuda, n):
    gen = torch.Generator().manual_seed(n)
    key = torch.randint(0, max(n // 4, 2), (3, n), generator=gen,
                        dtype=torch.int32)
    key[:, torch.rand(n, generator=gen) < 0.25] = KEY_PAD
    key = key.to(cuda)
    before = sort.SORT.launches
    got = sort.argsort(key)
    assert sort.SORT.launches == before + 1
    want = sort.argsort_plain(key)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_argsort_rejects(cuda):
    with pytest.raises(ValueError):
        sort.argsort(torch.zeros((2, 8), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        sort.argsort(torch.zeros((1, (1 << 17) + 1), dtype=torch.int32,
                                 device=cuda))


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


@pytest.mark.parametrize("cin,cout", [(32, 32), (20, 90)])
@pytest.mark.parametrize("l", [0, 2])
def test_conv_down_up(cuda, levels, l, cin, cout):
    fine, coarse = levels[l], levels[l + 1]
    w = torch.randn((8, cin, cout), device=cuda) / 3
    f = _feats(fine, cin)
    args = (f, w, coarse.child_idx, coarse.child_hit)
    want = conv.gather_gemm_down_plain(*args)
    assert _rel(conv.gather_gemm_down(*args), want) <= 1e-5
    assert _rel(conv.gather_gemm_down(f.bfloat16(), w.bfloat16(),
                                      *args[2:]), want) <= 2e-2
    f = _feats(coarse, cin)
    row_ok = fine.valid & fine.parent_ok
    args = (f, w, fine.parent_idx, row_ok, fine.octant)
    want = conv.gather_gemm_up_plain(*args)
    assert _rel(conv.gather_gemm_up(*args), want) <= 1e-5
    assert _rel(conv.gather_gemm_up(f.bfloat16(), w.bfloat16(), *args[2:]),
                want) <= 2e-2


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
        "sk": (conv.dw_sk, conv.dw_sk_plain, conv.DW_SK, _feats(fine, cin),
               _feats(fine, cout), (fine.key, fine.kbits)),
        "down": (conv.dw_down, conv.dw_down_plain, conv.DW_DOWN,
                 _feats(fine, cin), _feats(coarse, cout),
                 (coarse.child_idx, coarse.child_hit)),
        "up": (conv.dw_up, conv.dw_up_plain, conv.DW_UP, _feats(coarse, cin),
               _feats(fine, cout), (fine.parent_idx, row_ok, fine.octant)),
    }


@pytest.mark.parametrize("kind", ["sk", "down", "up"])
@pytest.mark.parametrize("cin,cout", [(3, 32), (20, 90), (130, 70)])
@pytest.mark.parametrize("l", [0, 2])
def test_dw_kernels(cuda, levels, kind, l, cin, cout):
    _check_dw(*_dw_cases(levels, l, cin, cout)[kind])


@pytest.mark.parametrize("kind", ["sk", "down", "up"])
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


@pytest.mark.parametrize("kind", ["k3", "down", "up"])
def test_conv_function_backward(cuda, levels, kind):
    """The Functions' backward (kernels) vs autograd of the plain twins."""
    from mrcc_tpu_torch.sparse import conv as C

    fine, coarse = levels[1], levels[2]
    cin, cout = 48, 40
    if kind == "k3":
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


# ---------------------------------------------------------------- int8


def _ulps(got, want):
    """Largest |got - want| in ulps of the output type at the larger
    magnitude (bf16: 8 significant bits, f32: 24)."""
    bits = 8 if got.dtype == torch.bfloat16 else 24
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - (bits - 1))
    return float(((g - w).abs() / ulp).max())


def _check_q8(fn, plain, counter, unquantised, f, w, maps):
    want = plain(f, w, *maps)
    before = counter.launches
    got = fn(f, w, *maps)
    assert counter.launches == before + 1
    assert got.dtype == f.dtype and got.shape == want.shape
    assert _ulps(got, want) <= 1.0
    assert _rel(got, unquantised(f.float(), w, *maps)) <= 3e-2
    amax = f.float().abs().amax(dim=(0, 1))  # calibrated == dynamic
    assert torch.equal(fn(f, w, *maps, act_absmax=amax), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (256, 40),
                                      (416, 96)])
def test_conv_sk_q8(cuda, levels, cin, cout, dtype):
    """Cin 3 is the stem; 256 and 416 split into 128-channel groups."""
    lv = levels[0]
    assert len(conv_q8.q8_channel_groups("k3", lv.key.shape[1], cin)) == \
        -(-cin // 128)
    _check_q8(conv_q8.gather_gemm_sk_q8, conv_q8.gather_gemm_sk_q8_plain,
              conv_q8.SK_Q8, conv.gather_gemm_sk_plain, _feats(lv, cin, dtype),
              torch.randn((27, cin, cout), device=cuda) / 9,
              (lv.key, lv.kbits))


@pytest.mark.parametrize("cin,cout", [(32, 32), (20, 90), (896, 40)])
@pytest.mark.parametrize("l", [0, 2])
def test_conv_down_up_q8(cuda, levels, l, cin, cout):
    """896 channels split 768 + 128 (the int8 k-lane cap)."""
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


def test_conv_up_q8_lane_packed_groups(cuda, levels, monkeypatch):
    """An up conv from a table over the (shrunk) budget: 64-channel
    groups, as the JAX wrapper's lane-packed plan."""
    fine, coarse = levels[1], levels[2]
    n = coarse.key.shape[1]
    monkeypatch.setattr(conv_q8, "_TABLE_BUDGET", n * 64)
    assert conv_q8.q8_channel_groups("up", n, 160) == ((0, 64), (64, 128),
                                                       (128, 160))
    _check_q8(conv_q8.gather_gemm_up_q8, conv_q8.gather_gemm_up_q8_plain,
              conv_q8.UP_Q8, conv.gather_gemm_up_plain,
              _feats(coarse, 160, torch.bfloat16),
              torch.randn((8, 160, 40), device=cuda) / 9,
              (fine.parent_idx, fine.row_ok, fine.octant))


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


@pytest.mark.parametrize("n,nq", [(1, 5), (300, 300), (4096, 1000),
                                  (72448, 72448)])
def test_rank_exact(cuda, n, nq):
    """Unique keys, repeated KEY_PAD padding and KEY_PAD query bases."""
    gen = torch.Generator().manual_seed(n)
    keys = torch.randperm(1 << 22, generator=gen)[:n].sort().values
    keys = keys.to(torch.int32)
    keys[int(0.8 * n):] = KEY_PAD
    qbase = keys[torch.randint(0, n, (nq,), generator=gen)].sort().values
    qbase = qbase + torch.randint(-1, 2, (nq,), generator=gen,
                                  dtype=torch.int32)
    qbase[int(0.9 * nq):] = KEY_PAD
    qbits = torch.randint(-(1 << 31), 1 << 31, (2, nq), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    args = (torch.stack([keys, keys.flip(0).sort().values]).to(cuda),
            torch.stack([qbase, qbase]).to(cuda), qbits.to(cuda))
    for deltas in (K3_DELTAS, (0, 1, 2, 3, 7, -5)):
        want = rank.rank_lookup_plain(args[0], args[1], deltas, args[2])
        before = rank.RANK.launches
        got = rank.rank_lookup(args[0], args[1], deltas, args[2])
        assert rank.RANK.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (384, 40)])
def test_conv_k3_map_q8(cuda, levels, cin, cout):
    """384 channels split 256 + 128 (the int8 k-lane cap of 27 offsets)."""
    lv = levels[0]
    idx, hit = neighbor_tables(lv)
    assert len(conv_q8.q8_channel_groups("k3_table", lv.key.shape[1],
                                         cin)) == (2 if cin == 384 else 1)
    _check_q8(conv_q8.gather_gemm_k3_map_q8,
              conv_q8.gather_gemm_k3_map_q8_plain, conv_q8.K3MAP_Q8,
              conv.gather_gemm_k3_map_plain, _feats(lv, cin, torch.bfloat16),
              torch.randn((27, cin, cout), device=cuda) / 9, (idx, hit))


@pytest.mark.parametrize("b,m,n", [(2, 256, 512), (3, 100, 1500)])
def test_nn_search(cuda, b, m, n):
    gen = torch.Generator().manual_seed(m)
    tmpl = (torch.randn((b, m, 3), generator=gen) * 0.1 + 1).to(cuda)
    tgt = (torch.randn((b, n, 3), generator=gen) * 0.1 + 1).to(cuda)
    mask = (torch.rand((b, n), generator=gen) > 0.3).to(cuda)
    before = nn.NN.launches
    idx, d2 = nn.nn_search(tmpl, tgt, mask)
    assert nn.NN.launches == before + 1
    w_idx, w_d2 = nn.nn_search_plain(tmpl, tgt, mask)
    assert float((d2 - w_d2).abs().max()) <= 1e-5
    sqs = (tmpl * tmpl).sum(-1)
    full = sqs[..., None] - 2 * torch.bmm(tmpl, tgt.transpose(1, 2)) + (
        tgt * tgt).sum(-1)[:, None]
    two = torch.where(mask[:, None], full, float("inf")).topk(
        2, dim=-1, largest=False).values
    tie = (two[..., 1] - two[..., 0]) <= 1e-6 * sqs
    assert not bool(((idx != w_idx) & ~tie).any())
    assert bool(mask.gather(1, idx.long()).all())
