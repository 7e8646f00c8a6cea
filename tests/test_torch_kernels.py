"""Card-only tests: each CUDA kernel of mrcc_tpu_torch vs its plain twin.

Marked ``gpu``; each test skips where ``torch.cuda.is_available()`` is
false.  This file imports no JAX (the card's machine has none), so it runs
there on its own:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the sort is exact; f32 convs and dW kernels agree with the
plain twin to relative norm 1e-5 (summation order), bf16 ones with the f32
twin to 2e-2.  The dW kernels are deterministic (no float atomics): two
launches give the same bits.  The autograd Functions' backward on the card
agrees with autograd through the plain forward twins to 1e-5.
"""

import pytest
import torch

from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.ops import conv, sort
from mrcc_tpu_torch.sparse import KEY_PAD, build_hierarchy, voxelize

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
