"""Card-only tests: each CUDA kernel of mrcc_tpu_torch vs its plain twin.

Marked ``gpu``; each test skips where ``torch.cuda.is_available()`` is
false.  This file imports no JAX (the card's machine has none), so it runs
there on its own:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the sort is exact; f32 convs agree with the plain twin to
relative norm 1e-5 (summation order), bf16 convs with the f32 twin to 2e-2.
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
