"""The masked batch norm with ReLU and residual add (``ops/norm.py``,
``csrc/norm.cu``; ``sparse/nn.py`` ``SparseBatchNorm``).

On the CPU (tier 1):
- the ``relu`` / ``residual`` flags give the bits of the eager composition
  they replace (the norm, then ``+ residual``, then ``torch.relu``):
  outputs, every gradient and the running statistics, f32 and bf16, train
  and eval;
- the plain twin of the backward kernels (the hand-derived formula)
  matches autograd through the eager expression, its math in float64,
  to 1e-10, for
  every flag combination, with padding rows and an item of padding only;
- the kernels' layout covers every channel with 16-byte loads where C
  divides, at most 256 threads a block, and every row once, on a card of
  132 multiprocessors (an H100 SXM) and of 16;
- the wrapper's checks refuse what the kernels do not take.

On the card (marked ``gpu``; skips without one; this file imports no JAX,
so it runs there alone: ``python -m pytest tests/test_torch_norm.py -m gpu
--noconftest``): the kernels against the plain twin over f32 / bf16, C in
{3, 32, 64, 384, 416, 1024}, all four flag combinations, train and eval,
padding rows and an empty item: outputs (f32 1e-5, bf16 2e-2 relative
norm, the twin's own bf16 rounding), running statistics 1e-5; the
backward against autograd through the twin to 1e-5 (f32; bf16 2e-2); two
calls give the same bits; each call launches what its counters say; a
dtype outside f32 / bf16 raises; two gloo ranks on the card in a
data-parallel step agree with one process to 1e-5.
"""

import numpy as np
import pytest
import torch

from mrcc_tpu_torch.ops import norm
from mrcc_tpu_torch.sparse.nn import SparseBatchNorm

CHANNELS = (3, 32, 64, 384, 416, 1024)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tier runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, dtype, device="cpu", b=3, n=40, seed=0):
    """Features with a channel offset (so the two passes matter), finite
    junk on padding rows, the first rows of each item valid and item 1 of
    padding only; a residual and a cotangent of the same shape."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, n, c)) * 2.0 + g.standard_normal(c) * 3.0
    valid = np.zeros((b, n), bool)
    for i in range(b):
        valid[i, :0 if i == 1 else n - 1 - (i * 997) % (n // 4)] = True
    res = g.standard_normal((b, n, c))
    cot = g.standard_normal((b, n, c))
    w = 1.0 + 0.5 * g.standard_normal(c)
    bias = 0.5 * g.standard_normal(c)

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    return (t(x), torch.tensor(valid, device=device), t(res), t(cot),
            t(w, torch.float32), t(bias, torch.float32))


def _layer(c, w, bias, training, device):
    layer = SparseBatchNorm(c).to(device)
    with torch.no_grad():
        layer.bn.weight.copy_(w)
        layer.bn.bias.copy_(bias)
        layer.bn.running_mean.copy_(torch.linspace(-1, 1, c))
        layer.bn.running_var.copy_(torch.linspace(0.5, 2, c))
    return layer.train(training)


def _run(layer, x, valid, res, cot, relu, residual, how="flags"):
    """Forward and backward of the norm with the flags (``how="flags"``),
    as the composition they replace (``"composition"``) or as the plain
    twin on the layer's tensors (``"twin"``); returns the output and every
    gradient and statistic."""
    x = x.detach().clone().requires_grad_(True)
    r = res.detach().clone().requires_grad_(True) if residual else None
    bn = layer.bn
    if how == "flags":
        y = layer(x, valid, relu=relu, residual=r)
    elif how == "twin":
        y = norm.batch_norm_plain(
            x, valid, bn.weight, bn.bias, bn.running_mean, bn.running_var,
            training=layer.training, momentum=layer.momentum, eps=layer.eps,
            relu=relu, residual=r)
    else:
        y = layer(x, valid)
        if residual:
            y = y + r
        if relu:
            y = torch.relu(y)
    (y.float() * cot.float()).sum().backward()
    out = {"y": y, "dx": x.grad, "dgamma": bn.weight.grad,
           "dbeta": bn.bias.grad, "running_mean": bn.running_mean.clone(),
           "running_var": bn.running_var.clone()}
    if residual:
        out["dres"] = r.grad
    layer.zero_grad()
    return out


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu,residual", FLAGS)
def test_flags_give_the_composition_bits(dtype, training, relu, residual):
    x, valid, res, cot, w, bias = _inputs(24, dtype)
    got = _run(_layer(24, w, bias, training, "cpu"), x, valid, res, cot,
               relu, residual)
    want = _run(_layer(24, w, bias, training, "cpu"), x, valid, res, cot,
                relu, residual, "composition")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu,residual", FLAGS)
def test_grad_formula_matches_autograd_float64(training, relu, residual):
    x, valid, res, cot, w, bias = _inputs(16, torch.float64, seed=1)
    w, bias = w.double(), bias.double()
    rm = torch.linspace(-1, 1, 16, dtype=torch.float64)
    rv = torch.linspace(0.5, 2, 16, dtype=torch.float64)
    x = x.requires_grad_(True)
    w.requires_grad_(True)
    bias.requires_grad_(True)
    r = res.requires_grad_(True) if residual else None
    # the twin's expression with its math in float64
    v = valid[..., None]
    if training:
        n = torch.clamp_min(v.sum().double(), 1.0)
        mean = (x * v).sum(dim=(0, 1)) / n
        var = (((x - mean) ** 2) * v).sum(dim=(0, 1)) / n
    else:
        n, mean, var = torch.ones((), dtype=torch.float64), rm, rv
    rstd = torch.rsqrt(var + 1e-5)
    y = torch.where(v, (x - mean) * rstd * w + bias, 0.0)
    if residual:
        y = y + r
    if relu:
        y = torch.relu(y)
    (y * cot).sum().backward()
    save = torch.cat([mean.detach(), rstd.detach(), n.reshape(1)])
    dx, dgamma, dbeta, dres = norm.batch_norm_grad_plain(
        cot, x.detach(), y.detach() if relu else None, valid, w.detach(),
        save, training=training)
    assert float((dx - x.grad).abs().max()) < 1e-10
    assert float((dx[1]).abs().max()) == 0.0  # the item of padding only
    assert float((dgamma - w.grad).abs().max()) < 1e-10
    assert float((dbeta - bias.grad).abs().max()) < 1e-10
    if residual:
        assert float((dres - r.grad).abs().max()) < 1e-10


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("rows", [0, 37, 3 * 16384, 8 * 16384])
@pytest.mark.parametrize("sms", [132, 16])
def test_layout_covers_channels_and_rows(c, itemsize, rows, sms):
    lay = norm.norm_layout(c, itemsize, rows, sms)
    assert c % lay.vec == 0 and lay.vec * itemsize <= 16
    if c % (16 // itemsize) == 0:
        assert lay.vec * itemsize == 16
    assert lay.tx * lay.ty <= 256 and lay.ty & (lay.ty - 1) == 0
    assert lay.tx <= 32
    width = lay.tx * lay.vec
    assert (lay.chunks - 1) * width < c <= lay.chunks * width
    assert lay.parts * lay.rows_per_part >= rows
    assert (lay.parts - 1) * lay.rows_per_part < max(rows, 1)
    assert lay.blocks >= 1


@pytest.mark.parametrize("case", ["dtype", "valid", "param", "residual"])
def test_checks_refuse(case):
    x, valid, res, _, w, bias = _inputs(8, torch.float32)
    params = [w, bias, torch.zeros(8), torch.ones(8)]
    residual = None
    if case == "dtype":
        x = x.double()
    elif case == "valid":
        valid = valid.float()
    elif case == "param":
        params[2] = params[2].double()
    else:
        residual = res[:, :-1]
    with pytest.raises(ValueError):
        norm._check(x, valid, residual, params)


# --------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu,residual", FLAGS)
def test_card_matches_twin(cuda, dtype, c, training, relu, residual):
    x, valid, res, cot, w, bias = _inputs(c, dtype, cuda, n=300, seed=c)
    before = norm.NORM_APPLY.launches
    got = _run(_layer(c, w, bias, training, cuda), x, valid, res, cot, relu,
               residual)
    assert norm.NORM_APPLY.launches == before + 1
    want = _run(_layer(c, w, bias, training, cuda), x, valid, res, cot,
                relu, residual, "twin")
    assert got["y"].dtype == dtype
    for k in want:
        tol = 1e-5 if k.startswith("running") else _tol(dtype)
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))
    pad = ~valid
    assert torch.equal(got["dx"][pad], torch.zeros_like(got["dx"][pad]))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 384])
def test_card_full_size(cuda, c):
    """The cells' largest level: 8 x 16384 rows (many row blocks a chunk,
    the last-block sums over all their partials)."""
    x, valid, res, cot, w, bias = _inputs(c, torch.float32, cuda, b=8,
                                          n=16384, seed=7)
    got = _run(_layer(c, w, bias, True, cuda), x, valid, res, cot, True,
               True)
    want = _run(_layer(c, w, bias, True, cuda), x, valid, res, cot, True,
                True, "twin")
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, _rel(got[k], want[k]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_two_calls_same_bits(cuda, dtype):
    x, valid, res, cot, w, bias = _inputs(384, dtype, cuda, b=4, n=4096)
    runs = [_run(_layer(384, w, bias, True, cuda), x, valid, res, cot, True,
                 True) for _ in range(2)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("training", [True, False])
def test_card_launches_as_counted(cuda, training):
    x, valid, res, cot, w, bias = _inputs(64, torch.float32, cuda)
    counters = (norm.NORM_SUM, norm.NORM_VAR, norm.NORM_APPLY,
                norm.NORM_GRAD_SUMS, norm.NORM_GRAD)
    before = [k.launches for k in counters]
    _run(_layer(64, w, bias, training, cuda), x, valid, res, cot, True,
         True)
    added = [k.launches - b for k, b in zip(counters, before)]
    assert added == ([1, 1, 1, 1, 1] if training else [0, 0, 1, 1, 1])
    with torch.no_grad():  # inference: the forward alone
        before = [k.launches for k in counters]
        _layer(64, w, bias, training, cuda)(x, valid, relu=True)
        added = [k.launches - b for k, b in zip(counters, before)]
    assert added == ([1, 1, 1, 0, 0] if training else [0, 0, 1, 0, 0])


@pytest.mark.gpu
def test_card_refuses_other_dtypes(cuda):
    x, valid, _, _, w, bias = _inputs(32, torch.float64, cuda)
    with pytest.raises(ValueError):
        _layer(32, w, bias, True, cuda)(x, valid)


@pytest.mark.gpu
def test_card_data_parallel_matches_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card run one data-parallel step of the
    norm (train mode, ReLU and residual), each on its half of the batch;
    the single process runs the whole batch.  The ranks' outputs and input
    gradients are the single process's rows, their summed dgamma / dbeta
    and both ranks' running statistics the single process's, to 1e-5."""
    from torch_dp_worker import run_ranks

    c = 96
    x, valid, res, cot, w, bias = _inputs(c, torch.float32, cuda, b=4,
                                          n=512, seed=3)
    spec = {"device": "cuda", "feats": x.cpu().numpy(),
            "valid": valid.cpu().numpy(), "residual": res.cpu().numpy(),
            "cot": cot.cpu().numpy(), "weight": w.cpu().numpy(),
            "bias": bias.cpu().numpy()}
    layer = SparseBatchNorm(c).to(cuda).train()
    with torch.no_grad():
        layer.bn.weight.copy_(w)
        layer.bn.bias.copy_(bias)
    want = _run(layer, x, valid, res, cot, True, True)
    ranks = run_ranks("norm", spec, tmp_path, timeout_s=240)
    for r, got in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        assert got["launches"] == {"norm_sum": 1, "norm_var": 1,
                                   "norm_apply": 1, "norm_grad_sums": 1,
                                   "norm_grad": 1}
        for k in ("y", "dx", "dres"):
            assert _rel(torch.from_numpy(got[k]), want[k][rows].cpu()) \
                <= 1e-5, (r, k)
        for k in ("dgamma", "dbeta", "running_mean", "running_var"):
            assert _rel(torch.from_numpy(got[k]), want[k].cpu()) <= 1e-5, \
                (r, k)
