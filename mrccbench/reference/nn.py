"""The plain reference's layers: sparse convs over the index maps of
:mod:`.sparse`, the dense products, batch norm and the loss, in float32
with every product as ``torch.mm`` (TF32 off).

``Precision("tf32")`` rounds both operands of every product, forward and
backward, to TF32 (10 explicit mantissa bits, round to nearest with ties
away from zero, as the tensor cores' conversion) and accumulates in f32:
the control that a float32 program must be told apart from.

The sparse convs are autograd Functions that keep only their input, so a
full-width step fits beside the program's: forward ``out[r] += x[s] @
W[k]`` for every map pair ``(r, s)`` of offset ``k``; backward ``dW[k] =
x[s]^T dy[r]`` and ``dx[s] += dy[r] W[k]^T``.  Within one offset the rows
are distinct, so every ``index_add_`` sums in a fixed order.
"""

from __future__ import annotations

import torch

TF32_ROUND = 1 << 12
TF32_MASK = -(1 << 13)  # ...ffffe000: sign, exponent, 10 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32: to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + TF32_ROUND) & TF32_MASK).view(torch.float32)


class Precision:
    """``"float32"``: plain f32 products; ``"tf32"``: operands rounded to
    TF32, f32 accumulation."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.mm(a, b)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(x, w)
        ctx.prec = prec
        return prec.mm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        prec = ctx.prec
        dx = prec.mm(dy, w.t()) if ctx.needs_input_grad[0] else None
        return dx, prec.mm(x.t(), dy), None


def matmul(x, w, prec: Precision):
    """``x [M, Cin] @ w [Cin, Cout]`` with its backward in ``prec``."""
    return _Matmul.apply(x, w, prec)


class _MapConv(torch.autograd.Function):
    """``out [n_out, Cout] = sum_k sum_(r, s) in pairs[k] x[s] @ w[k]``."""

    @staticmethod
    def forward(ctx, x, w, pairs, n_out, prec):
        ctx.save_for_backward(x, w)
        ctx.pairs, ctx.prec = pairs, prec
        out = x.new_zeros((n_out, w.shape[-1]))
        for k, (r, s) in enumerate(pairs):
            if r.numel():
                out.index_add_(0, r, prec.mm(x[s], w[k]))
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        prec = ctx.prec
        dw = torch.zeros_like(w)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        for k, (r, s) in enumerate(ctx.pairs):
            if not r.numel():
                continue
            g = dy[r]
            dw[k] = prec.mm(x[s].t(), g)
            if dx is not None:
                dx.index_add_(0, s, prec.mm(g, w[k].t()))
        return dx, dw, None, None, None


def conv_k3(x, w, level, prec):
    """k=3 s=1 submanifold conv on one level (``level.k3`` pairs are
    ``(out rows, in rows)``)."""
    return _MapConv.apply(x, w, level.k3, level.rows, prec)


def conv_down(x, w, octs, coarse, prec):
    """k=2 s=2 conv: each fine row adds ``x @ W[octant]`` to its parent."""
    pairs = [(parent, fine) for fine, parent in octs]
    return _MapConv.apply(x, w, pairs, coarse.rows, prec)


def conv_up(x, w, octs, fine, prec):
    """k=2 s=2 transpose conv: each fine row with a parent takes
    ``x[parent] @ W[octant]``; rows without one are 0."""
    return _MapConv.apply(x, w, octs, fine.rows, prec)


def batch_norm(x, weight, bias, eps=1e-5):
    """Train-mode batch norm over every row (the valid voxels of the whole
    batch): batch mean and biased variance."""
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).mean(dim=0)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def cross_entropy(logits, labels, ignore_label=-100):
    """Mean cross-entropy over the rows whose label is not ignored."""
    keep = labels != ignore_label
    ll = torch.log_softmax(logits[keep], dim=-1)
    return -ll.gather(1, labels[keep][:, None]).mean()
