"""Masked batch norm with its ReLU and residual add, forward and backward
(``csrc/norm.cu``), and the plain twins.

Replaces no TPU kernel: the JAX package's norm
(``mrcc_tpu/sparse/nn.py::SparseBatchNorm``) is plain ``jnp``, which XLA
fuses with the ReLU and the residual add around it.  Eager PyTorch ran the
same expression as about 30 ATen kernels a norm forward and as many
backward, each a pass over the activations; a MinkUNet18D step has 48
norms.  The function (``sparse/nn.py`` ``SparseBatchNorm``, over the rows
of ``feats [B, N, C]`` where ``valid [B, N]``):

    train: n = max(#valid, 1), mean = sum_valid x / n,
           var = sum_valid (x - mean)^2 / n   (two passes);
           the running statistics move by ``momentum`` towards mean and
           the unbiased ``var * n / max(n - 1, 1)``
    eval:  mean, var = the running statistics
    y = where(valid, dtype(((x - mean) * rsqrt(var + eps)) * w + b), 0)
    y = y + residual (if given); y = relu(y) (if ``relu``)

in f32 math, ``y`` in the features' dtype.  The kernels are bound by
bytes: train forward is three passes over ``x`` (the sums and count, the
squared deviations, the apply) and one write of ``y``; backward reads
``dy``, ``x`` and ``y`` twice (the two per-channel sums ``sum g`` and
``sum g * x^``, then ``dx``) and writes ``dx`` and the residual's gradient.
Nothing else is saved or written: the backward keeps ``x``, ``y`` (for the
ReLU mask ``y > 0``) and the per-channel ``mean``, ``rstd`` and ``n``.
The reductions sum per row block, then the last block of each channel
chunk sums the partials in fixed order (no float atomics, no host sync:
two calls give the same bits).  In a data-parallel step the statistics and
the backward's sums are all-reduced between the passes
(``parallel.mesh.global_sum``), so every rank normalises, and computes
``dx``, with the global batch's numbers; ``dgamma`` / ``dbeta`` stay the
rank's own share, summed later by ``sync_gradients`` as every parameter
gradient is.

CPU tensors take :func:`batch_norm_plain`, the eager expression itself;
CUDA tensors launch the kernels (f32 or bf16 features, f32 parameters and
statistics) or raise.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..parallel.mesh import global_count, global_sum
from ..tracing import LaunchCounter
from .build import I, KernelLibrary, P, ptr, stream_ptr

F = ctypes.c_float
_GEOMETRY = (I, I, I, I, I, I)  # vec, tx, ty, chunks, blocks, rows_per_part


def _functions(suffix):
    return {
        f"mrcc_norm_sum_{suffix}": (P, P, P, P, P, P, I, I, *_GEOMETRY, P),
        f"mrcc_norm_var_{suffix}": (P, P, P, P, P, P, I, I, *_GEOMETRY, P),
        f"mrcc_norm_apply_{suffix}": (P, P, P, P, P, P, P, P, P, P, P, I, I,
                                      *_GEOMETRY, F, F, I, P),
        f"mrcc_norm_grad_sums_{suffix}": (P, P, P, P, P, P, P, P, I, I,
                                          *_GEOMETRY, P),
        f"mrcc_norm_grad_{suffix}": (P, P, P, P, P, P, P, P, P, I, I,
                                     *_GEOMETRY, P),
    }


LIB = KernelLibrary("norm", {**_functions("f32"), **_functions("bf16")})
NORM_SUM = LaunchCounter("norm_sum")      # train: sums and count
NORM_VAR = LaunchCounter("norm_var")      # train: squared deviations
NORM_APPLY = LaunchCounter("norm_apply")  # every forward
NORM_GRAD_SUMS = LaunchCounter("norm_grad_sums")
NORM_GRAD = LaunchCounter("norm_grad")

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_THREADS = 256         # kThreads of csrc/norm.cu
_LANES = 32            # groups of channels a block spans at most
_REDUCE_WAVES = 4      # a reduction's blocks per multiprocessor (aim)
_APPLY_WAVES = 16      # an elementwise pass's blocks per multiprocessor (cap)
_ROWS_PER_THREAD = 4   # rows a thread takes at least

NormLayout = collections.namedtuple(
    "NormLayout", "vec tx ty chunks parts rows_per_part blocks")


@functools.lru_cache(maxsize=None)
def multiprocessors(device: torch.device) -> int:
    """The card's multiprocessor count (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def norm_layout(c: int, itemsize: int, rows: int, sms: int) -> NormLayout:
    """The kernels' layout for ``rows`` rows of ``c`` channels on a card of
    ``sms`` multiprocessors.

    ``vec`` channels a thread (one 16-byte load where C divides: 4 in f32,
    8 in bf16, else the largest power of two that divides C); the
    ``C / vec`` groups split into ``chunks`` of ``tx`` <= 32 groups (a
    block's width, grid.y); ``ty`` rows a block (a power of two, ``tx *
    ty`` <= 256).  The reductions take ``parts`` row blocks of
    ``rows_per_part`` rows a chunk, about ``_REDUCE_WAVES * sms`` blocks
    in all; the elementwise passes ``blocks`` row blocks a chunk, striding
    over the rows."""
    vec = next(v for v in (8, 4, 2, 1) if v * itemsize <= 16 and c % v == 0)
    groups = c // vec
    chunks = -(-groups // _LANES)
    tx = -(-groups // chunks)
    ty = 1 << ((_THREADS // tx).bit_length() - 1)
    per_block = ty * _ROWS_PER_THREAD
    parts = max(1, min(-(-_REDUCE_WAVES * sms // chunks),
                        -(-rows // per_block)))
    rows_per_part = max(1, -(-rows // parts))
    parts = max(1, -(-rows // rows_per_part))
    blocks = max(1, min(-(-_APPLY_WAVES * sms // chunks),
                         -(-rows // per_block)))
    return NormLayout(vec, tx, ty, chunks, parts, rows_per_part, blocks)


# ------------------------------------------------------------ plain twins

def batch_norm_plain(feats, valid, weight, bias, running_mean, running_var, *,
                     training, momentum, eps, relu=False, residual=None):
    """Plain twin of :func:`batch_norm`: the masked norm in f32 math, cast
    back to the features' dtype, then ``+ residual`` and ``relu``, as
    separate eager operations in the eager expression's order
    (differentiable by autograd).  In train mode it moves the running
    statistics in place."""
    f = feats.float()
    if training:
        v = valid[..., None].float()
        n = torch.clamp_min(global_count(v.sum()), 1.0)
        mean = global_sum((f * v).sum(dim=(0, 1))) / n
        var = global_sum((((f - mean) ** 2) * v).sum(dim=(0, 1))) / n
        with torch.no_grad():
            unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
            running_mean.copy_((1 - momentum) * running_mean
                               + momentum * mean)
            running_var.copy_((1 - momentum) * running_var
                              + momentum * unbiased)
    else:
        mean, var = running_mean, running_var
    out = (f - mean) * torch.rsqrt(var + eps) * weight + bias
    out = torch.where(valid[..., None], out.to(feats.dtype), 0.0)
    if residual is not None:
        out = out + residual
    if relu:
        out = torch.relu(out)
    return out


def batch_norm_grad_plain(dy, feats, out, valid, weight, save, *, training):
    """Plain twin of the backward kernels, the hand-derived gradient:
    ``(dx, dgamma, dbeta, dres)``.

    ``out``: the forward's output where it ended in a ReLU (its mask is
    ``out > 0``), else None; ``save``: ``[mean (C), rstd (C), n]`` in the
    math dtype (f32, or float64).  With ``g = dy * [out > 0]``:
    ``dbeta = sum_valid g``, ``dgamma = sum_valid g * x^``, ``x^ = (x -
    mean) * rstd``; train ``dx = w * rstd * (g - dbeta / n - x^ * dgamma /
    n)`` on valid rows (eval ``w * rstd * g``), 0 on padding rows; ``dres
    = g`` on every row (the residual's gradient).  Single process: the
    card path all-reduces the sums for ``dx`` in a data-parallel step."""
    c = feats.shape[-1]
    math = save.dtype
    mean, rstd, n = save[:c], save[c:2 * c], save[2 * c]
    g = dy.to(math)
    if out is not None:
        g = torch.where(out > 0, g, 0.0)
    dres = g.to(dy.dtype)
    v = valid[..., None]
    gv = torch.where(v, g, 0.0)
    xh = (feats.to(math) - mean) * rstd
    dbeta = gv.sum(dim=(0, 1))
    dgamma = (gv * xh).sum(dim=(0, 1))
    a = weight.to(math) * rstd
    d = a * (g - dbeta / n - xh * (dgamma / n)) if training else a * g
    dx = torch.where(v, d, 0.0).to(feats.dtype)
    return dx, dgamma, dbeta, dres


# --------------------------------------------------------------- kernels

def _geometry(lay, blocks):
    return (lay.vec, lay.tx, lay.ty, lay.chunks, blocks, lay.rows_per_part)


def _scratch(lay, c, head, quantities, device):
    """One f32 allocation: ``head`` floats, then the reductions' partials
    ``[quantities, parts, cpad]``, the part counts and the tickets
    (int32)."""
    cpad = lay.chunks * lay.tx * lay.vec
    size = quantities * lay.parts * cpad
    ws = torch.empty(head + size + lay.parts + lay.chunks,
                     dtype=torch.float32, device=device)
    part = ws[head:head + size]
    counts = ws[head + size:head + size + lay.parts].view(torch.int32)
    tickets = ws[head + size + lay.parts:].view(torch.int32)
    return ws, part, counts, tickets


def _forward(feats, valid, weight, bias, running_mean, running_var, training,
             momentum, eps, relu, residual):
    """The forward kernels: ``(y, save)``, save ``[mean, rstd, n]`` f32."""
    b, n, c = feats.shape
    rows = b * n
    lay = norm_layout(c, feats.element_size(), rows,
                      multiprocessors(feats.device))
    sfx = _SUFFIX[feats.dtype]
    stream = stream_ptr(feats)
    out = torch.empty_like(feats)
    save = torch.empty(2 * c + 1, dtype=torch.float32, device=feats.device)
    stats1 = stats2 = None
    if training:
        ws, part, counts, tickets = _scratch(lay, c, 2 * c + 1, 1,
                                             feats.device)
        stats1, stats2 = ws[:c + 1], ws[c + 1:2 * c + 1]
        LIB.call(f"mrcc_norm_sum_{sfx}", ptr(feats), ptr(valid), ptr(part),
                 ptr(counts), ptr(tickets), ptr(stats1), rows, c,
                 *_geometry(lay, lay.parts), stream)
        NORM_SUM.launches += 1
        stats1 = global_sum(stats1)
        LIB.call(f"mrcc_norm_var_{sfx}", ptr(feats), ptr(valid), ptr(stats1),
                 ptr(part), ptr(tickets), ptr(stats2), rows, c,
                 *_geometry(lay, lay.parts), stream)
        NORM_VAR.launches += 1
        stats2 = global_sum(stats2)
    LIB.call(f"mrcc_norm_apply_{sfx}", ptr(feats), ptr(valid), ptr(residual),
             ptr(weight), ptr(bias), ptr(stats1), ptr(stats2),
             ptr(running_mean), ptr(running_var), ptr(out), ptr(save), rows,
             c, *_geometry(lay, lay.blocks), eps, momentum, int(relu), stream)
    NORM_APPLY.launches += 1
    return out, save


def _backward(dy, feats, out, valid, weight, save, training, need_sums,
              need_dx, need_dres):
    """The backward kernels: ``(dx, dgamma, dbeta, dres)``, None where not
    asked for."""
    b, n, c = feats.shape
    rows = b * n
    lay = norm_layout(c, feats.element_size(), rows,
                      multiprocessors(feats.device))
    sfx = _SUFFIX[feats.dtype]
    stream = stream_ptr(feats)
    dy = dy.contiguous()
    dx = dres = dgamma = dbeta = gsum = None
    if need_sums or (training and need_dx):
        ws, part, _, tickets = _scratch(lay, c, 2 * c, 2, feats.device)
        gsum = ws[:2 * c]
        LIB.call(f"mrcc_norm_grad_sums_{sfx}", ptr(dy), ptr(feats), ptr(out),
                 ptr(valid), ptr(save), ptr(part), ptr(tickets), ptr(gsum),
                 rows, c, *_geometry(lay, lay.parts), stream)
        NORM_GRAD_SUMS.launches += 1
        dbeta, dgamma = gsum[:c], gsum[c:]
    if need_dx or need_dres:
        dx = torch.empty_like(feats)
        dres = torch.empty_like(feats) if need_dres else None
        gs = (global_sum(gsum) if training and gsum is not None
              else None)
        LIB.call(f"mrcc_norm_grad_{sfx}", ptr(dy), ptr(feats), ptr(out),
                 ptr(valid), ptr(weight), ptr(save), ptr(gs), ptr(dx),
                 ptr(dres), rows, c, *_geometry(lay, lay.blocks), stream)
        NORM_GRAD.launches += 1
    return dx, dgamma, dbeta, dres


class BatchNormFn(torch.autograd.Function):
    """:func:`batch_norm` on the card with its hand-written backward.
    ``apply(feats, valid, weight, bias, residual, running_mean,
    running_var, training, momentum, eps, relu)``."""

    @staticmethod
    def forward(ctx, feats, valid, weight, bias, residual, running_mean,
                running_var, training, momentum, eps, relu):
        out, save = _forward(feats, valid, weight, bias, running_mean,
                             running_var, training, momentum, eps, relu,
                             residual)
        ctx.save_for_backward(feats, out if relu else None, valid, weight,
                              save)
        ctx.training = training
        return out

    @staticmethod
    def backward(ctx, dy):
        feats, out, valid, weight, save = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dgamma, dbeta, dres = _backward(
            dy, feats, out, valid, weight, save, ctx.training,
            need_sums=need[2] or need[3], need_dx=need[0], need_dres=need[4])
        return (dx if need[0] else None, None,
                dgamma if need[2] else None, dbeta if need[3] else None,
                dres, None, None, None, None, None, None)


def _check(feats, valid, residual, params):
    if feats.dtype not in _SUFFIX:
        raise ValueError(f"batch_norm: feats dtype {feats.dtype} not in "
                         "(float32, bfloat16)")
    if feats.dim() != 3 or feats.shape[-1] < 1:
        raise ValueError(f"batch_norm: feats {tuple(feats.shape)}, need "
                         "[B, N, C >= 1]")
    if valid.dtype != torch.bool or valid.shape != feats.shape[:2]:
        raise ValueError(f"batch_norm: valid {valid.dtype} "
                         f"{tuple(valid.shape)}, need bool [B, N]")
    if residual is not None and (residual.dtype != feats.dtype
                                 or residual.shape != feats.shape):
        raise ValueError(f"batch_norm: residual {residual.dtype} "
                         f"{tuple(residual.shape)} != feats {feats.dtype} "
                         f"{tuple(feats.shape)}")
    for t in params:
        if t.dtype != torch.float32 or t.shape != (feats.shape[-1],) \
                or not t.is_contiguous():
            raise ValueError(f"batch_norm: parameter or statistic {t.dtype} "
                             f"{tuple(t.shape)}, need contiguous float32 [C]")
    tensors = (feats, valid, *params) + (() if residual is None
                                         else (residual,))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"batch_norm: inputs on several devices {devices}")


def batch_norm(feats, valid, weight, bias, running_mean, running_var, *,
               training, momentum, eps, relu=False, residual=None):
    """Masked batch norm over the valid rows of the whole batch, then
    ``+ residual`` and ``relu`` where asked (see the module docstring).

    Args:
      feats: [B, N, C] (f32 or bf16 on the card); valid: bool [B, N].
      weight, bias, running_mean, running_var: f32 [C] (the running
        statistics move in place in train mode).
      training: batch statistics (True) or the running ones.
      relu, residual: [B, N, C] like ``feats``, added after the norm, then
        the ReLU.
    Returns [B, N, C] in the features' dtype.  CPU tensors run
    :func:`batch_norm_plain`; CUDA tensors the kernels, under autograd
    through :class:`BatchNormFn`.
    """
    kwargs = dict(training=training, momentum=momentum, eps=eps, relu=relu,
                  residual=residual)
    if feats.device.type == "cpu":
        return batch_norm_plain(feats, valid, weight, bias, running_mean,
                                running_var, **kwargs)
    if feats.device.type != "cuda":
        raise ValueError(f"batch_norm: unsupported device {feats.device}")
    params = (weight, bias, running_mean, running_var)
    _check(feats, valid, residual, params)
    feats, valid = feats.contiguous(), valid.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    args = (feats, valid, weight, bias, residual, running_mean, running_var,
            training, momentum, eps, relu)
    grads = (feats, weight, bias) + (() if residual is None else (residual,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        return BatchNormFn.apply(*args)
    with torch.no_grad():
        return _forward(feats, valid, weight, bias, running_mean,
                        running_var, training, momentum, eps, relu,
                        residual)[0]
