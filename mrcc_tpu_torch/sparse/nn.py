"""``nn.Module`` layers over the sparse core (port of
``mrcc_tpu/sparse/nn.py``).

Parameter names follow the reference's state dict (MinkowskiEngine
layers): convolutions hold ``kernel [K, Cin, Cout]`` (and ``bias``),
batch norms nest ``bn.{weight, bias, running_mean, running_var}``, linear
layers nest ``linear.{weight, bias}``.  Levels from
``sparse.hierarchy.build_hierarchy`` travel beside the features.

The k3, down and transpose convs can run in int8 (``q8``, set by the
engine per stage) and carry the calibrated activation absmax of the JAX
package's ``q8_stats`` collection (``mrcc_tpu/sparse/nn.py::
_q8_calibration``) as the buffer ``act_absmax``: absent (``None``, so
``state_dict()`` omits it) until a calibration pass records it.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import batch_norm
from ..parallel.mesh import global_rows
from . import conv as C


class _KernelConv(nn.Module):
    """Shared parameters of the sparse convolutions."""

    taps = 1

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(self.taps, in_channels,
                                               out_channels))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal, fan-out mode (ME ``kaiming_normal_``): std
        sqrt(2 / Cout)."""
        std = math.sqrt(2.0 / self.kernel.shape[-1])
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape,
                                          generator=generator) * std)
            if self.bias is not None:
                self.bias.zero_()


class _QuantConv(_KernelConv):
    """A conv with an int8 route.  ``q8``: quantise (the engine sets it).
    ``calibrating``: record the running max of ``|x|`` over all but the
    channel axis into ``act_absmax`` while the conv itself quantises with
    the dynamic absmax, as a JAX apply with ``mutable=["q8_stats"]`` does."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = False):
        super().__init__(in_channels, out_channels, bias)
        self.q8 = False
        self.calibrating = False
        self.register_buffer("act_absmax", None)

    def _q8_args(self, feats):
        if not self.calibrating:
            return dict(q8=self.q8, act_absmax=self.act_absmax)
        with torch.no_grad():
            cur = feats.float().abs().amax(dim=tuple(range(feats.dim() - 1)))
            self.act_absmax = (cur if self.act_absmax is None
                               else torch.maximum(self.act_absmax, cur))
        return dict(q8=self.q8, act_absmax=None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a calibrated state dict gives an uncalibrated module its buffer
        saved = state_dict.get(prefix + "act_absmax")
        if saved is not None and self.act_absmax is None:
            self.act_absmax = torch.empty_like(saved,
                                               device=self.kernel.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class SparseConvK3(_QuantConv):
    """k=3 s=1 sparse conv on one level."""

    taps = 27

    def forward(self, feats, level):
        return C.conv_k3(feats, self.kernel, level, bias=self.bias,
                         **self._q8_args(feats))


class SparseConv1x1(_KernelConv):
    """k=1 sparse conv (pointwise matmul)."""

    def forward(self, feats, valid):
        return C.conv1x1(feats, self.kernel, valid, bias=self.bias)


class SparseConvDown(_QuantConv):
    """k=2 s=2 strided sparse conv: fine level -> coarse level."""

    taps = 8

    def forward(self, feats, fine_level, coarse_level):
        return C.conv_down(feats, self.kernel, fine_level, coarse_level,
                           bias=self.bias, **self._q8_args(feats))


class SparseConvTranspose(_QuantConv):
    """k=2 s=2 transpose conv: coarse level -> cached fine level."""

    taps = 8

    def forward(self, feats, coarse_level, fine_level):
        return C.conv_transpose_up(feats, self.kernel, coarse_level,
                                   fine_level, bias=self.bias,
                                   **self._q8_args(feats))


def q8_convs(module: nn.Module):
    """``(name, conv)`` of every conv of ``module`` with an int8 route."""
    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, _QuantConv)]


def set_q8(module: nn.Module, on: bool) -> nn.Module:
    """Route every k3 / down / transpose conv of ``module`` to int8 or not."""
    for _, m in q8_convs(module):
        m.q8 = on
    return module


@contextlib.contextmanager
def q8_calibration(module: nn.Module):
    """Calibration mode for every int8-capable conv of ``module``: each
    records its input absmax (and keeps the maximum over passes)."""
    convs = [m for _, m in q8_convs(module)]
    for m in convs:
        m.calibrating = True
    try:
        yield module
    finally:
        for m in convs:
            m.calibrating = False


class _BatchNormState(nn.Module):
    """``nn.BatchNorm1d``'s tensors under the reference's names."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class SparseBatchNorm(nn.Module):
    """Masked BatchNorm over the valid voxels of the whole batch, f32 math,
    cast back to the feature dtype, padding rows zeroed (eps 1e-5).

    ``self.training`` picks the statistics, as ``train=`` does in JAX: in
    train mode the batch mean and biased variance normalise, and the running
    statistics move by momentum 0.1 towards the mean and the *unbiased*
    variance ``var * n / max(n - 1, 1)`` (torch BN semantics); in eval mode
    the running statistics normalise.  In a data-parallel step the counts
    and both passes' sums run over every rank's rows (``parallel.mesh``)."""

    momentum = 0.1

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.bn = _BatchNormState(channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bn.weight.fill_(1.0)
            self.bn.bias.zero_()
            self.bn.running_mean.zero_()
            self.bn.running_var.fill_(1.0)

    def forward(self, feats, valid, relu=False, residual=None):
        """The norm of ``feats`` [B, N, C], then ``+ residual`` and ``relu``
        where asked (``ops.norm.batch_norm``: on the card one hand-written
        kernel chain, forward and backward; on the CPU the eager
        expression)."""
        bn = self.bn
        return batch_norm(feats, valid, bn.weight, bn.bias, bn.running_mean,
                          bn.running_var, training=self.training,
                          momentum=self.momentum, eps=self.eps, relu=relu,
                          residual=residual)


class SparseInstanceNorm(nn.Module):
    """Per-item masked instance norm (ME ``MinkowskiInstanceNorm``, eps
    1e-5), affine ``scale`` / ``bias``.  Unlike :class:`SparseBatchNorm`
    the statistics are computed in the *feature* dtype, as the JAX module
    does (sums accumulate in f32 and round to it, as ``jnp.sum``); the
    affine step promotes to the parameters' dtype (f32 parameters turn a
    bf16 input into an f32 output, as in JAX)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, feats, valid):
        dtype = feats.dtype
        v = valid[..., None].to(dtype)

        def masked_sum(x):
            return x.float().sum(dim=1, keepdim=True).to(dtype)

        n = torch.clamp_min(masked_sum(v), 1.0)
        mean = masked_sum(feats * v) / n
        var = masked_sum(((feats - mean) ** 2) * v) / n
        out = (feats - mean) * torch.rsqrt(var + self.eps)
        out = out * self.scale + self.bias
        return torch.where(valid[..., None], out, 0.0)


class SparseDropout(nn.Module):
    """Voxel-feature dropout (ME ``MinkowskiDropout``, flax ``nn.Dropout``):
    identity in eval mode; in train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``.  The mask
    comes from an explicit ``torch.Generator`` on the features' device,
    seeded with ``seed`` at its first use there.  In a data-parallel step
    the mask is drawn over the global batch and each rank keeps its rows,
    so the ranks drop what one process would."""

    def __init__(self, rate: float = 0.5, seed: int = 0):
        super().__init__()
        self.rate = rate
        self.seed = seed
        self._generator = None

    def forward(self, feats):
        if not self.training or self.rate == 0.0:
            return feats
        if self.rate >= 1.0:
            return torch.zeros_like(feats)
        gen = self._generator
        if gen is None or gen.device != feats.device:
            gen = self._generator = torch.Generator(
                device=feats.device).manual_seed(self.seed)
        keep_prob = 1.0 - self.rate
        shape, rows = global_rows(feats.shape)
        keep = torch.rand(shape, generator=gen,
                          device=feats.device)[rows] < keep_prob
        return torch.where(keep, feats / keep_prob, 0.0)


def gelu(feats):
    """GELU with the tanh approximation: ``jax.nn.gelu``'s default (torch's
    own default is the erf form)."""
    return F.gelu(feats, approximate="tanh")


class SparseLinear(nn.Module):
    """Per-voxel dense layer (ME ``MinkowskiLinear``).  Like flax's
    ``nn.Dense``, it computes and returns its parameters' dtype (f32 for a
    bf16 input)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)

    def forward(self, feats, valid):
        out = self.linear(feats.to(self.linear.weight.dtype))
        return torch.where(valid[..., None], out, 0.0)


def reset_linear(linear: nn.Linear, generator: torch.Generator) -> None:
    """LeCun-normal weight (std sqrt(1 / fan_in)), zero bias (where it has
    one) — flax's Dense default."""
    std = math.sqrt(1.0 / linear.in_features)
    with torch.no_grad():
        linear.weight.copy_(torch.randn(linear.weight.shape,
                                        generator=generator) * std)
        if linear.bias is not None:
            linear.bias.zero_()


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Random weights for every sparse layer of ``module`` from one seeded
    CPU ``torch.Generator`` (module order), then the norms at identity.  A
    module's raw kernels (the names in its ``raw_kernels``, [K, Cin, Cout]
    parameters outside a conv module) take the convs' He-normal fan-out
    draw."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        for name in getattr(m, "raw_kernels", ()):
            kernel = getattr(m, name)
            with torch.no_grad():
                kernel.copy_(torch.randn(kernel.shape, generator=gen)
                             * math.sqrt(2.0 / kernel.shape[-1]))
        if isinstance(m, (_KernelConv, SparseBatchNorm, SparseInstanceNorm)):
            m.reset_parameters(gen)
        elif isinstance(m, nn.Linear):
            reset_linear(m, gen)
    return module
