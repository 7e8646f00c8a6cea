"""``nn.Module`` layers over the sparse core (port of
``mrcc_tpu/sparse/nn.py``).

Parameter names follow the reference's state dict (MinkowskiEngine
layers): convolutions hold ``kernel [K, Cin, Cout]`` (and ``bias``),
batch norms nest ``bn.{weight, bias, running_mean, running_var}``, linear
layers nest ``linear.{weight, bias}``.  Levels from
``sparse.hierarchy.build_hierarchy`` travel beside the features.
"""

from __future__ import annotations

import math

import torch
from torch import nn

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


class SparseConvK3(_KernelConv):
    """k=3 s=1 sparse conv on one level."""

    taps = 27

    def forward(self, feats, level):
        return C.conv_k3(feats, self.kernel, level, bias=self.bias)


class SparseConv1x1(_KernelConv):
    """k=1 sparse conv (pointwise matmul)."""

    def forward(self, feats, valid):
        return C.conv1x1(feats, self.kernel, valid, bias=self.bias)


class SparseConvDown(_KernelConv):
    """k=2 s=2 strided sparse conv: fine level -> coarse level."""

    taps = 8

    def forward(self, feats, fine_level, coarse_level):
        return C.conv_down(feats, self.kernel, fine_level, coarse_level,
                           bias=self.bias)


class SparseConvTranspose(_KernelConv):
    """k=2 s=2 transpose conv: coarse level -> cached fine level."""

    taps = 8

    def forward(self, feats, coarse_level, fine_level):
        return C.conv_transpose_up(feats, self.kernel, coarse_level,
                                   fine_level, bias=self.bias)


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
    the running statistics normalise."""

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

    def forward(self, feats, valid):
        bn = self.bn
        f32 = feats.float()
        if self.training:
            v = valid[..., None].float()
            n = torch.clamp_min(v.sum(), 1.0)
            mean = (f32 * v).sum(dim=(0, 1)) / n
            var = (((f32 - mean) ** 2) * v).sum(dim=(0, 1)) / n
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
                bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
                bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
        else:
            mean, var = bn.running_mean, bn.running_var
        out = (f32 - mean) * torch.rsqrt(var + self.eps) * bn.weight + bn.bias
        return torch.where(valid[..., None], out.to(feats.dtype), 0.0)


class SparseLinear(nn.Module):
    """Per-voxel dense layer (ME ``MinkowskiLinear``).  Like flax's
    ``nn.Dense`` with f32 parameters, it computes and returns f32."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)

    def forward(self, feats, valid):
        out = self.linear(feats.float())
        return torch.where(valid[..., None], out, 0.0)


def reset_linear(linear: nn.Linear, generator: torch.Generator) -> None:
    """LeCun-normal weight (std sqrt(1 / fan_in)), zero bias — flax's Dense
    default."""
    std = math.sqrt(1.0 / linear.in_features)
    with torch.no_grad():
        linear.weight.copy_(torch.randn(linear.weight.shape,
                                        generator=generator) * std)
        linear.bias.zero_()


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Random weights for every sparse layer of ``module`` from one seeded
    CPU ``torch.Generator`` (module order), then BN at identity."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (_KernelConv, SparseBatchNorm)):
            m.reset_parameters(gen)
        elif isinstance(m, nn.Linear):
            reset_linear(m, gen)
    return module
