"""PointNet / PointNet++ dense models (port of
``mrcc_tpu/models/pointnet2.py``), channel-last ``[B, N, C]``.

- ``PointNet2SSG`` (``model/pointnet2.py:9-43``): 4 set abstractions
  (1024 / 256 / 64 / 16 centroids, radii 0.1-0.8, 32 samples) and 4
  feature propagations -> per-point logits ``[B, N, K]`` and ``l4``.
- ``PointNet2MSGEncoder`` (``model/pointnet2.py:46-77``): the multi-scale
  grouping encoder.
- ``PointNet`` (``model/pointnet.py:8-36``): 1x1 layers, a global max and
  an MLP head (the keypoint-to-pose regressor).

The caller samples exactly N points.  Layers keep the JAX module names, so
``interop.load_jax_variables`` maps them one to one: dense layers are
``nn.Linear`` (flax ``kernel [in, out]`` is ``weight [out, in]``), and the
norms hold their tensors under ``.bn.``.  The norms follow flax's
``nn.BatchNorm``, not the sparse models' torch semantics (ROADMAP C30):
see :class:`PointBatchNorm`.  Dropout draws a fresh mask each train-mode
call from its own seeded ``torch.Generator`` (the JAX dense train steps
reuse one key every step, ROADMAP C28).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.points import (farthest_point_sample, index_points,
                          query_ball_point, sample_and_group,
                          sample_and_group_all, three_nn_interpolate)
from ..sparse.nn import SparseBatchNorm, SparseDropout


class PointBatchNorm(SparseBatchNorm):
    """flax ``nn.BatchNorm`` over every axis but the last (eps 1e-5).  In
    train mode the batch statistics normalise, the variance as
    ``E[x^2] - E[x]^2`` clipped at 0 (flax's ``use_fast_variance``), and
    the running statistics decay by 0.99 towards the mean and that
    *biased* variance; in eval mode the running statistics normalise.
    (``SparseBatchNorm`` keeps torch's momentum 0.1 and unbiased running
    variance; this norm takes only its tensors and their reset.)"""

    decay = 0.99

    def forward(self, x):
        bn = self.bn
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                bn.running_mean.copy_(self.decay * bn.running_mean
                                      + (1 - self.decay) * mean)
                bn.running_var.copy_(self.decay * bn.running_var
                                     + (1 - self.decay) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + self.eps) * bn.weight
        return (x - mean) * mul + bn.bias


class PointMLP(nn.Module):
    """Shared 1x1 layers (no bias) + norm + ReLU over the trailing
    channels: ``conv{i}``, ``bn{i}``."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", nn.Linear(in_channels, c, bias=False))
            self.add_module(f"bn{i}", PointBatchNorm(c))
            in_channels = c

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x))
        return x


class SetAbstraction(nn.Module):
    """(``pointnet2_utils.py:163``) FPS -> ball group -> shared MLP -> max
    over each group.  ``in_channels``: the grouped width, 3 + the input
    features'."""

    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], in_channels: int,
                 mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.mlp = PointMLP(in_channels, mlp)

    def forward(self, xyz, points):
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
        else:
            new_xyz, grouped = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points)
        return new_xyz, self.mlp(grouped).amax(dim=2)


class SetAbstractionMsg(nn.Module):
    """(``pointnet2_utils.py:205``) one FPS, a ball group and MLP per
    radius (``mlp{i}``), the scales' maxima concatenated."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], in_channels: int,
                 mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", PointMLP(in_channels, mlp))
        self.out_channels = sum(m[-1] for m in mlps)

    def forward(self, xyz, points):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        outs = []
        for i, (r, k) in enumerate(zip(self.radii, self.nsamples)):
            idx = query_ball_point(r, k, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([grouped, index_points(points, idx)], -1)
            outs.append(getattr(self, f"mlp{i}")(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """(``pointnet2_utils.py:267``) 3-NN interpolation of the coarse
    features (a broadcast from one coarse point), the fine level's
    features in front, then the MLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = PointMLP(in_channels, mlp)

    def forward(self, xyz_fine, xyz_coarse, feats_fine, feats_coarse):
        if xyz_coarse.shape[1] == 1:
            interp = feats_coarse.expand(xyz_fine.shape[0], xyz_fine.shape[1],
                                         feats_coarse.shape[-1])
        else:
            interp = three_nn_interpolate(xyz_fine, xyz_coarse, feats_coarse)
        if feats_fine is not None:
            interp = torch.cat([feats_fine, interp], dim=-1)
        return self.mlp(interp)


class PointNet2SSG(nn.Module):
    """Per-point keypoint logits (``model/pointnet2.py:9``):
    ``forward(x [B, N, 3 + in_channels])`` with xyz first ->
    ``(logits [B, N, num_classes], l4 [B, 16, 512])``.  SA1 groups xyz with
    the whole input, so its width is 3 + 3 + ``in_channels``."""

    jax_unet = False

    def __init__(self, num_classes: int = 10, in_channels: int = 3,
                 dropout_seed: int = 0):
        super().__init__()
        self.sa1 = SetAbstraction(1024, 0.1, 32, 3 + 3 + in_channels,
                                  (32, 32, 64))
        self.sa2 = SetAbstraction(256, 0.2, 32, 3 + 64, (64, 64, 128))
        self.sa3 = SetAbstraction(64, 0.4, 32, 3 + 128, (128, 128, 256))
        self.sa4 = SetAbstraction(16, 0.8, 32, 3 + 256, (256, 256, 512))
        self.fp4 = FeaturePropagation(256 + 512, (256, 256))
        self.fp3 = FeaturePropagation(128 + 256, (256, 256))
        self.fp2 = FeaturePropagation(64 + 256, (256, 128))
        self.fp1 = FeaturePropagation(128, (128, 128, 128))
        self.conv1 = nn.Linear(128, 128)
        self.bn1 = PointBatchNorm(128)
        self.drop = SparseDropout(0.5, seed=dropout_seed)
        self.conv2 = nn.Linear(128, num_classes)

    def forward(self, x):
        l0_xyz = x[..., :3]
        l1_xyz, l1 = self.sa1(l0_xyz, x)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l4_xyz, l4 = self.sa4(l3_xyz, l3)
        l3 = self.fp4(l3_xyz, l4_xyz, l3, l4)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(l0_xyz, l1_xyz, None, l1)
        h = self.drop(F.relu(self.bn1(self.conv1(l0))))
        return self.conv2(h), l4


class PointNet2MSGEncoder(nn.Module):
    """Classification-style MSG encoder (``model/pointnet2.py:46``):
    ``forward(x [B, N, 3 + C])`` -> ``(logits [B, num_classes],
    global feature [B, 1024])``; the channels past xyz are features when
    ``normal_channel`` (``in_channels`` of them)."""

    jax_unet = False

    def __init__(self, num_classes: int, normal_channel: bool = True,
                 in_channels: int = 3, dropout_seed: int = 0):
        super().__init__()
        self.normal_channel = normal_channel
        c = in_channels if normal_channel else 0
        self.sa1 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (16, 32, 128), 3 + c,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
        self.sa2 = SetAbstractionMsg(
            128, (0.2, 0.4, 0.8), (32, 64, 128), 3 + self.sa1.out_channels,
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
        self.sa3 = SetAbstraction(None, None, None,
                                  3 + self.sa2.out_channels, (256, 512, 1024),
                                  group_all=True)
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = PointBatchNorm(512)
        self.drop1 = SparseDropout(0.4, seed=dropout_seed)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = PointBatchNorm(256)
        self.drop2 = SparseDropout(0.5, seed=dropout_seed + 1)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x):
        xyz = x[..., :3]
        norm = x[..., 3:] if self.normal_channel else None
        l1_xyz, l1 = self.sa1(xyz, norm)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        _, l3 = self.sa3(l2_xyz, l2)
        g = l3[:, 0]
        h = self.drop1(F.relu(self.bn1(self.fc1(g))))
        h = self.drop2(F.relu(self.bn2(self.fc2(h))))
        return self.fc3(h), g


class PointNet(nn.Module):
    """Vanilla PointNet regressor (``model/pointnet.py:8``), the
    keypoint-to-pose head: ``forward(x [B, N, in_channels])`` ->
    ``[B, out_channels]``."""

    jax_unet = False

    def __init__(self, out_channels: int, in_channels: int = 4,
                 embedding_channel: int = 1024, dropout_seed: int = 0):
        super().__init__()
        widths = (64, 64, 64, 128, embedding_channel)
        for i, c in enumerate(widths):
            self.add_module(f"conv{i + 1}",
                            nn.Linear(in_channels, c, bias=False))
            self.add_module(f"bn{i + 1}", PointBatchNorm(c))
            in_channels = c
        self.linear1 = nn.Linear(embedding_channel, 512, bias=False)
        self.bn6 = PointBatchNorm(512)
        self.drop = SparseDropout(0.5, seed=dropout_seed)
        self.linear2 = nn.Linear(512, out_channels)

    def forward(self, x):
        for i in range(1, 6):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = x.amax(dim=1)                  # global max over the points
        x = self.drop(F.relu(self.bn6(self.linear1(x))))
        return self.linear2(x)
