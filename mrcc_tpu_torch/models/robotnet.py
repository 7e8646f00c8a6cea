"""RobotNet heads on the MinkUNet backbone (port of
``mrcc_tpu/models/robotnet.py``: RobotNetSegmentation and RobotNetEncode).

The backbone's modules sit at the top level of each head, as in the
reference state dict (``conv0p1s1.kernel``, ``regression.0.linear.weight``,
``output_layer.0.bn.weight``, ``pose_regression.0.weight``).  Dense layers
compute in f32 like flax's ``nn.Dense`` over f32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..sparse import conv as C
from ..sparse.nn import SparseBatchNorm, SparseLinear
from .minkunet import MinkUNetBase, variant


def _finalize_pose_output(out, rot_dims: int = 4):
    """Eval-time head postprocessing (robotnet.py:79-83): sigmoid on the
    confidence channels, L2-normalised quaternion."""
    pose_w = 3 + rot_dims
    if out.shape[-1] > pose_w:
        out = torch.cat([out[..., :pose_w], torch.sigmoid(out[..., pose_w:])],
                        dim=-1)
    r = out[..., 3:pose_w]
    if rot_dims == 4:
        r = r / torch.clamp_min(torch.linalg.vector_norm(r, dim=-1,
                                                         keepdim=True), 1e-12)
    return torch.cat([out[..., :3], r, out[..., pose_w:]], dim=-1)


class RobotNetSegmentation(MinkUNetBase):
    """Per-voxel class logits: U-Net (out 256, bias) -> LeakyReLU ->
    Linear 256->1024 -> LeakyReLU -> Linear 1024->num_classes."""

    def __init__(self, backbone: str = "minkunet", in_channels: int = 3,
                 num_classes: int = 3, unet_out_channels: int = 256):
        super().__init__(in_channels, unet_out_channels, **variant(backbone))
        self.regression = nn.ModuleList([
            SparseLinear(unet_out_channels, 1024), nn.LeakyReLU(0.01),
            SparseLinear(1024, num_classes)])

    def forward(self, feats, levels):
        valid = levels[0].valid
        out = F.leaky_relu(super().forward(feats, levels), 0.01)
        out = F.leaky_relu(self.regression[0](out, valid), 0.01)
        return self.regression[2](out, valid)


class RobotNetEncode(MinkUNetBase):
    """Encoder-only pose regression: stride-16 features -> BN + ReLU ->
    global average pool -> MLP(2048) -> [x, y, z, qw, qx, qy, qz(, conf)]."""

    def __init__(self, backbone: str = "minkunet", in_channels: int = 3,
                 out_channels: int = 7, rot_dims: int = 4):
        cfg = variant(backbone)
        super().__init__(in_channels, out_channels, encoder_only=True, **cfg)
        width = self.inplanes
        self.rot_dims = rot_dims
        self.output_layer = nn.ModuleList([SparseBatchNorm(width), nn.ReLU()])
        self.pose_regression = nn.ModuleList([
            nn.Linear(width, 2048), nn.LeakyReLU(0.01),
            nn.Linear(2048, out_channels)])

    def forward(self, feats, levels):
        valid = levels[4].valid
        out = torch.relu(self.output_layer[0](self.encode(feats, levels),
                                              valid))
        pooled = C.global_avg_pool(out, valid).float()
        h = F.leaky_relu(self.pose_regression[0](pooled), 0.01)
        return _finalize_pose_output(self.pose_regression[2](h),
                                     rot_dims=self.rot_dims)
