"""RobotNet heads on the MinkUNet backbone (port of
``mrcc_tpu/models/robotnet.py``: RobotNet, RobotNetEncode,
RobotNetSegmentation and RobotNetVote).

The backbone's modules sit at the top level of each head, as in the
reference state dict (``conv0p1s1.kernel``, ``regression.0.linear.weight``,
``output_layer.0.bn.weight``, ``pose_regression.0.weight``).  Dense layers
compute in f32 like flax's ``nn.Dense`` over f32 parameters.  The pose
heads take ``(feats, levels, joint_angles=None)`` and follow the module's
mode as the JAX ``train`` flag: in training only the confidence sigmoid
applies; in eval the quaternion is also normalised and, for RobotNetEncode
trained with ``voxelize_position``, the position scaled back to metres.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..sparse import conv as C
from ..sparse.nn import SparseBatchNorm, SparseLinear
from ..tracing import span
from .minkunet import MinkUNetBase, variant

JOINT_ANGLES = 9  # joint angles per item in a pose batch (dataset collate)


def _finalize_pose_output(out, train: bool, quantization_size: float = 0.0,
                          rot_dims: int = 4):
    """Head postprocessing (``robotnet.py:35-55``): sigmoid on the
    confidence channels; in eval also the L2-normalised quaternion and,
    with ``quantization_size``, the position in metres."""
    pose_w = 3 + rot_dims
    if out.shape[-1] > pose_w:
        out = torch.cat([out[..., :pose_w], torch.sigmoid(out[..., pose_w:])],
                        dim=-1)
    if train:
        return out
    r = out[..., 3:pose_w]
    if rot_dims == 4:
        r = r / torch.clamp_min(torch.linalg.vector_norm(r, dim=-1,
                                                         keepdim=True), 1e-12)
    pos = out[..., :3]
    if quantization_size:
        pos = pos * quantization_size
    return torch.cat([pos, r, out[..., pose_w:]], dim=-1)


class _PoseHead(MinkUNetBase):
    """BN + ReLU over the backbone's output, a global pool, optional joint
    angles, MLP(2048) with LeakyReLU, ``out_channels`` outputs; under
    ``torch.profiler`` the head leaves a span (``mrcc.models.pose_head``)."""

    def __init__(self, backbone, in_channels, out_channels, use_joint_angles,
                 rot_dims, **unet_kw):
        super().__init__(in_channels, out_channels, **variant(backbone),
                         **unet_kw)
        width = self.inplanes
        self.use_joint_angles = use_joint_angles
        self.rot_dims = rot_dims
        # the release's output layer is BN then ReLU; the ReLU runs inside
        # the norm (``relu=True``), one pass fewer each way
        self.output_layer = nn.ModuleList([SparseBatchNorm(width)])
        self.pose_regression = nn.ModuleList([
            nn.Linear(width + (JOINT_ANGLES if use_joint_angles else 0),
                      2048),
            nn.LeakyReLU(0.01), nn.Linear(2048, out_channels)])

    @span("models.pose_head")
    def _regress(self, feats, valid, pool, joint_angles, quantization_size):
        out = self.output_layer[0](feats, valid, relu=True)
        pooled = pool(out, valid).float()
        if self.use_joint_angles:
            if joint_angles is None:
                raise ValueError("use_joint_angles needs joint_angles")
            pooled = torch.cat([pooled, joint_angles.to(pooled)], dim=-1)
        h = F.leaky_relu(self.pose_regression[0](pooled), 0.01)
        return _finalize_pose_output(self.pose_regression[2](h),
                                     self.training, quantization_size,
                                     self.rot_dims)


class RobotNet(_PoseHead):
    """7-DoF pose (10 with confidences) over the full U-Net: decoder
    output -> BN + ReLU -> global max pool -> MLP(2048)."""

    def __init__(self, backbone: str = "minkunet", in_channels: int = 3,
                 out_channels: int = 7, use_joint_angles: bool = False):
        super().__init__(backbone, in_channels, out_channels,
                         use_joint_angles, 4, with_final=False)

    def forward(self, feats, levels, joint_angles=None):
        return self._regress(self.forward_except_final(feats, levels),
                             levels[0].valid, C.global_max_pool,
                             joint_angles, 0.0)


class RobotNetEncode(_PoseHead):
    """Encoder-only pose regression: stride-16 features -> BN + ReLU ->
    global average pool -> MLP(2048) -> [x, y, z, qw, qx, qy, qz(, conf)]."""

    def __init__(self, backbone: str = "minkunet", in_channels: int = 3,
                 out_channels: int = 7, use_joint_angles: bool = False,
                 voxelize_position: bool = False,
                 quantization_size: float = 0.01, rot_dims: int = 4):
        super().__init__(backbone, in_channels, out_channels,
                         use_joint_angles, rot_dims, encoder_only=True)
        self.quantization_size = (quantization_size if voxelize_position
                                  else 0.0)

    def forward(self, feats, levels, joint_angles=None):
        return self._regress(self.encode(feats, levels), levels[4].valid,
                             C.global_avg_pool, joint_angles,
                             self.quantization_size)


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


class RobotNetVote(RobotNetSegmentation):
    """Cross-section voting head: RobotNetSegmentation's body with 2
    classes (``ee_seg`` crops) or 4 (whole scenes).  The JAX module wraps
    the segmentation net under the flax scope ``seg`` (``jax_scope``, which
    ``interop.load_jax_variables`` prepends); the state dict keeps the
    segmentation net's names."""

    jax_scope = ("seg",)

    def __init__(self, backbone: str = "minkunet", in_channels: int = 3,
                 num_classes: int = 2):
        super().__init__(backbone, in_channels, num_classes)
