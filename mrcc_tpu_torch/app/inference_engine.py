"""InferenceEngine, batched main path (port of
``mrcc_tpu/app/inference_engine.py``: ``InferenceConfig``,
``_seg_stage``, ``_pose_stage``, the sparse ``_kp_stage``, ``_icp_stage``
and ``predict_batch_arrays``).

Stages run eagerly in the JAX engine's order: colour normalisation ->
voxelize -> hierarchy -> RobotNetSegmentation -> slice to points ->
largest cluster -> EE crop -> RobotNetEncode rotation + magic translation
-> sparse keypoint net + Kabsch -> 2x ICP.  Every key sort and sparse conv
on a CUDA device runs the hand-written kernels (``ops/``).

The engine runs on the card: ``device=None`` means ``"cuda"`` and raises
when no card is present.  Pass ``device="cpu"`` explicitly for the plain
twins.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from ..device import resolve_device
from ..geometry.preprocess import center_at_origin, normalize_colors
from ..interop import load_jax_variables
from ..models import RobotNetEncode, RobotNetSegmentation
from ..solve import (default_template, icp_refine, key_point_predictions,
                     largest_cluster_mask, pose_from_key_points,
                     predict_translation)
from ..sparse import (build_hierarchy, hierarchy_caps, slice_to_points,
                      voxelize)
from ..sparse.nn import init_parameters


@dataclasses.dataclass
class InferenceConfig:
    """The JAX engine's configuration, restricted to what this port runs;
    the options of later slices raise ``NotImplementedError`` when set."""

    point_capacity: int = 32768
    seg_voxel_capacity: int = 16384
    ee_point_capacity: int = 8192
    ee_voxel_capacity: int = 4096
    kp_voxel_capacity: int = 8192
    seg_hierarchy_caps: typing.Optional[typing.Tuple[int, ...]] = None
    ee_hierarchy_caps: typing.Optional[typing.Tuple[int, ...]] = None
    kp_hierarchy_caps: typing.Optional[typing.Tuple[int, ...]] = None

    seg_backbone: str = "minkunet18"
    seg_scale: float = 200.0
    seg_center_at_origin: bool = True
    num_classes: int = 3

    rot_backbone: str = "minkunet"
    rot_scale: float = 200.0
    rot_center_at_origin: bool = True
    compute_confidence: bool = False

    kp_backbone: str = "minkunet18"
    kp_scale: float = 800.0
    kp_center_at_origin: bool = True
    kp_conf_threshold: float = 0.75
    num_of_keypoints: int = 6

    rot_6d: bool = False
    rot_flip_disambiguation: bool = False
    translation_z_percentile: typing.Optional[float] = None
    compute_dtype: str = "bfloat16"  # conv-path compute (f32 accumulation)
    icp_enabled: bool = True
    icp_iterations: int = 30
    icp_template_points: int = 2048
    cluster_dist: float = 0.06
    cluster_capacity: typing.Optional[int] = None

    def __post_init__(self):
        later = {"compute_confidence": self.compute_confidence,
                 "rot_6d": self.rot_6d,
                 "rot_flip_disambiguation": self.rot_flip_disambiguation,
                 "translation_z_percentile":
                     self.translation_z_percentile is not None,
                 "kp_backbone=pointnet2": self.kp_backbone == "pointnet2"}
        on = [k for k, v in later.items() if v]
        if on:
            raise NotImplementedError(f"not ported yet: {', '.join(on)}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: float32 or bfloat16")


def cluster_capacity(cfg: InferenceConfig) -> int:
    """Exact-cluster capacity: explicit, else scaled to the EE crop."""
    if cfg.cluster_capacity is not None:
        return cfg.cluster_capacity
    return max(4096, cfg.ee_point_capacity)


def _hierarchy_caps(cap, override=None):
    if override is not None:
        if len(override) != 4:
            raise ValueError(f"hierarchy caps {override}: need 4")
        return tuple(override)
    return hierarchy_caps(cap)


def _take(x, order):
    """Rows of x [B, P, ...] at order [B, E]."""
    idx = order.long().reshape(order.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(order.shape + x.shape[2:]))


class InferenceEngine:
    """Batched EE pose / keypoint inference on padded point clouds."""

    def __init__(self, config: InferenceConfig = None, device=None, seed=0):
        self.cfg = config or InferenceConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.template = torch.as_tensor(
            default_template(cfg.icp_template_points), device=self.device)
        self.seg_model = RobotNetSegmentation(
            backbone=cfg.seg_backbone, in_channels=3,
            num_classes=cfg.num_classes)
        self.rot_model = RobotNetEncode(backbone=cfg.rot_backbone,
                                        in_channels=3, out_channels=7)
        self.kp_model = RobotNetSegmentation(
            backbone=cfg.kp_backbone, in_channels=3,
            num_classes=cfg.num_of_keypoints)
        for i, model in enumerate(self.models().values()):
            init_parameters(model, seed * 3 + i)
            model.to(self.device).eval()

    def models(self):
        return {"segmentation": self.seg_model, "rotation": self.rot_model,
                "key_points": self.kp_model}

    def load_jax_params(self, params):
        """Load the JAX engine's ``params`` (``{"segmentation", "rotation",
        "key_points"}`` stage variables as numpy dicts), strictly."""
        for stage, model in self.models().items():
            load_jax_variables(model, params[stage])
        return self

    def _tensor(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -------------------------------------------------------------- stages

    @torch.no_grad()
    def seg_stage(self, points, rgb, mask):
        """Segmentation + largest-cluster filter + fixed-capacity EE crop.

        Returns ``(seg, ee_count, ee_pts, ee_rgb, ee_valid, overflow)``."""
        cfg = self.cfg
        rgb = normalize_colors(rgb, mask=mask)
        seg_pts = (center_at_origin(points, mask=mask)[0]
                   if cfg.seg_center_at_origin else points)
        svox, spv = voxelize(seg_pts, rgb, mask, 1.0 / cfg.seg_scale,
                             cfg.seg_voxel_capacity)
        levels = build_hierarchy(svox, 4, capacities=_hierarchy_caps(
            cfg.seg_voxel_capacity, cfg.seg_hierarchy_caps))
        logits = self.seg_model(svox.feats.to(self.dtype), levels).float()
        pt_logits = slice_to_points(logits, spv, fill_value=-1e9)
        seg = torch.argmax(pt_logits, dim=-1).to(torch.int32)
        seg = torch.where(mask, seg, 0)

        ee_raw = (seg == 2) & mask
        cluster = largest_cluster_mask(points, ee_raw, dist=cfg.cluster_dist,
                                       capacity=cluster_capacity(cfg))
        seg = torch.where(ee_raw, 1, seg)
        seg = torch.where(ee_raw & cluster, 2, seg)
        ee_mask = (seg == 2) & mask
        ee_count = ee_mask.sum(dim=-1, dtype=torch.int32)

        order = torch.argsort((~ee_mask).to(torch.uint8), dim=-1,
                              stable=True)[:, :cfg.ee_point_capacity]
        overflow = svox.count >= cfg.seg_voxel_capacity
        return (seg, ee_count, _take(points, order), _take(rgb, order),
                ee_mask.gather(1, order), overflow)

    @torch.no_grad()
    def pose_stage(self, ee_pts, ee_rgb, ee_valid):
        """Rotation net + magic translation -> ``(pose [B, 7], conf [B, 3])``."""
        cfg = self.cfg
        rot_pts = (center_at_origin(ee_pts, mask=ee_valid)[0]
                   if cfg.rot_center_at_origin else ee_pts)
        rvox, _ = voxelize(rot_pts, ee_rgb, ee_valid, 1.0 / cfg.rot_scale,
                           cfg.ee_voxel_capacity)
        levels = build_hierarchy(rvox, 4, capacities=_hierarchy_caps(
            cfg.ee_voxel_capacity, cfg.ee_hierarchy_caps))
        rot_out = self.rot_model(rvox.feats.to(self.dtype), levels).float()
        q = rot_out[:, 3:7]
        pos, _ = predict_translation(ee_pts, ee_valid, q)
        conf = torch.ones((rot_out.shape[0], 3), dtype=torch.float32,
                          device=self.device)
        return torch.cat([pos, q], dim=-1), conf

    @torch.no_grad()
    def kp_stage(self, ee_pts, ee_rgb, ee_valid):
        """Sparse keypoint net + Kabsch ->
        ``(kp_pose, kp_ok, kp_coords, kp_found, kp_conf)``."""
        cfg = self.cfg
        kp_pts = (center_at_origin(ee_pts, mask=ee_valid)[0]
                  if cfg.kp_center_at_origin else ee_pts)
        kvox, kpv = voxelize(kp_pts, ee_rgb, ee_valid, 1.0 / cfg.kp_scale,
                             cfg.kp_voxel_capacity)
        levels = build_hierarchy(kvox, 4, capacities=_hierarchy_caps(
            cfg.kp_voxel_capacity, cfg.kp_hierarchy_caps))
        logits = self.kp_model(kvox.feats.to(self.dtype), levels).float()
        pt_logits = slice_to_points(logits, kpv, fill_value=-1e9)
        kp_idx, kp_found, kp_conf = key_point_predictions(
            pt_logits, ee_valid, conf_threshold=cfg.kp_conf_threshold)
        kp_coords = _take(ee_pts, kp_idx)
        kp_pose, kp_ok = pose_from_key_points(kp_coords, kp_found)
        return kp_pose, kp_ok, kp_coords, kp_found, kp_conf

    @torch.no_grad()
    def icp_stage(self, ee_pts, ee_valid, ee_pose, kp_pose):
        """Both ICP refinements."""
        it = self.cfg.icp_iterations
        return (icp_refine(self.template, ee_pts, ee_valid, ee_pose,
                           iterations=it),
                icp_refine(self.template, ee_pts, ee_valid, kp_pose,
                           iterations=it))

    # -------------------------------------------------------------- public

    @torch.no_grad()
    def predict_batch_arrays(self, points, rgb, mask):
        """Batched prediction on padded arrays ``[B, P, 3]``, ``[B, P, 3]``,
        ``[B, P]`` (numpy or tensors); returns a dict of tensors on the
        engine's device."""
        points = self._tensor(points, torch.float32)
        rgb = self._tensor(rgb, torch.float32)
        mask = self._tensor(mask, torch.bool)
        seg, ee_count, ee_pts, ee_rgb, ee_valid, seg_overflow = \
            self.seg_stage(points, rgb, mask)
        ee_pose, rot_conf = self.pose_stage(ee_pts, ee_rgb, ee_valid)
        kp_pose, kp_ok, kp_coords, kp_found, kp_conf = self.kp_stage(
            ee_pts, ee_rgb, ee_valid)
        if self.cfg.icp_enabled:
            ee_pose, kp_pose = self.icp_stage(ee_pts, ee_valid, ee_pose,
                                              kp_pose)
        return {
            "segmentation": seg,
            "seg_overflow": seg_overflow,
            "ee_count": ee_count,
            "ee_pose": ee_pose,
            "rot_conf": rot_conf,
            "kp_pose": kp_pose,
            "kp_ok": kp_ok,
            "kp_coords": kp_coords,
            "kp_found": kp_found,
            "kp_conf": kp_conf,
        }


def _round_up(x, m):
    return int(-(-x // m) * m)


@torch.no_grad()
def measure_seg_caps(points, rgb, mask, scale=200.0, headroom=1.1,
                     device=None):
    """Occupancy probe: voxelize and downsample (no k3 bitmaps) at the point
    capacity, return per-level capacities from the largest item's counts,
    times ``headroom``, rounded up to 256 (the rule of the JAX package's
    ``bench.py::measure_seg_caps``)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    feats = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    m = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    n = pts.shape[1]
    c, _ = center_at_origin(pts, mask=m)
    vox, _ = voxelize(c, feats, m, 1.0 / scale, n)
    levels = build_hierarchy(vox, 4, capacities=(n, n, n, n), build_k3=False)
    counts = [int(lv.valid.sum(dim=1).max()) for lv in levels]
    return tuple(max(_round_up(c * headroom, 256), 256) for c in counts)
