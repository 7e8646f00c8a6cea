"""InferenceEngine (port of ``mrcc_tpu/app/inference_engine.py``): the
batched stages and ``predict_batch_arrays``, and the host entry points
``predict(PointCloudDTO)``, ``check_sanity`` and ``calibrate``.

Stages run eagerly in the JAX engine's order: colour normalisation ->
voxelize -> hierarchy -> RobotNetSegmentation -> slice to points ->
largest cluster -> EE crop -> RobotNetEncode rotation + magic translation
-> keypoint net + Kabsch -> optional flip disambiguation -> 2x ICP.  The
keypoint net is a sparse RobotNetSegmentation or, with
``kp_backbone="pointnet2"``, the dense PointNet2SSG on a fixed-size sample
of the crop (uniform or farthest-point), in f32 at full precision.
Every key sort and sparse conv on a CUDA device runs the hand-written
kernels (``ops/``).  ``predict`` pads one cloud into the batch of one,
scatters the labels back to every input point and gates the frame with
``check_sanity``; ``calibrate`` averages the confident frames' poses per
position and across positions into the camera-to-base extrinsic.

Trained weights load per stage from ``seg_checkpoint`` / ``rot_checkpoint``
/ ``kp_checkpoint``: a reference ``.pth`` state dict, a JAX package
checkpoint (msgpack ``TrainState``) or the port trainer's ``.ckpt``.

The engine runs on the card: ``device=None`` means ``"cuda"`` and raises
when no card is present.  Pass ``device="cpu"`` explicitly for the plain
twins.

With a ``mesh`` (``parallel.make_mesh`` / ``fleet.make_global_mesh``) each
rank runs every stage on its own rows of the batch, with no collective, as
the JAX engine's ``shard_map`` does: per-batch decisions such as
``normalize_colors``' 0-255 test see the rank's rows only.  Every rank
builds the same seeded weights.

int8 inference (``conv_impl="pallas-int8"``): the segmentation and
keypoint nets run their k3, down and transpose convs through the int8
kernels (``ops/conv_q8.py``), the rotation net stays on the bf16 kernels
unless ``rot_conv_impl`` asks for int8 too; a dense keypoint net has no
sparse conv and stays f32.  Each int8 stage's conv runs in int8 where the
JAX engine's does (``sparse.hierarchy.q8_route``), else in the compute
dtype: any compute dtype, level size and backbone (a bottleneck's 1x1
convs stay in the compute dtype).  ``calibrate_q8`` records each
conv's activation absmax once; without it every int8 conv quantises with
the dynamic absmax of its input.

The k3 route of every level follows the JAX engine
(``sparse.hierarchy.uses_k3_tables``): self-keyed convs where it self-keys,
else rank-kernel neighbour tables and the k3-table conv, which is where
``k3_self_keyed`` is False, where the compute dtype is f32, and on levels
over the TPU's table budget (bf16 over 20480 rows, int8 over 40960).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..data.labels import get_6_key_points
from ..device import resolve_device
from ..geometry import calibration as calib_util
from ..geometry.metrics import compute_kp_error
from ..geometry.preprocess import (center_at_origin, normalize_colors,
                                   normalize_points)
from ..geometry.transform import (base2cam_pose, rot6d_to_quat,
                                  transform_pose2pose)
from ..interop import load_jax_variables, load_weights
from ..models import PointNet2SSG, RobotNetEncode, RobotNetSegmentation
from ..ops import points
from ..ops.prng import uniform
from ..solve import (default_template, disambiguate_flip, icp_refine,
                     key_point_predictions, largest_cluster_mask,
                     pose_from_key_points, predict_translation)
from ..sparse import (build_hierarchy, hierarchy_caps, slice_to_points,
                      uses_k3_tables, voxelize)
from ..sparse.nn import init_parameters, q8_calibration, set_q8
from .dto import CalibrationResultDTO, PointCloudDTO, ResultDTO, TestResultDTO

# The JAX engine's conv_impl values: every one but "pallas-int8" means the
# port's one route (the hand-written kernels on the card).
CONV_IMPLS = ("auto", "pallas", "xla", "pallas-int8")


@dataclasses.dataclass
class InferenceConfig:
    """The JAX engine's configuration (``mrcc_tpu/app/inference_engine.py::
    InferenceConfig``); ``kp_backbone="pointnet2"`` is the dense keypoint
    path."""

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
    # the YAML's encode_only; the rotation net is RobotNetEncode either way,
    # as in the JAX engine
    rot_encode_only: bool = True
    rot_scale: float = 200.0
    rot_center_at_origin: bool = True
    # confidence heads: the rotation net emits pose + sigmoid(conf_pos,
    # conf_rot, conf); the combined one gates is_confident with the
    # geometric sanity check
    compute_confidence: bool = False
    confidence_threshold: float = 0.5

    kp_backbone: str = "minkunet18"
    kp_scale: float = 800.0
    kp_center_at_origin: bool = True
    kp_conf_threshold: float = 0.75
    num_of_keypoints: int = 6
    kp_error_margin: float = 0.05
    # dense (pointnet2) keypoint path: a fixed-size sample of the crop
    # through PointNet2SSG
    num_of_dense_input_points: int = 2048
    kp_sampling_method: str = "uniform"   # "uniform" | "farthest"
    kp_use_coordinates_as_features: bool = False

    # trained weights per stage: a reference .pth, a JAX package checkpoint
    # or the port trainer's .ckpt
    seg_checkpoint: typing.Optional[str] = None
    rot_checkpoint: typing.Optional[str] = None
    kp_checkpoint: typing.Optional[str] = None

    # the continuous 6D rotation head: [pos(3), 6d(6), conf?]
    rot_6d: bool = False
    # flip the rotation's 180-degree branch about rot_symmetry_axis where
    # the keypoint pose says so (solve/symmetry.py)
    rot_flip_disambiguation: bool = False
    rot_symmetry_axis: str = "z"
    # the p-th percentile of the rotated-frame z in place of the min
    translation_z_percentile: typing.Optional[float] = None
    # self-keyed k3 convs where the JAX engine self-keys; False: neighbour
    # tables (rank kernel + k3-table conv) on every level
    k3_self_keyed: bool = True
    compute_dtype: str = "bfloat16"  # conv-path compute (f32 accumulation)
    # "pallas-int8": int8 seg / kp convs; rotation follows rot_conv_impl
    # (None: bf16 under int8, the JAX engine's demotion)
    conv_impl: str = "auto"
    rot_conv_impl: typing.Optional[str] = None
    ee_point_counts_threshold: int = 512
    icp_enabled: bool = True
    icp_iterations: int = 30
    icp_template_points: int = 2048
    cluster_dist: float = 0.06
    cluster_capacity: typing.Optional[int] = None
    sanity_min_num_of_ee_points: int = 2048
    camera_link_transformation_pose: typing.Optional[np.ndarray] = None
    calibration_confident_count: int = 2

    def __post_init__(self):
        if self.kp_sampling_method not in ("uniform", "farthest"):
            raise ValueError(f"kp_sampling_method {self.kp_sampling_method!r}"
                             ": uniform or farthest")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: float32 or bfloat16")
        for impl in (self.conv_impl, self.rot_conv_impl):
            if impl is not None and impl not in CONV_IMPLS:
                raise ValueError(f"conv impl {impl!r}: one of {CONV_IMPLS}")


def dense_kp(cfg: InferenceConfig) -> bool:
    """True where the keypoint stage is the dense PointNet2 path."""
    return cfg.kp_backbone == "pointnet2"


def q8_stages(cfg: InferenceConfig):
    """The stages whose k3 / down / transpose convs run in int8 (a dense
    keypoint stage has none)."""
    seg_kp = cfg.conv_impl == "pallas-int8"
    rot = cfg.rot_conv_impl == "pallas-int8"
    return tuple(s for s, on in (("seg", seg_kp), ("rot", rot),
                                 ("kp", seg_kp and not dense_kp(cfg))) if on)


def _k3_route(cfg: InferenceConfig, stage: str, caps):
    """Per level of ``stage`` (capacities ``caps``, finest first): True
    where it takes the k3-table route (``uses_k3_tables`` at the stage's
    impl; an int8 engine's rotation stage is bf16 unless asked)."""
    impl = "pallas-int8" if stage in q8_stages(cfg) else "pallas"
    return tuple(uses_k3_tables(n, impl, cfg.compute_dtype,
                                cfg.k3_self_keyed) for n in caps)


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
    """EE pose, keypoints and the camera extrinsic from point clouds:
    ``predict(PointCloudDTO) -> ResultDTO``, ``calibrate({position:
    [ResultDTO]}) -> CalibrationResultDTO`` and the batched
    ``predict_batch_arrays``."""

    def __init__(self, config: InferenceConfig = None, device=None, seed=0,
                 calibration_only: bool = False, mesh=None, params=None):
        """``calibration_only``: no networks; ``predict`` returns empty
        results and ``calibrate`` averages given ones.  ``mesh``: a 1-D
        ``data`` mesh that shards ``predict_batch_arrays`` over its ranks.
        ``params``: trained weights as ``{"segmentation", "rotation",
        "key_points"}`` state dicts (the trainers' models'), loaded
        strictly over the seeded init and the checkpoints, as the JAX
        engine's ``params=``."""
        self.cfg = config or InferenceConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.template = torch.as_tensor(
            default_template(cfg.icp_template_points), device=self.device)
        self.pred_enabled = not calibration_only
        if calibration_only:
            return
        self.seg_model = RobotNetSegmentation(
            backbone=cfg.seg_backbone, in_channels=3,
            num_classes=cfg.num_classes)
        self.rot_model = RobotNetEncode(
            backbone=cfg.rot_backbone, in_channels=3,
            out_channels=((9 if cfg.rot_6d else 7)
                          + (3 if cfg.compute_confidence else 0)),
            rot_dims=6 if cfg.rot_6d else 4)
        if dense_kp(cfg):
            self.kp_model = PointNet2SSG(num_classes=cfg.num_of_keypoints,
                                         in_channels=3)
        else:
            self.kp_model = RobotNetSegmentation(
                backbone=cfg.kp_backbone, in_channels=3,
                num_classes=cfg.num_of_keypoints)
        for i, model in enumerate(self.models().values()):
            init_parameters(model, seed * 3 + i)
        for model, path in zip(self.models().values(),
                               (cfg.seg_checkpoint, cfg.rot_checkpoint,
                                cfg.kp_checkpoint)):
            if path:
                load_weights(model, path)
        for stage, state in (params or {}).items():
            self.models()[stage].load_state_dict(state, strict=True)
        for model in self.models().values():
            model.to(self.device).eval()
        on = q8_stages(cfg)
        for stage, model in zip(("seg", "rot", "kp"), self.models().values()):
            set_q8(model, stage in on)
        self.level_caps = {
            stage: (cap,) + _hierarchy_caps(cap, override)
            for stage, cap, override in (
                ("seg", cfg.seg_voxel_capacity, cfg.seg_hierarchy_caps),
                ("rot", cfg.ee_voxel_capacity, cfg.ee_hierarchy_caps),
                ("kp", cfg.kp_voxel_capacity, cfg.kp_hierarchy_caps))}
        # the uniform dense sample's draws by (B, crop rows)
        self._draws = {}
        # per stage and level: True where the k3 convs run over tables
        self.k3_tables = {stage: _k3_route(cfg, stage, caps)
                          for stage, caps in self.level_caps.items()}

    def models(self):
        return {"segmentation": self.seg_model, "rotation": self.rot_model,
                "key_points": self.kp_model}

    def load_jax_params(self, params):
        """Load the JAX engine's ``params`` (``{"segmentation", "rotation",
        "key_points"}`` stage variables as numpy dicts), strictly."""
        for stage, model in self.models().items():
            load_jax_variables(model, params[stage])
        return self

    @torch.no_grad()
    def calibrate_q8(self, points, rgb, mask):
        """Record every sparse conv's activation absmax (all three stages,
        rotation included, as the JAX engine's ``calibrate_q8``; a dense
        keypoint stage has nothing to calibrate) from one representative
        batch; the int8 convs then quantise with it.  A second call widens
        the running maximum."""
        points = self._tensor(points, torch.float32)
        rgb = self._tensor(rgb, torch.float32)
        mask = self._tensor(mask, torch.bool)
        with q8_calibration(self.seg_model):
            ee = self.seg_stage(points, rgb, mask)[2:5]
        with q8_calibration(self.rot_model):
            self.pose_stage(*ee)
        if not dense_kp(self.cfg):
            with q8_calibration(self.kp_model):
                self.kp_stage(*ee)
        return self

    def _hierarchy(self, vox, stage):
        return build_hierarchy(vox, 4, capacities=self.level_caps[stage][1:],
                               k3_tables=self.k3_tables[stage])

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
        levels = self._hierarchy(svox, "seg")
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
        """Rotation net + magic translation -> ``(pose [B, 7], conf [B, 3])``:
        the quaternion head or, with ``rot_6d``, the 6D head converted; the
        sigmoided confidences where the head has them, else ones."""
        cfg = self.cfg
        rot_pts = (center_at_origin(ee_pts, mask=ee_valid)[0]
                   if cfg.rot_center_at_origin else ee_pts)
        rvox, _ = voxelize(rot_pts, ee_rgb, ee_valid, 1.0 / cfg.rot_scale,
                           cfg.ee_voxel_capacity)
        levels = self._hierarchy(rvox, "rot")
        rot_out = self.rot_model(rvox.feats.to(self.dtype), levels).float()
        if cfg.rot_6d:
            q, conf_off = rot6d_to_quat(rot_out[:, 3:9]), 9
        else:
            q, conf_off = rot_out[:, 3:7], 7
        pos, _ = predict_translation(
            ee_pts, ee_valid, q, z_percentile=cfg.translation_z_percentile)
        if rot_out.shape[-1] > conf_off:
            conf = rot_out[:, conf_off:conf_off + 3]
        else:
            conf = torch.ones((rot_out.shape[0], 3), dtype=torch.float32,
                              device=self.device)
        return torch.cat([pos, q], dim=-1), conf

    @torch.no_grad()
    def kp_stage(self, ee_pts, ee_rgb, ee_valid):
        """Keypoint net + Kabsch ->
        ``(kp_pose, kp_ok, kp_coords, kp_found, kp_conf)``: the sparse net
        over the crop's voxels, or the dense path."""
        if dense_kp(self.cfg):
            x, order, s_valid = self.dense_sample(ee_pts, ee_rgb, ee_valid)
            with points.full_f32():
                logits, _ = self.kp_model(x)
            return self.dense_key_points(logits, order, s_valid, ee_pts,
                                         ee_valid)
        cfg = self.cfg
        kp_pts = (center_at_origin(ee_pts, mask=ee_valid)[0]
                  if cfg.kp_center_at_origin else ee_pts)
        kvox, kpv = voxelize(kp_pts, ee_rgb, ee_valid, 1.0 / cfg.kp_scale,
                             cfg.kp_voxel_capacity)
        levels = self._hierarchy(kvox, "kp")
        logits = self.kp_model(kvox.feats.to(self.dtype), levels).float()
        pt_logits = slice_to_points(logits, kpv, fill_value=-1e9)
        kp_idx, kp_found, kp_conf = key_point_predictions(
            pt_logits, ee_valid, conf_threshold=cfg.kp_conf_threshold)
        kp_coords = _take(ee_pts, kp_idx)
        kp_pose, kp_ok = pose_from_key_points(kp_coords, kp_found)
        return kp_pose, kp_ok, kp_coords, kp_found, kp_conf

    @torch.no_grad()
    def dense_sample(self, ee_pts, ee_rgb, ee_valid):
        """The dense stage's input (JAX ``_kp_stage_dense``): the crop
        centred, ``num_of_dense_input_points`` rows of it chosen uniformly
        (a stable argsort of the JAX package's ``uniform(PRNGKey(0), (B,
        E))`` draws, invalid rows at 2.0, so last) or by FPS (invalid rows
        parked on the first row: distance 0, never chosen while a valid
        row is left), and beside each row's xyz its colour or, with
        ``kp_use_coordinates_as_features``, its unit-sphere coordinates.
        Returns ``(x [B, N, 6], order [B, N], valid [B, N])``."""
        cfg = self.cfg
        kp_pts = (center_at_origin(ee_pts, mask=ee_valid)[0]
                  if cfg.kp_center_at_origin else ee_pts)
        feats = (normalize_points(kp_pts, mask=ee_valid)
                 if cfg.kp_use_coordinates_as_features else ee_rgb)
        nd = cfg.num_of_dense_input_points
        if cfg.kp_sampling_method == "farthest":
            fps_in = torch.where(ee_valid[..., None], kp_pts, kp_pts[:, :1])
            order = points.farthest_point_sample(fps_in, nd)
        else:
            shape = tuple(ee_valid.shape)
            if shape not in self._draws:
                self._draws[shape] = torch.as_tensor(uniform(shape),
                                                     device=self.device)
            r = torch.where(ee_valid, self._draws[shape], 2.0)
            order = torch.argsort(r, dim=-1, stable=True)[:, :nd]
            order = order.to(torch.int32)
        x = torch.cat([_take(kp_pts, order), _take(feats, order)], dim=-1)
        return x, order, ee_valid.gather(1, order.long())

    @torch.no_grad()
    def dense_key_points(self, logits, order, s_valid, ee_pts, ee_valid):
        """Keypoints of the dense net's logits over the sample: the
        per-class softmax maximum, found only where the crop holds
        ``num_of_dense_input_points`` valid rows, mapped back to the crop's
        rows, then Kabsch."""
        kp_idx_s, kp_found, kp_conf = key_point_predictions(
            logits.float(), s_valid, conf_threshold=self.cfg.kp_conf_threshold)
        enough = ee_valid.sum(dim=-1) >= self.cfg.num_of_dense_input_points
        kp_found = kp_found & enough[:, None]
        kp_idx = order.gather(1, kp_idx_s.long())
        kp_coords = _take(ee_pts, kp_idx)
        kp_pose, kp_ok = pose_from_key_points(kp_coords, kp_found)
        return kp_pose, kp_ok, kp_coords, kp_found, kp_conf

    @torch.no_grad()
    def flip_stage(self, ee_pose, kp_coords, kp_found, kp_conf, ee_pts,
                   ee_valid):
        """Gripper-symmetry disambiguation of ``ee_pose`` [B, 7] as the JAX
        engine's fused program (``_full_pipeline``) runs it: the keypoint
        pose is a Kabsch fit over the found classes and the three most
        confident ones, trusted where at least three classes take part.

        That last condition always holds, since the top three classes are
        always in (ROADMAP C2); it is kept as written.  The JAX engine's
        CPU-staged branch feeds the strict ``kp_pose, kp_ok`` instead (C1);
        this port follows the fused program."""
        top3 = kp_conf >= torch.sort(kp_conf, dim=-1).values[:, -3:-2]
        flip_found = kp_found | top3
        flip_pose, _ = pose_from_key_points(kp_coords, flip_found)
        flip_ok = flip_found.sum(dim=-1) >= 3
        fixed, _ = disambiguate_flip(
            ee_pose, flip_pose, flip_ok, ee_pts, ee_valid,
            axis=self.cfg.rot_symmetry_axis,
            z_percentile=self.cfg.translation_z_percentile)
        return fixed

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
        engine's device.

        Under a mesh each rank runs its own rows.  Global arrays (from
        ``fleet.globalize``) give global arrays whose local rows are this
        rank's results (``fleet.local_slice``); a plain global batch (``B``
        a multiple of the mesh size) gives the whole batch's results,
        gathered from every rank."""
        if self.mesh is None:
            return self._predict_rows(points, rgb, mask)
        from torch.distributed.tensor import DTensor, Shard

        from ..parallel import mesh as mesh_lib

        if isinstance(points, DTensor):
            out = self._predict_rows(points.to_local(), rgb.to_local(),
                                     mask.to_local())
            return {k: DTensor.from_local(v, self.mesh, [Shard(0)],
                                          run_check=False)
                    for k, v in out.items()}
        rows = mesh_lib.shard_batch((points, rgb, mask), self.mesh)
        return {k: mesh_lib.gather_rows(v, self.mesh)
                for k, v in self._predict_rows(*rows).items()}

    def _predict_rows(self, points, rgb, mask):
        points = self._tensor(points, torch.float32)
        rgb = self._tensor(rgb, torch.float32)
        mask = self._tensor(mask, torch.bool)
        seg, ee_count, ee_pts, ee_rgb, ee_valid, seg_overflow = \
            self.seg_stage(points, rgb, mask)
        ee_pose, rot_conf = self.pose_stage(ee_pts, ee_rgb, ee_valid)
        kp_pose, kp_ok, kp_coords, kp_found, kp_conf = self.kp_stage(
            ee_pts, ee_rgb, ee_valid)
        if self.cfg.rot_flip_disambiguation:
            ee_pose = self.flip_stage(ee_pose, kp_coords, kp_found, kp_conf,
                                      ee_pts, ee_valid)
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

    def _pad(self, points, rgb):
        """One cloud padded (and, past the point capacity, subsampled) to
        the capacity: ``(pts, cols, mask, n, sel)``; ``sel`` holds the kept
        rows' indices into the cloud (None when nothing was dropped) for
        scattering per-point outputs back."""
        p = self.cfg.point_capacity
        n = len(points)
        sel = None
        if n > p:
            sel = np.sort(np.random.default_rng(0).choice(n, p,
                                                          replace=False))
            points, rgb = points[sel], rgb[sel]
            n = p
        pts = np.zeros((1, p, 3), np.float32)
        cols = np.zeros((1, p, 3), np.float32)
        mask = np.zeros((1, p), bool)
        pts[0, :n] = points
        cols[0, :n] = rgb
        mask[0, :n] = True
        return pts, cols, mask, n, sel

    def _pose_np(self, fn, *poses):
        """``fn`` of 7-vector poses given as numpy, on the engine's device,
        back as numpy."""
        out = fn(*(self._tensor(np.asarray(p, np.float32), torch.float32)
                   for p in poses))
        return out.cpu().numpy()

    def predict(self, data: PointCloudDTO) -> ResultDTO:
        """One cloud through ``predict_batch_arrays``: labels for every
        input point (a subsampled cloud's unsampled points take their
        nearest sampled point's label), poses and keypoints where the EE
        crop holds ``ee_point_counts_threshold`` points, ``is_confident``
        from ``check_sanity`` (and the confidence head), and the base poses
        where the frame has an ``ee2base_pose``."""
        if not self.pred_enabled:
            return ResultDTO(segmentation=np.zeros(len(data.points),
                                                   np.int32))
        points = np.asarray(data.points, np.float32)
        pts, cols, mask, n, sel = self._pad(points,
                                            np.asarray(data.rgb, np.float32))
        out = {k: v[0].cpu().numpy() for k, v in
               self.predict_batch_arrays(pts, cols, mask).items()}

        seg = out["segmentation"][:n]
        if sel is not None:
            from scipy.spatial import cKDTree

            full = np.zeros(len(points), np.int32)
            full[sel] = seg
            unsel = np.ones(len(points), bool)
            unsel[sel] = False
            _, nn = cKDTree(points[sel]).query(points[unsel], k=1)
            full[unsel] = seg[nn]
            seg = full
        result = ResultDTO(segmentation=seg)
        if int(out["ee_count"]) < self.cfg.ee_point_counts_threshold:
            return result

        result.ee_pose = out["ee_pose"]
        result.key_points = [(int(k), out["kp_coords"][k])
                             for k in range(self.cfg.num_of_keypoints)
                             if out["kp_found"][k]]
        result.key_points_pose = out["kp_pose"] if out["kp_ok"] else None
        result.confidence = float(out["rot_conf"][2])
        result.is_confident = self.check_sanity(data, result)
        if self.cfg.compute_confidence:
            result.is_confident = (result.is_confident and result.confidence
                                   > self.cfg.confidence_threshold)
        if data.ee2base_pose is not None:
            result.base_pose = self._pose_np(base2cam_pose, result.ee_pose,
                                             data.ee2base_pose)
            if result.key_points_pose is not None:
                result.key_points_base_pose = self._pose_np(
                    base2cam_pose, result.key_points_pose, data.ee2base_pose)
        return result

    def check_sanity(self, data: PointCloudDTO, result: ResultDTO,
                     kp_error_margin=None) -> bool:
        """The geometric gate of one frame: enough EE points, a pose, the
        four front-plate keypoints visible under that pose, and (with more
        than three predicted keypoints) their mean error to the pose's
        keypoints within ``kp_error_margin``."""
        cfg = self.cfg
        kp_error_margin = kp_error_margin or cfg.kp_error_margin
        seg = result.segmentation
        if int((seg == 2).sum()) < cfg.sanity_min_num_of_ee_points:
            return False
        if result.ee_pose is None:
            return False
        ee_raw_points = np.asarray(data.points)[:len(seg)][seg == 2]
        kp_gt_coords, kp_gt_classes = get_6_key_points(
            ee_raw_points, np.asarray(result.ee_pose),
            euclidean_threshold=0.04)
        if (len(kp_gt_classes) == 0
                or (np.asarray(kp_gt_classes[:4]) < 0).any()):
            return False
        if len(result.key_points) > 3:
            kp_classes = torch.as_tensor([k for k, _ in result.key_points])
            kp_coords = torch.as_tensor(np.array(
                [c for _, c in result.key_points], np.float32))
            err = float(compute_kp_error(
                torch.as_tensor(kp_gt_coords, dtype=torch.float32),
                kp_coords, kp_classes))
            if err > kp_error_margin:
                return False
        return True

    def calibrate(self, data: typing.Dict[str, typing.List[ResultDTO]]
                  ) -> CalibrationResultDTO:
        """The camera-to-base extrinsic from frames grouped by robot
        position: each position's confident frames averaged, the positions'
        averages averaged, then the mean of the base and keypoint-base
        poses as ``pose_camera_link`` (None where too few frames were
        confident)."""
        individual = [self._calibrate_individual(v) for v in data.values()]
        individual = [v for v in individual if v is not None]
        if len(data) == 1 and individual:
            raw = individual[0]
        else:
            raw = self._calibrate_individual(individual)
            if raw is None:
                return CalibrationResultDTO(pose_camera_link=None)
        stack = [p for p in (raw.base_pose, raw.key_points_base_pose)
                 if p is not None]
        if not stack:
            return CalibrationResultDTO(pose_camera_link=None)
        calibration = CalibrationResultDTO(pose_camera_link=self._pose_np(
            calib_util.average_poses, np.stack(stack)))
        calibration.load_from_test_result(raw)
        return calibration

    def _calibrate_individual(self, data, weights=None, confident_count=None
                              ) -> typing.Optional[TestResultDTO]:
        """Average of each pose field over the confident results (None
        under ``confident_count``, default ``calibration_confident_count``),
        and with ``camera_link_transformation_pose`` the base poses moved
        into the camera link's frame, then averaged."""
        confident_count = (confident_count
                           or self.cfg.calibration_confident_count)
        confident = [d for d in data if d is not None and d.is_confident]
        if len(confident) < confident_count:
            return None
        result = TestResultDTO(segmentation=None, is_confident=True)

        def average(poses):
            if not poses:
                return None
            return self._pose_np(
                lambda p: calib_util.average_poses(
                    calib_util.remove_pose_outliers(p), weights=weights),
                np.asarray(poses, np.float32))

        def field(name):
            return [getattr(d, name) for d in confident
                    if getattr(d, name, None) is not None]

        result.ee_pose = average(field("ee_pose"))
        result.base_pose = average(field("base_pose"))
        result.key_points_pose = average(field("key_points_pose"))
        result.key_points_base_pose = average(field("key_points_base_pose"))

        clt = self.cfg.camera_link_transformation_pose
        if clt is not None:
            def to_camera_link(name):
                return average([self._pose_np(transform_pose2pose, p, clt)
                                for p in field(name)])

            result.base_pose_camera_link = to_camera_link("base_pose")
            result.key_points_base_pose_camera_link = to_camera_link(
                "key_points_base_pose")
        return result


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
