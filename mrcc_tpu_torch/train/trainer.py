"""Trainers (port of ``mrcc_tpu/train/trainer.py``: ``TrainConfig``,
``step_learning_rate``, ``make_optimizer``, ``AverageMeter``,
``MetricsWriter``, ``make_segmentation_train_step``,
``make_pose_train_step`` and ``Trainer``), with the steps that
``mrcc_tpu/cli/train_mains.py`` builds inline: the metric-learning step of
``train_feature_extractor`` and the dense steps of ``train_key_points``
(PointNet2SSG) and ``train_kp_to_pose`` (a frozen PointNet2SSG feeding a
PointNet pose head).

The JAX step is one jit program over a functional ``TrainState``; here the
model and the optimizer hold the state and the step runs eagerly:
voxelize (with labels for segmentation) and ``build_hierarchy`` outside
autograd, the model in train mode (batch statistics), the criterion, the
backward pass (the sparse convs' autograd Functions run the forward
kernels over the reverse maps and the dW kernels), and the optimizer step
at the epoch's learning rate.  Metrics stay on the device until the epoch
ends.

The k3 route per level is the JAX train step's
(``hierarchy.train_uses_k3_tables``): self-keyed where
``TrainConfig.k3_self_keyed`` is on and the level passes the TPU's
self-key gate, else on rank-kernel tables, whose convs train through
``K3MapConvFn`` and the k3-table dW kernel.  The JAX ``conv_impl`` option
has no counterpart: the port routes by device, and its int8 convs are
inference only.

The steps run on the card unless ``device="cpu"`` is passed, and raise
where there is none.

The dense steps draw a fresh dropout mask each step from the models' seeded
generators; the JAX dense steps pass ``PRNGKey(0)`` every step, so they
drop the same units each time (ROADMAP C28).

``Trainer(mesh=...)`` trains data-parallel over the mesh's ranks with the
JAX step's global semantics (``parallel.mesh``): each batch is padded to a
multiple of the mesh size (``pad_batch_to``), each rank steps on its rows,
the batch norms and the criteria reduce over every rank's rows, and the
gradients are summed over the ranks before the optimizer step.  The
metric-learning step gathers every rank's embeddings and labels
(``mesh.global_batch``) and mines its triplets over the global batch, as
the JAX step jitted over a sharded batch does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from ..device import resolve_device
from ..geometry.metrics import compute_pose_dist
from ..geometry.transform import rot6d_to_quat
from ..parallel import mesh as mesh_lib
from ..solve.keypoints import key_point_predictions
from ..sparse import (build_hierarchy, hierarchy_caps, train_uses_k3_tables,
                      voxelize)
from . import checkpoint as ckpt
from .losses import LossConfig, LossType, get_criterion, segmentation_loss
from .metric_learning import triplet_margin_loss


@dataclasses.dataclass
class TrainConfig:
    """TRAIN config section (``config/default.yaml:89-104``)."""

    epochs: int = 1300
    lr: float = 1e-4
    optim: str = "Adam"           # Adam (decoupled decay, as optax.adamw) | SGD
    momentum: float = 0.8
    weight_decay: float = 1e-4
    multiplier: float = 0.8
    step_epoch: int = 16
    save_freq: int = 4
    batch_size: int = 2
    seed: int = 1
    # self-keyed k3 convs where a level passes the JAX step's gate
    # (train_uses_k3_tables); False puts every level on tables
    k3_self_keyed: bool = True


def step_learning_rate(base_lr, epoch, step_epoch, multiplier):
    """lr decayed by ``multiplier`` every ``step_epoch`` epochs
    (``utils/utils.py:36``)."""
    return base_lr * (multiplier ** (epoch // step_epoch))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Optimizer:
    """The JAX trainer's optimizers.  Its "Adam" is ``optax.adamw``: Adam
    with weight decay decoupled from the gradient and applied to every
    parameter — ``torch.optim.AdamW``, not ``Adam``.  SGD keeps the
    momentum and has no decay, as ``optax.sgd``."""
    if cfg.optim.lower() == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum)
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


class AverageMeter:
    """``utils/utils.py:17`` parity."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricsWriter:
    """Scalars as JSON lines appended to ``{exp_path}/scalars.jsonl`` (the
    JAX trainer's stand-in for tensorboardX's ``SummaryWriter``)."""

    def __init__(self, exp_path):
        os.makedirs(exp_path, exist_ok=True)
        self.path = os.path.join(exp_path, "scalars.jsonl")

    def add_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")


class _OptimizerStep:
    """Stages shared by every train step: the batch's tensors on the
    device, the backward pass and the optimizer step.  The parameters'
    ``.grad`` hold the step's gradients afterwards."""

    def __init__(self, model, optimizer, device: torch.device):
        self.model = model
        self.optimizer = optimizer
        self.device = device

    def _tensors(self, batch, keys):
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in keys}

    def backward(self, loss):
        """Gradients of ``loss``; in a data-parallel step of the shares'
        sum over the ranks."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mesh_lib.sync_gradients([p for g in self.optimizer.param_groups
                                 for p in g["params"]])

    def update(self, lr):
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()


class _TrainStep(_OptimizerStep):
    """The sparse steps' hierarchy of a voxelised batch on the JAX step's
    k3 route."""

    def __init__(self, model, optimizer, data_cfg, voxel_capacity: int,
                 k3_self_keyed: bool, device: torch.device):
        super().__init__(model, optimizer, device)
        self.qsize = data_cfg.quantization_size
        self.capacity = voxel_capacity
        self.caps = hierarchy_caps(voxel_capacity)
        self.k3_tables = tuple(train_uses_k3_tables(n, k3_self_keyed)
                               for n in (voxel_capacity,) + self.caps)

    def _levels(self, vox):
        return build_hierarchy(vox, 4, capacities=self.caps,
                               k3_tables=self.k3_tables)


class SegmentationTrainStep(_TrainStep):
    """One per-voxel cross-entropy train step (``train_segmentation.py`` hot
    loop), callable as ``step(batch, lr)``.

    Its stages run in order and can be called one by one (to time them):
    :meth:`prepare` (voxelize with labels, ``build_hierarchy``, outside
    autograd), :meth:`forward` (model in train mode, loss), :meth:`backward`
    and :meth:`update` (optimizer step at ``lr``).  ``batch`` holds numpy
    arrays or tensors ``points [B, P, 3]``, ``feats [B, P, C]``,
    ``mask [B, P]`` and ``labels [B, P]``.
    """

    def __init__(self, model, optimizer, data_cfg, voxel_capacity: int,
                 ignore_label: int, device: torch.device,
                 k3_self_keyed: bool = True):
        super().__init__(model, optimizer, data_cfg, voxel_capacity,
                         k3_self_keyed, device)
        self.ignore_label = ignore_label

    def prepare(self, batch):
        """-> (SparseVoxels, voxel labels, levels)."""
        t = self._tensors(batch, ("points", "feats", "mask", "labels"))
        with torch.no_grad():
            vox, _, vlabels = voxelize(t["points"], t["feats"], t["mask"],
                                       self.qsize, self.capacity,
                                       labels=t["labels"],
                                       ignore_label=self.ignore_label)
            levels = self._levels(vox)
        return vox, vlabels, levels

    def forward(self, vox, vlabels, levels):
        """-> (logits, loss)."""
        self.model.train()
        logits = self.model(vox.feats, levels)
        return logits, segmentation_loss(logits, vlabels, vox.valid,
                                         ignore_label=self.ignore_label)

    def __call__(self, batch, lr):
        """Run every stage; returns ``{"loss", "accuracy"}`` as device
        scalars."""
        vox, vlabels, levels = self.prepare(batch)
        logits, loss = self.forward(vox, vlabels, levels)
        self.backward(loss)
        self.update(lr)
        with torch.no_grad():
            keep = vox.valid & (vlabels != self.ignore_label)
            right = keep & (logits.argmax(dim=-1) == vlabels)
            acc = (mesh_lib.global_count(right.sum())
                   / torch.clamp_min(mesh_lib.global_count(keep.sum()), 1))
        return {"loss": mesh_lib.reported(loss), "accuracy": acc.float()}


def make_segmentation_train_step(model, data_cfg, train_cfg: TrainConfig,
                                 voxel_capacity: int, ignore_label=-100,
                                 device=None):
    """Move ``model`` to the device (the card unless ``device`` says
    otherwise; raises where there is none) and return
    ``(SegmentationTrainStep, optimizer)``."""
    dev = resolve_device(device)
    model.to(dev)
    optimizer = make_optimizer(model.parameters(), train_cfg)
    return SegmentationTrainStep(model, optimizer, data_cfg, voxel_capacity,
                                 ignore_label, dev,
                                 train_cfg.k3_self_keyed), optimizer


class PoseTrainStep(_TrainStep):
    """One pose-regression train step (``train.py`` hot loop), callable as
    ``step(batch, lr)``, with the stages of :class:`SegmentationTrainStep`.
    ``batch`` holds ``points``, ``feats``, ``mask``, ``pose [B, 7]`` (WXYZ)
    and, with ``use_joint_angles``, ``joint_angles [B, 9]``.  The criterion
    gets the level-0 voxel coordinates and their validity."""

    def __init__(self, model, optimizer, criterion, loss_cfg: LossConfig,
                 data_cfg, voxel_capacity: int, use_joint_angles: bool,
                 device: torch.device, k3_self_keyed: bool = True):
        super().__init__(model, optimizer, data_cfg, voxel_capacity,
                         k3_self_keyed, device)
        self.criterion = criterion
        self.rot6d = LossType(loss_cfg.loss_type) == LossType.COS2_6D
        self.use_joint_angles = use_joint_angles

    def prepare(self, batch):
        """-> (SparseVoxels, levels, pose, joint angles or None)."""
        keys = ("points", "feats", "mask", "pose") + (
            ("joint_angles",) if self.use_joint_angles else ())
        t = self._tensors(batch, keys)
        with torch.no_grad():
            vox, _ = voxelize(t["points"], t["feats"], t["mask"], self.qsize,
                              self.capacity)
            levels = self._levels(vox)
        return vox, levels, t["pose"], t.get("joint_angles")

    def forward(self, vox, levels, pose, joint_angles):
        """-> (head output, loss)."""
        self.model.train()
        out = self.model(vox.feats, levels, joint_angles)
        return out, self.criterion(pose, out,
                                   coords=vox.coords().to(torch.float32),
                                   coords_valid=vox.valid)

    def __call__(self, batch, lr):
        """Run every stage; returns ``{"loss", "dist", "dist_position",
        "dist_orientation", "angle_diff"}`` (batch means) as device
        scalars."""
        vox, levels, pose, ja = self.prepare(batch)
        out, loss = self.forward(vox, levels, pose, ja)
        self.backward(loss)
        self.update(lr)
        with torch.no_grad():
            out7 = (torch.cat([out[:, :3], rot6d_to_quat(out[:, 3:9])], -1)
                    if self.rot6d else out[:, :7])
            dist, dist_pos, dist_ori, angle = compute_pose_dist(pose, out7)
        share = mesh_lib.mean_share
        return {"loss": mesh_lib.reported(loss),
                **{k: mesh_lib.reported(share(v)) for k, v in (
                    ("dist", dist), ("dist_position", dist_pos),
                    ("dist_orientation", dist_ori), ("angle_diff", angle))}}


def make_pose_train_step(model, data_cfg, loss_cfg: LossConfig,
                         train_cfg: TrainConfig, voxel_capacity: int,
                         use_joint_angles: bool = False, device=None):
    """Move ``model`` to the device (the card unless ``device`` says
    otherwise; raises where there is none) and return
    ``(PoseTrainStep, optimizer)``."""
    dev = resolve_device(device)
    model.to(dev)
    optimizer = make_optimizer(model.parameters(), train_cfg)
    return PoseTrainStep(model, optimizer, get_criterion(loss_cfg), loss_cfg,
                         data_cfg, voxel_capacity, use_joint_angles, dev,
                         train_cfg.k3_self_keyed), optimizer


class MetricLearningTrainStep(_TrainStep):
    """One metric-learning train step (``train_feature-extractor.py`` hot
    loop, the step the JAX ``train_feature_extractor`` main builds inline),
    callable as ``step(batch, lr)``, with the stages of
    :class:`SegmentationTrainStep`: :meth:`prepare` (voxelize,
    ``build_hierarchy``), :meth:`forward` (the embedding net in train mode,
    ``criterion(emb, labels)``), :meth:`backward` and :meth:`update`.
    ``batch`` holds ``points``, ``feats``, ``mask`` and the clouds' class
    ``labels [B]``.  As in the JAX step, the level capacities halve from
    ``voxel_capacity`` with no floor, and the hierarchy is built with
    ``k3_self_keyed`` off, so every level takes the k3-table route.

    In a data-parallel step the criterion runs on every rank's embeddings
    and labels (``mesh.global_batch``): each rank computes the global loss
    and backpropagates it into its own rows."""

    def __init__(self, model, optimizer, criterion, data_cfg,
                 voxel_capacity: int, device: torch.device):
        super().__init__(model, optimizer, data_cfg, voxel_capacity, False,
                         device)
        self.caps = tuple(voxel_capacity >> l for l in range(4))
        self.criterion = criterion

    def prepare(self, batch):
        """-> (SparseVoxels, levels, labels)."""
        t = self._tensors(batch, ("points", "feats", "mask", "labels"))
        with torch.no_grad():
            vox, _ = voxelize(t["points"], t["feats"], t["mask"], self.qsize,
                              self.capacity)
            levels = self._levels(vox)
        return vox, levels, t["labels"]

    def forward(self, vox, levels, labels):
        """-> (this rank's embeddings, the global batch's loss)."""
        self.model.train()
        emb = self.model(vox.feats, levels)
        return emb, self.criterion(mesh_lib.global_batch(emb),
                                   mesh_lib.global_batch(labels))

    def __call__(self, batch, lr):
        """Run every stage; returns ``{"loss"}`` (the global batch's, the
        same on every rank) as a device scalar."""
        vox, levels, labels = self.prepare(batch)
        _, loss = self.forward(vox, levels, labels)
        self.backward(loss)
        self.update(lr)
        return {"loss": loss.detach()}


def make_metric_learning_train_step(model, data_cfg, train_cfg: TrainConfig,
                                    voxel_capacity: int, device=None):
    """Move ``model`` to the device (the card unless ``device`` says
    otherwise; raises where there is none) and return
    ``(MetricLearningTrainStep, optimizer)`` with the mined triplet loss
    (``metric_learning.triplet_margin_loss``)."""
    dev = resolve_device(device)
    model.to(dev)
    optimizer = make_optimizer(model.parameters(), train_cfg)
    return MetricLearningTrainStep(model, optimizer, triplet_margin_loss,
                                   data_cfg, voxel_capacity, dev), optimizer


class DenseKeyPointTrainStep(_OptimizerStep):
    """One dense keypoint train step (JAX ``_train_key_points_dense``'s
    inline step), callable as ``step(batch, lr)``: :meth:`prepare` (the
    network input ``[points, feats]``), :meth:`forward` (PointNet2SSG in
    train mode, cross-entropy over the masked labelled points),
    :meth:`backward` and :meth:`update`.  ``batch`` holds ``points
    [B, N, 3]``, ``feats [B, N, C]``, ``labels [B, N]`` and ``mask``."""

    def __init__(self, model, optimizer, ignore_label: int,
                 device: torch.device):
        super().__init__(model, optimizer, device)
        self.ignore_label = ignore_label

    def prepare(self, batch):
        """-> (x [B, N, 3 + C], labels, mask)."""
        t = self._tensors(batch, ("points", "feats", "labels", "mask"))
        return (torch.cat([t["points"], t["feats"]], dim=-1), t["labels"],
                t["mask"])

    def forward(self, x, labels, mask):
        """-> (logits, loss)."""
        self.model.train()
        logits, _ = self.model(x)
        return logits, segmentation_loss(logits, labels, mask,
                                          ignore_label=self.ignore_label)

    def __call__(self, batch, lr):
        """Run every stage; returns ``{"loss"}`` as a device scalar."""
        _, loss = self.forward(*self.prepare(batch))
        self.backward(loss)
        self.update(lr)
        return {"loss": mesh_lib.reported(loss)}


def make_dense_key_point_train_step(model, train_cfg: TrainConfig,
                                    ignore_label=-100, device=None):
    """Move ``model`` to the device (the card unless ``device`` says
    otherwise; raises where there is none) and return
    ``(DenseKeyPointTrainStep, optimizer)``."""
    dev = resolve_device(device)
    model.to(dev)
    optimizer = make_optimizer(model.parameters(), train_cfg)
    return DenseKeyPointTrainStep(model, optimizer, ignore_label,
                                  dev), optimizer


class KpToPoseTrainStep(_OptimizerStep):
    """One keypoint-to-pose train step (JAX ``train_kp_to_pose``'s inline
    step), callable as ``step(batch, lr)``: :meth:`prepare` runs the frozen
    keypoint net (eval mode, no gradient) and gathers each class's most
    probable point (``key_point_predictions`` over the mask) with its
    probability; :meth:`forward` runs the pose head in train mode on the
    [B, K, 3] coordinates (and, with ``use_probabilities``, the [B, K, 1]
    probabilities) and the ``kp_pose_match`` criterion.  ``batch`` holds
    ``points``, ``feats``, ``mask`` and ``pose [B, 7]``."""

    def __init__(self, model, kp_model, optimizer, criterion,
                 use_probabilities: bool, device: torch.device):
        super().__init__(model, optimizer, device)
        self.kp_model = kp_model
        self.criterion = criterion
        self.use_probabilities = use_probabilities

    @torch.no_grad()
    def prepare(self, batch):
        """-> (head input, keypoint coords [B, K, 3], found [B, K],
        probabilities [B, K], pose)."""
        t = self._tensors(batch, ("points", "feats", "mask", "pose"))
        self.kp_model.eval()
        logits, _ = self.kp_model(torch.cat([t["points"], t["feats"]], -1))
        idx, found, conf = key_point_predictions(logits, t["mask"])
        coords = t["points"].gather(
            1, idx.long()[..., None].expand(-1, -1, 3))
        head_in = (torch.cat([coords, conf[..., None]], dim=-1)
                   if self.use_probabilities else coords)
        return head_in, coords, found, conf, t["pose"]

    def forward(self, head_in, coords, found, conf, pose):
        """-> (pose head output [B, 7], loss)."""
        self.model.train()
        out = self.model(head_in)
        return out, self.criterion(
            pose, out, coords=coords, coords_valid=found,
            probs=conf if self.use_probabilities else None)

    def __call__(self, batch, lr):
        """Run every stage; returns ``{"loss"}`` as a device scalar."""
        _, loss = self.forward(*self.prepare(batch))
        self.backward(loss)
        self.update(lr)
        return {"loss": mesh_lib.reported(loss)}


def make_kp_to_pose_train_step(model, kp_model, train_cfg: TrainConfig,
                               use_probabilities: bool = True, device=None):
    """Move the pose head ``model`` and the frozen keypoint net
    ``kp_model`` to the device (the card unless ``device`` says otherwise;
    raises where there is none) and return ``(KpToPoseTrainStep,
    optimizer)`` with the ``kp_pose_match`` criterion; the optimizer holds
    only the head's parameters."""
    dev = resolve_device(device)
    model.to(dev)
    kp_model.to(dev).eval().requires_grad_(False)
    optimizer = make_optimizer(model.parameters(), train_cfg)
    criterion = get_criterion(LossConfig(loss_type=LossType.KP_POSE_MATCH))
    return KpToPoseTrainStep(model, kp_model, optimizer, criterion,
                             use_probabilities, dev), optimizer


class Trainer:
    """Epoch loop (``train.py:236-374`` skeleton): step-decayed lr, metrics
    summed on the device and read once per epoch, checkpoints at save_freq
    multiples, powers of two and the last epoch, resume from the latest
    checkpoint.

    ``mesh``: train data-parallel over its ranks (every rank runs the same
    loop over the same batches; see the module docstring).  The model's
    parameters and buffers, the epoch and the optimizer's state start
    from the first rank's; only that rank writes metrics and
    checkpoints."""

    def __init__(self, model, dataset, step_fn, optimizer,
                 train_cfg: TrainConfig, exp_path="exp/default",
                 exp_name="default", mesh=None):
        self.model = model
        self.dataset = dataset
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.cfg = train_cfg
        self.exp_path = exp_path
        self.exp_name = exp_name
        self.mesh = mesh
        self.lead = mesh is None or mesh.get_local_rank() == 0
        self.writer = MetricsWriter(exp_path)
        self.epoch = ckpt.checkpoint_restore(model, optimizer, exp_path,
                                             exp_name)
        if mesh is not None:
            # every rank resumes from the first rank's checkpoint: its
            # weights, epoch and optimizer state (ranks may hold other
            # checkpoints, or none)
            mesh_lib.replicate(model, mesh)
            self.epoch, opt_state = mesh_lib.broadcast_object(
                (self.epoch, None if optimizer is None
                 else optimizer.state_dict()), mesh)
            if optimizer is not None:
                optimizer.load_state_dict(opt_state)

    def step(self, batch, lr):
        """One step on a global batch.  Under a mesh it is padded to a
        multiple of the mesh size by repeating item 0 and this rank's rows
        go through the step's data-parallel form; the metrics are the
        global batch's."""
        if self.mesh is None:
            return self.step_fn(batch, lr)
        batch = {k: v for k, v in batch.items() if k != "others"}
        total = mesh_lib.padded_size(len(batch["points"]), self.mesh)
        rows = mesh_lib.shard_batch(mesh_lib.pad_batch_to(batch, total),
                                    self.mesh)
        with mesh_lib.data_parallel(self.mesh):
            return self.step_fn(rows, lr)

    def train_epoch(self, epoch):
        iter_time = AverageMeter()
        data_time = AverageMeter()
        lr = step_learning_rate(self.cfg.lr, epoch, self.cfg.step_epoch,
                                self.cfg.multiplier)
        end = time.time()
        sums, n_batches = {}, 0
        for batch in self.dataset.batches(self.cfg.batch_size, shuffle=True,
                                          seed=self.cfg.seed + epoch):
            data_time.update(time.time() - end)
            metrics = self.step(batch, lr)
            sums = {k: v + sums[k] for k, v in metrics.items()} if sums \
                else dict(metrics)
            iter_time.update(time.time() - end)
            end = time.time()
            n_batches += 1
        epoch_metrics = {k: float(v) / n_batches for k, v in sums.items()}
        if self.lead:
            for k, v in epoch_metrics.items():
                self.writer.add_scalar(f"{k}_train", v, epoch)
        return {**epoch_metrics, "iter_time": iter_time.avg,
                "data_time": data_time.avg, "lr": lr, "batches": n_batches}

    def fit(self, epochs=None, save=True):
        epochs = epochs or self.cfg.epochs
        history = []
        for epoch in range(self.epoch + 1, epochs + 1):
            stats = self.train_epoch(epoch)
            self.epoch = epoch
            # the reference saves at save_freq multiples / powers of two;
            # the last epoch is saved too, so a restore resumes exactly
            if save and self.lead and (
                    ckpt.is_multiple(epoch, self.cfg.save_freq)
                    or ckpt.is_power2(epoch) or epoch == epochs):
                ckpt.checkpoint_save(self.model, self.optimizer,
                                     self.exp_path, self.exp_name, epoch,
                                     save_freq=self.cfg.save_freq)
            history.append(stats)
        return history
