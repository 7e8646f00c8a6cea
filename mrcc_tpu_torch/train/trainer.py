"""Segmentation trainer (port of ``mrcc_tpu/train/trainer.py``:
``TrainConfig``, ``step_learning_rate``, ``make_optimizer``,
``AverageMeter``, ``MetricsWriter``, ``make_segmentation_train_step`` and
``Trainer``).

The JAX step is one jit program over a functional ``TrainState``; here the
model and the optimizer hold the state and the step runs eagerly:
voxelize with labels and ``build_hierarchy`` outside autograd, the model
in train mode (batch statistics), the loss, the backward pass (the sparse
convs' autograd Functions run the forward kernels over the reverse maps
and the dW kernels), and the optimizer step at the epoch's learning rate.
Metrics stay on the device until the epoch ends.  Training keeps the
self-keyed k3 route on every level, as the JAX step does at the training
capacities: the k3-table route (``k3_self_keyed=False`` of the inference
engine) and the int8 convs are inference only, so the JAX ``conv_impl`` /
``k3_self_keyed`` options have no counterpart here.

The step runs on the card unless ``device="cpu"`` is passed, and raises
where there is none.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from ..device import resolve_device
from ..sparse import build_hierarchy, hierarchy_caps, voxelize
from . import checkpoint as ckpt
from .losses import segmentation_loss


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


class SegmentationTrainStep:
    """One per-voxel cross-entropy train step (``train_segmentation.py`` hot
    loop), callable as ``step(batch, lr)``.

    Its stages run in order and can be called one by one (to time them):
    :meth:`prepare` (voxelize with labels, ``build_hierarchy``, outside
    autograd), :meth:`forward` (model in train mode, loss), :meth:`backward`
    and :meth:`update` (optimizer step at ``lr``).  ``batch`` holds numpy
    arrays or tensors ``points [B, P, 3]``, ``feats [B, P, C]``,
    ``mask [B, P]`` and ``labels [B, P]``.  The parameters' ``.grad`` hold
    the step's gradients afterwards.
    """

    def __init__(self, model, optimizer, data_cfg, voxel_capacity: int,
                 ignore_label: int, device: torch.device):
        self.model = model
        self.optimizer = optimizer
        self.qsize = data_cfg.quantization_size
        self.capacity = voxel_capacity
        self.caps = hierarchy_caps(voxel_capacity)
        self.ignore_label = ignore_label
        self.device = device

    def prepare(self, batch):
        """-> (SparseVoxels, voxel labels, levels)."""
        t = {k: torch.as_tensor(batch[k], device=self.device)
             for k in ("points", "feats", "mask", "labels")}
        with torch.no_grad():
            vox, _, vlabels = voxelize(t["points"], t["feats"], t["mask"],
                                       self.qsize, self.capacity,
                                       labels=t["labels"],
                                       ignore_label=self.ignore_label)
            levels = build_hierarchy(vox, 4, capacities=self.caps)
        return vox, vlabels, levels

    def forward(self, vox, vlabels, levels):
        """-> (logits, loss)."""
        self.model.train()
        logits = self.model(vox.feats, levels)
        return logits, segmentation_loss(logits, vlabels, vox.valid,
                                         ignore_label=self.ignore_label)

    def backward(self, loss):
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    def update(self, lr):
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

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
            acc = right.sum() / torch.clamp_min(keep.sum(), 1)
        return {"loss": loss.detach(), "accuracy": acc.float()}


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
                                 ignore_label, dev), optimizer


class Trainer:
    """Epoch loop (``train.py:236-374`` skeleton): step-decayed lr, metrics
    summed on the device and read once per epoch, checkpoints at save_freq
    multiples, powers of two and the last epoch, resume from the latest
    checkpoint."""

    def __init__(self, model, dataset, step_fn, optimizer,
                 train_cfg: TrainConfig, exp_path="exp/default",
                 exp_name="default"):
        self.model = model
        self.dataset = dataset
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.cfg = train_cfg
        self.exp_path = exp_path
        self.exp_name = exp_name
        self.writer = MetricsWriter(exp_path)
        self.epoch = ckpt.checkpoint_restore(model, optimizer, exp_path,
                                             exp_name)

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
            metrics = self.step_fn(batch, lr)
            sums = {k: v + sums[k] for k, v in metrics.items()} if sums \
                else dict(metrics)
            iter_time.update(time.time() - end)
            end = time.time()
            n_batches += 1
        epoch_metrics = {k: float(v) / n_batches for k, v in sums.items()}
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
            if save and (ckpt.is_multiple(epoch, self.cfg.save_freq)
                         or ckpt.is_power2(epoch) or epoch == epochs):
                ckpt.checkpoint_save(self.model, self.optimizer,
                                     self.exp_path, self.exp_name, epoch,
                                     save_freq=self.cfg.save_freq)
            history.append(stats)
        return history
