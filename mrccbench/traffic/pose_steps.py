"""Traffic kind ``pose_steps``: one client training the pose net on
end-effector crops in a closed loop, a step at a time, as the code
release's default ``train.py`` job does.

As ``train_steps`` (whose stepping, window, traced steps and spans this
kind takes through the registry), with the pose net in place of the
segmentation net: set-up deals the mix's fixed set of ``pool * batch``
scenes (``scene_set``) into ``pool`` batches in an order drawn from the
seed, each scene cut to its end-effector crop with its pose label
(``data/crops.py``), draws the weights from the seed, builds the program's
step (``make_pose_train_step``: ``RobotNet``, the configuration's
criterion, AdamW) and drives it through its first ``checked_steps`` steps,
which warm every shape the window uses.  After the window, the program
freed, the plain reference (``reference/robotnet.py``) repeats the checked
steps from the same weights.

Faults, for the checks of the limits: ``half_batch`` (the second half of
each batch's crops masked out, as ``train_steps``' fault of that name),
``frozen`` (``update`` a no-op) and ``unit_quaternion`` (the head's
eval-mode quaternion normalisation applied in training, a forward hook on
the program's model).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from mrccbench.data import crops, scenes
from mrccbench.harness import registry
from mrccbench.reference import robotnet, train as ref_train
from mrccbench.work import counts

base = registry.kind("train_steps")


def _half(batch):
    """The batch with the points of its second half of crops masked out:
    those items pool nothing, and the mean runs over every item still."""
    out = {k: v.copy() for k, v in batch.items()}
    out["mask"][out["mask"].shape[0] // 2:] = False
    return out


def _unit_quaternion(module, args, out):
    """The head's output with its quaternion normalised, as in eval."""
    import torch

    q = out[:, 3:7]
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True), 1e-12)
    return torch.cat([out[:, :3], q, out[:, 7:]], dim=-1)


class Setup(base.Setup):
    """The program's pose step and everything it is fed."""

    def __init__(self, r):
        import torch
        from mrcc_tpu_torch.data.dataset import DataConfig
        from mrcc_tpu_torch.models import RobotNet
        from mrcc_tpu_torch.train import (LossConfig, TrainConfig,
                                          make_pose_train_step)

        cfg, mix = r.config, r.mix
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        self.cfg, self.mix, self.device = cfg, mix, r.device
        b = mix["batch"]
        seeds = scenes.scene_seeds(mix["scene_set"], mix["pool"] * b)
        order = np.random.default_rng(
            np.random.SeedSequence(r.seed)).permutation(len(seeds))
        seeds = [seeds[i] for i in order]
        self.batches = [crops.pose_batch(seeds[i * b:(i + 1) * b],
                                         mix["max_points"], **mix["scene"])
                        for i in range(mix["pool"])]
        if r.fault == "half_batch":
            self.feed = [_half(batch) for batch in self.batches]
        else:
            self.feed = self.batches
        self.weights = robotnet.make_weights(cfg, r.seed, r.device)
        model = RobotNet(backbone=cfg["backbone"],
                         in_channels=cfg["in_channels"],
                         out_channels=cfg["out_channels"],
                         use_joint_angles=cfg["use_joint_angles"]).to(
                             r.device)
        missing, unexpected = model.load_state_dict(self.weights,
                                                    strict=False)
        if unexpected or any(not k.endswith(("running_mean", "running_var"))
                             for k in missing):
            raise RuntimeError(f"weights do not fit the program's model: "
                               f"missing {missing}, unexpected {unexpected}")
        if r.fault == "unit_quaternion":
            model.register_forward_hook(_unit_quaternion)
        opt = cfg["optimizer"]
        self.lr = opt["lr"]
        self.step, self.optimizer = make_pose_train_step(
            model, DataConfig(data_type=cfg["data_type"],
                              max_points=mix["max_points"],
                              scale=1.0 / cfg["voxel_size"],
                              center_at_origin=cfg["center_at_origin"]),
            LossConfig(loss_type=cfg["loss"], reduction=cfg["reduction"],
                       compute_confidence=cfg["compute_confidence"]),
            TrainConfig(batch_size=b, lr=opt["lr"],
                        weight_decay=opt["weight_decay"]),
            mix["voxel_capacity"], use_joint_angles=cfg["use_joint_angles"],
            device=r.device)
        if r.fault == "frozen":
            self.step.update = lambda lr: None
        self.model = model
        self.done = 0


def reference_readings(s: Setup, precision="float32"):
    return robotnet.readings(s.cfg, s.mix, s.weights,
                             s.batches[:s.mix["checked_steps"]], precision)


def work_per_batch(s: Setup):
    """The benchmark's own count of each pool batch's step work: the
    backbone's convs over the batch's voxels, the head's products over its
    items (a level of ``batch`` rows, ``robotnet.ITEMS``)."""
    plan = robotnet.layer_plan(s.cfg)
    out = []
    for batch in s.batches:
        levels, octs, _, _ = robotnet.prepare(s.cfg, s.mix, batch, s.device)
        st = counts.level_stats(levels, octs)
        items = len(batch["pose"])
        st = dataclasses.replace(st, rows=st.rows + [items],
                                 k3_hits=st.k3_hits + [0])
        out.append(counts.step_work(plan, st, s.cfg["dtype"], training=True))
        del levels, octs
    return out


def run(r):
    """One run of a cell of this kind; returns the outcome the harness
    prints (``run.py``)."""
    import torch

    t_setup = time.perf_counter()
    s = Setup(r)
    t_steps = time.perf_counter()
    mix = s.mix
    program = s.checked_steps(mix["checked_steps"])
    t_end = time.perf_counter()
    setup_s = t_end - r.t0
    parts = {"imports_s": t_setup - r.t0, "inputs_weights_step_s":
             t_steps - t_setup, "checked_steps_s": t_end - t_steps}
    win = base._window(s, r.seconds)
    context = {"window": win, "dtype": s.cfg["dtype"]}
    trace = None
    if r.trace:
        trace = context["trace"] = base._traced(s, mix["traced_steps"])
        context["spans"] = base._spans(s, mix["span_steps"])
    cuda = s.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    s.free()
    if r.trace:
        work = work_per_batch(s)
        pool = len(work)

        def total(key, first, n):
            return sum(work[(first + i) % pool][key] for i in range(n))

        win["model_ops"] = total("model_ops", win["first"], win["units"])
        trace["conv_least_s"] = total("conv_least_s", trace["first"],
                                      trace["units"])
    reference = reference_readings(s)
    gaps = ref_train.compare(program, reference)
    checks = {k: (gaps[k][0], limit, gaps[k][1])
              for k, limit in r.cell["limits"].items()}
    return {
        "setup_s": setup_s, "setup_parts": parts,
        "end_to_end": {"setup_s": setup_s,
                       "train_steps_per_s": win["units"] / win["seconds"]},
        "context": context, "trace": trace, "checks": checks,
        "attempted": win["units"], "failed": win["failed"],
        "memory_peak_bytes": peak,
    }
