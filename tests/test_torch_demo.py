"""The trained demo's trainers (``cli/demo_checkpoints.make_trainers``)
against the JAX package's ``Trainer`` as ``scripts/train_demo_checkpoints.py``
builds it, at a tiny size on the CPU.

Each case builds the JAX script's trainer for one net (its ``DataConfig``,
model, step and ``TrainConfig``) and the port's from the same flags and a
shrunk :class:`Recipe`, carries the JAX trainer's initial variables into
the port's model, fits both for 2 epochs of 2 steps on the same synthetic
scenes or EE crops (each package generating its own copy) and holds every
epoch metric within ``rtol=1e-4`` (``atol`` 1e-6; the segmentation
accuracy, a count of voxels, within one voxel's argmax a step): the
segmentation net (this file) and the keypoint net (6 classes, scale 800),
the rotation net with r2's cos2 and r5's ``COS2_6D`` + confidence + symmetry
loss (``test_torch_demo_rot.py``).  All in f32: no case sat within a
ReLU gate's rounding of another branch (ROADMAP C21) at these seeds.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from mrcc_tpu.data import AliveV2Dataset as JaxDataset
from mrcc_tpu.data import DataConfig as JaxDataConfig
from mrcc_tpu.data.synthetic import generate_sample as jax_generate_sample
from mrcc_tpu.models import RobotNetEncode as JaxEncode
from mrcc_tpu.models import RobotNetSegmentation as JaxSegmentation
from mrcc_tpu.train import LossConfig as JaxLossConfig
from mrcc_tpu.train import LossType as JaxLossType
from mrcc_tpu.train import TrainConfig as JaxTrainConfig
from mrcc_tpu.train import Trainer as JaxTrainer
from mrcc_tpu.train import make_pose_train_step as jax_pose_step
from mrcc_tpu.train import make_segmentation_train_step as jax_seg_step
from mrcc_tpu_torch.cli.demo_checkpoints import Recipe, make_trainers, parser
from mrcc_tpu_torch.interop import load_jax_variables

# the JAX script's sizes shrunk: scenes of 256 + 300 + 500 points, crops of
# 256 + 24 + 24, capacities 512 / 256 / 256
TINY = Recipe(scene_points=(256, 300, 500), crop_points=(256, 24, 24),
              seg_max_points=1024, seg_capacity=512, rot_max_points=512,
              rot_capacity=256, kp_max_points=512, kp_capacity=256,
              point_capacity=1024, seg_voxel_capacity=512,
              seg_hierarchy_caps=(384, 256, 128, 64), ee_point_capacity=512,
              icp_iterations=3, icp_template_points=128,
              sanity_min_num_of_ee_points=64, bench_points=(256, 300, 500))
# 4 scenes and 4 crops at batch 2: 2 steps an epoch, 2 epochs
FLAGS = ["--samples", "4", "--epochs", "2", "--ee-mult", "1", "--batch", "2"]
# a voxel count: one voxel's argmax on the other side of a tie in a step's
# ~1000 labelled voxels moves the epoch's accuracy by ~5e-4
ACCURACY_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_trainer(stage, args: argparse.Namespace, recipe: Recipe, exp):
    """The JAX script's trainer of ``stage``
    (``scripts/train_demo_checkpoints.py:112-199``) at ``recipe``'s
    sizes."""
    r = recipe
    tc = JaxTrainConfig(lr=1e-3, batch_size=args.batch, epochs=args.epochs,
                        save_freq=max(args.epochs // 2, 1))
    if stage == "segmentation":
        samples = [jax_generate_sample(r.scene_seed + i, *r.scene_points)
                   for i in range(args.samples)]
        cfg = JaxDataConfig(data_type=None, max_points=r.seg_max_points,
                            scale=200, center_at_origin=True)
        model = JaxSegmentation(backbone=args.backbone, in_channels=3,
                                num_classes=3)
        step, opt = jax_seg_step(model, cfg, tc,
                                 voxel_capacity=r.seg_capacity)
        return JaxTrainer(model, JaxDataset(samples=samples, cfg=cfg), step,
                          opt, tc, exp_path=f"{exp}/segmentation",
                          exp_name="seg")
    crops = [jax_generate_sample(r.crop_seed + i, *r.crop_points)
             for i in range(args.samples * args.ee_mult)]
    rtc = JaxTrainConfig(lr=args.pose_lr,
                         batch_size=args.pose_batch or args.batch,
                         epochs=args.epochs,
                         save_freq=max(args.epochs // 2, 1))
    if stage == "rotation":
        cfg = JaxDataConfig(data_type="ee_seg", max_points=r.rot_max_points,
                            scale=200, center_at_origin=True)
        model = JaxEncode(
            backbone=args.backbone, in_channels=3,
            out_channels=(9 if args.rot_6d else 7)
            + (3 if args.confidence else 0),
            rot_dims=6 if args.rot_6d else 4)
        step, opt = jax_pose_step(
            model, cfg, JaxLossConfig(
                loss_type=(JaxLossType.COS2_6D if args.rot_6d
                           else JaxLossType.COS2),
                compute_confidence=args.confidence,
                symmetry_flip_axis="z" if args.symmetry_loss else None),
            rtc, voxel_capacity=r.rot_capacity)
        return JaxTrainer(model, JaxDataset(samples=crops, cfg=cfg), step,
                          opt, rtc, exp_path=f"{exp}/rotation",
                          exp_name="rot")
    cfg = JaxDataConfig(data_type="ee_seg", max_points=r.kp_max_points,
                        scale=800, center_at_origin=True,
                        keypoints_enabled=True, num_of_keypoints=6)
    model = JaxSegmentation(backbone=args.backbone, in_channels=3,
                            num_classes=6)
    ktc = JaxTrainConfig(lr=args.pose_lr, epochs=args.epochs,
                         save_freq=max(args.epochs // 2, 1),
                         batch_size=(args.kp_batch or min(
                             args.pose_batch or args.batch, 32)))
    step, opt = jax_seg_step(model, cfg, ktc, voxel_capacity=r.kp_capacity)
    return JaxTrainer(model, JaxDataset(samples=crops, cfg=cfg), step, opt,
                      ktc, exp_path=f"{exp}/key_points", exp_name="kp")


def fit_pair(stage, flags, tmp_path, recipe=TINY):
    """Both packages' trainer of ``stage`` from the JAX init, fitted:
    ``(port history, JAX history)``."""
    args = parser().parse_args(flags + ["--out", str(tmp_path / "port")])
    jt = jax_trainer(stage, args, recipe, tmp_path / "jax")
    port, epochs = make_trainers(args, recipe, "cpu")[stage]
    load_jax_variables(port.model, jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    return port.fit(epochs=epochs), jt.fit(epochs=epochs)


def check_histories(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["batches"] == w["batches"] == 2
        for k in w:
            if k in ("iter_time", "data_time", "lr", "batches"):
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=(
                ACCURACY_ATOL if k == "accuracy" else 1e-6), err_msg=k)
        assert g["lr"] == w["lr"]
    assert got[-1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("stage", ["segmentation", "key_points"])
def test_trainer_matches_jax(stage, tmp_path):
    check_histories(*fit_pair(stage, FLAGS, tmp_path))
