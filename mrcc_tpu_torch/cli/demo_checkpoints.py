"""Train demo checkpoints on the synthetic sample set and benchmark them
(port of ``scripts/train_demo_checkpoints.py``).

Trains the segmentation, rotation and keypoint nets on the port's
synthetic scenes and EE crops with ``Trainer`` (checkpoints under
``{out}/{segmentation,rotation,key_points}/`` with the reference's naming
and retention), hands the trained state dicts to an ``InferenceEngine``
(``params=``; int8 after ``calibrate_q8`` on one source frame with
``--conv-impl pallas-int8``) and runs ``BenchmarkApp`` over held-out
frames: the reference's train -> ``app/test.py`` workflow in one command.

    python -m mrcc_tpu_torch.cli.demo_checkpoints [--epochs 40]
        [--samples 24] [--device cpu]

The r2 recipe of ``RESULTS.md``: ``--samples 32 --epochs 40 --ee-mult 64
--pose-epochs 24 --bench-samples 20``.

Every flag keeps the JAX script's name, default and meaning, except:

- ``--train-conv-impl`` has no counterpart: the port routes every sparse
  conv by device (the hand-written kernels on the card, their plain twins
  on the CPU) and has no implementation switch;
- ``--mesh N`` trains data-parallel over the ``torch.distributed`` ranks
  that ``torchrun`` starts (``parallel.fleet``); a mesh needs every rank
  (``make_mesh`` raises otherwise), and only the first rank writes
  checkpoints and runs the benchmark;
- ``--device`` (new) runs on that device: the card by default, raising
  where there is none.

The JAX script hard-codes its scene and crop sizes, the nets' capacities
and the engine's; here they are the fields of :class:`Recipe`, whose
defaults are the JAX script's values (the tests shrink them; the command
line has no flag for them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import typing

import numpy as np

from ..app import InferenceConfig, InferenceEngine, SyntheticDataEngine
from ..data.dataset import AliveV2Dataset, DataConfig
from ..data.synthetic import generate_sample, gt_base2cam_pose
from ..device import resolve_device
from ..eval.benchmark import BenchmarkApp
from ..models import RobotNetEncode, RobotNetSegmentation
from ..sparse.nn import init_parameters
from ..train import (LossConfig, LossType, Trainer, TrainConfig,
                     make_pose_train_step, make_segmentation_train_step)

@dataclasses.dataclass(frozen=True)
class Recipe:
    """The sizes the JAX script hard-codes (its values are the defaults).

    Scenes are ``generate_sample(scene_seed + i, *scene_points)`` (EE, arm,
    background points), EE crops ``generate_sample(crop_seed + i,
    *crop_points)``, held-out frames ``bench_seed`` on with
    ``bench_points``.  ``*_max_points`` / ``*_capacity`` are the three
    datasets' point rows and the train steps' voxel capacities; the engine
    runs the pose and keypoint nets at the capacities they trained at."""

    scene_seed: int = 1000
    scene_points: typing.Tuple[int, int, int] = (2048, 3000, 7000)
    crop_seed: int = 20000
    crop_points: typing.Tuple[int, int, int] = (2048, 96, 96)
    seg_max_points: int = 16384
    seg_capacity: int = 8192
    rot_max_points: int = 4096
    rot_capacity: int = 2048
    kp_max_points: int = 4096
    kp_capacity: int = 4096
    point_capacity: int = 16384
    seg_voxel_capacity: int = 12288
    seg_hierarchy_caps: typing.Tuple[int, ...] = (9856, 6400, 2816, 896)
    ee_point_capacity: int = 4096
    icp_iterations: int = 15
    icp_template_points: int = 1024
    # synthetic EE crops carry ~2048 points; the reference's 2048-point
    # confidence gate would reject everything at ~90 % seg recall
    sanity_min_num_of_ee_points: int = 1024
    bench_seed: int = 5000
    bench_points: typing.Tuple[int, int, int] = (2048, 3000, 7000)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mrcc_tpu_torch.cli.demo_checkpoints",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="exp")
    ap.add_argument("--backbone", default="minkunet14A",
                    help="backbone of the three nets (14A trains fast; "
                         "'minkunet' for the flagship 18D)")
    ap.add_argument("--bench-samples", type=int, default=15)
    ap.add_argument("--ee-mult", type=int, default=6,
                    help="EE crops per scene: rotation regression needs far "
                         "more pose coverage than segmentation")
    ap.add_argument("--pose-epochs", type=int, default=None,
                    help="epochs of the rotation / keypoint nets (default: "
                         "--epochs)")
    ap.add_argument("--kp-epochs", type=int, default=None,
                    help="keypoint epochs (default: --pose-epochs; 0 "
                         "restores the keypoint checkpoint untouched)")
    ap.add_argument("--rot-6d", action="store_true",
                    help="the continuous 6D rotation head (COS2_6D)")
    ap.add_argument("--confidence", action="store_true",
                    help="train the cos2 confidence heads (the engine's "
                         "is_confident gate then reads trained weights)")
    ap.add_argument("--pose-batch", type=int, default=None,
                    help="rotation / keypoint batch (default: --batch)")
    ap.add_argument("--kp-batch", type=int, default=None,
                    help="keypoint batch (default: min(pose batch, 32))")
    ap.add_argument("--mesh", type=int, default=None,
                    help="data-parallel mesh size for training (the ranks "
                         "torchrun starts)")
    ap.add_argument("--pose-lr", type=float, default=1e-3,
                    help="rotation / keypoint lr")
    ap.add_argument("--conv-impl", default="auto",
                    help="engine conv impl of the held-out benchmark "
                         "(auto|pallas|pallas-int8|xla: every value but "
                         "pallas-int8 is the one bf16 route)")
    ap.add_argument("--skip-bench", action="store_true",
                    help="train only (chunked training: a later call "
                         "resumes from the latest checkpoints)")
    ap.add_argument("--bench-only", action="store_true",
                    help="no sample generation or training: restore the "
                         "three latest checkpoints and run the benchmark")
    ap.add_argument("--flip-disambiguation", action="store_true",
                    help="the keypoint-guided gripper-symmetry flip stage")
    ap.add_argument("--symmetry-loss", action="store_true",
                    help="symmetry-aware rotation loss (the better "
                         "180-about-z branch)")
    ap.add_argument("--no-k3-self-keyed", action="store_true",
                    help="neighbour tables on every engine level")
    ap.add_argument("--z-percentile", type=float, default=None,
                    help="percentile-z translation instead of the min-z")
    ap.add_argument("--json-out", default=None,
                    help="write the held-out table (Avg/Min/Max/Med/Std/N "
                         "per metric), the calibration and the config here")
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu runs the plain twins)")
    return ap


def _fit(trainer, epochs, label):
    """``trainer.fit(epochs)`` timed (None where nothing is trained)."""
    if not epochs:
        print(f"{label}: restored from checkpoint", flush=True)
        return None, 0.0
    t0 = time.perf_counter()
    hist = trainer.fit(epochs=epochs)
    seconds = time.perf_counter() - t0
    if hist:
        print(f"{label}: loss {hist[0]['loss']:.3f} -> "
              f"{hist[-1]['loss']:.3f} ({seconds:.0f}s)", flush=True)
    return hist, seconds


def make_trainers(args, recipe: Recipe, device, mesh=None):
    """The three trainers as the JAX script builds them (seeded init,
    restored from ``{out}/{stage}``'s latest checkpoint where there is
    one): ``{stage: (Trainer, epochs to fit)}``.  With ``--bench-only`` no
    sample is generated and nothing is to be fitted."""
    n_scenes = 0 if args.bench_only else args.samples
    samples = [generate_sample(recipe.scene_seed + i, *recipe.scene_points)
               for i in range(n_scenes)]
    # the pose and keypoint nets see only the EE crop: many cheap
    # EE-dominant samples for pose diversity
    n_crops = 0 if args.bench_only else args.samples * args.ee_mult
    ee_samples = [generate_sample(recipe.crop_seed + i, *recipe.crop_points)
                  for i in range(n_crops)]
    tc = TrainConfig(lr=1e-3, batch_size=args.batch, epochs=args.epochs,
                     save_freq=max(args.epochs // 2, 1))
    rtc = dataclasses.replace(tc, lr=args.pose_lr,
                              batch_size=args.pose_batch or args.batch)
    ktc = dataclasses.replace(
        rtc, batch_size=(args.kp_batch
                         or min(args.pose_batch or args.batch, 32)))
    pose_epochs = args.pose_epochs or args.epochs
    kp_epochs = (args.kp_epochs if args.kp_epochs is not None
                 else pose_epochs)

    seg_cfg = DataConfig(data_type=None, max_points=recipe.seg_max_points,
                         scale=200, center_at_origin=True)
    rot_cfg = DataConfig(data_type="ee_seg", max_points=recipe.rot_max_points,
                         scale=200, center_at_origin=True)
    kp_cfg = DataConfig(data_type="ee_seg", max_points=recipe.kp_max_points,
                        scale=800, center_at_origin=True,
                        keypoints_enabled=True, num_of_keypoints=6)
    rot_w = 9 if args.rot_6d else 7
    loss_cfg = LossConfig(
        loss_type=LossType.COS2_6D if args.rot_6d else LossType.COS2,
        compute_confidence=args.confidence,
        symmetry_flip_axis="z" if args.symmetry_loss else None)

    def seg_net(classes):
        return RobotNetSegmentation(backbone=args.backbone, in_channels=3,
                                    num_classes=classes)

    specs = (
        ("segmentation", "seg", seg_net(3), seg_cfg, samples, tc,
         recipe.seg_capacity, args.epochs),
        ("rotation", "rot", RobotNetEncode(
            backbone=args.backbone, in_channels=3,
            out_channels=rot_w + (3 if args.confidence else 0),
            rot_dims=6 if args.rot_6d else 4), rot_cfg, ee_samples, rtc,
         recipe.rot_capacity, pose_epochs),
        ("key_points", "kp", seg_net(6), kp_cfg, ee_samples, ktc,
         recipe.kp_capacity, kp_epochs))
    trainers = {}
    for stage, name, model, cfg, data, stc, cap, epochs in specs:
        init_parameters(model, stc.seed)
        if stage == "rotation":
            step, opt = make_pose_train_step(model, cfg, loss_cfg, stc,
                                             voxel_capacity=cap,
                                             device=device)
        else:
            step, opt = make_segmentation_train_step(model, cfg, stc,
                                                     voxel_capacity=cap,
                                                     device=device)
        trainers[stage] = (Trainer(
            model, AliveV2Dataset(samples=data, cfg=cfg), step, opt, stc,
            mesh=mesh, exp_path=os.path.join(args.out, stage),
            exp_name=name), 0 if args.bench_only else epochs)
    return trainers


def train(trainers) -> dict:
    """Fit each of :func:`make_trainers`' trainers in turn:
    ``{"history", "train_s", "k3_tables"}`` by stage (None and 0 s where
    nothing was fitted; the k3 route of each level, True on tables)."""
    out = {"history": {}, "train_s": {}, "k3_tables": {}}
    for stage, (trainer, epochs) in trainers.items():
        out["history"][stage], out["train_s"][stage] = _fit(
            trainer, epochs, trainer.exp_name)
        out["k3_tables"][stage] = trainer.step_fn.k3_tables
    return out


def engine_config(args, recipe: Recipe) -> InferenceConfig:
    """The JAX script's engine: occupancy-measured capacities for the
    synthetic scenes (saturated buffers drop voxels silently)."""
    return InferenceConfig(
        point_capacity=recipe.point_capacity,
        seg_voxel_capacity=recipe.seg_voxel_capacity,
        seg_hierarchy_caps=recipe.seg_hierarchy_caps,
        ee_point_capacity=recipe.ee_point_capacity,
        ee_voxel_capacity=recipe.rot_capacity,
        kp_voxel_capacity=recipe.kp_capacity,
        seg_backbone=args.backbone, rot_backbone=args.backbone,
        kp_backbone=args.backbone, icp_iterations=recipe.icp_iterations,
        icp_template_points=recipe.icp_template_points,
        kp_conf_threshold=0.5, conv_impl=args.conv_impl,
        rot_6d=args.rot_6d, compute_confidence=args.confidence,
        rot_flip_disambiguation=args.flip_disambiguation,
        translation_z_percentile=args.z_percentile,
        k3_self_keyed=not args.no_k3_self_keyed,
        sanity_min_num_of_ee_points=recipe.sanity_min_num_of_ee_points)


def bench_source(recipe: Recipe) -> SyntheticDataEngine:
    """The held-out frames (the segmentation study's seeds)."""
    n_ee, n_arm, n_bg = recipe.bench_points
    return SyntheticDataEngine(seed=recipe.bench_seed, n_ee=n_ee,
                               n_arm=n_arm, n_bg=n_bg)


def stats_table(metrics) -> dict:
    """Avg / Min / Max / Med / Std (population) / N of every metric with
    values, in float64."""
    table = {}
    for k, v in metrics.items():
        if not v:
            continue
        a = np.asarray(v, np.float64)
        table[k] = {"Avg": float(a.mean()), "Min": float(a.min()),
                    "Max": float(a.max()), "Med": float(np.median(a)),
                    "Std": float(a.std()), "N": int(a.size)}
    return table


def benchmark(args, recipe: Recipe, state_dicts, device):
    """``BenchmarkApp`` over ``--bench-samples`` held-out frames on an
    engine of the trained weights; ``(result, engine)``."""
    engine = InferenceEngine(engine_config(args, recipe), device=device,
                             params=state_dicts)
    source = bench_source(recipe)
    if engine.cfg.conv_impl == "pallas-int8":
        # static activation scales from one representative scene (the
        # benchmark then measures the calibrated int8 path)
        cal = source.get()
        cp, cr, cm, _, _ = engine._pad(cal.points, cal.rgb)
        engine.calibrate_q8(cp, cr, cm)
    app = BenchmarkApp(engine, source, gt_base2cam_pose(),
                       n_samples=args.bench_samples, ignore_unconfident=False)
    res = app.run(out_path=os.path.join(args.out, "trained_benchmark.xlsx"))
    print(json.dumps({k: round(float(np.mean(v)), 4)
                      for k, v in res["metrics"].items() if v}, indent=2),
          flush=True)
    print("calibration:", res["calibration"], flush=True)
    return res, engine


def run_config(args) -> dict:
    """The ``config`` section of ``--json-out`` (the JAX script's keys)."""
    return {"samples": args.samples, "epochs": args.epochs,
            "conv_impl": args.conv_impl, "ee_mult": args.ee_mult,
            "pose_epochs": args.pose_epochs or args.epochs,
            "pose_batch": args.pose_batch or args.batch,
            "backbone": args.backbone, "rot_6d": args.rot_6d,
            "confidence": args.confidence,
            "k3_self_keyed": not args.no_k3_self_keyed,
            "rot_flip_disambiguation": args.flip_disambiguation,
            "translation_z_percentile": args.z_percentile,
            "symmetry_loss": args.symmetry_loss}


def main(argv=None, device=None, recipe: Recipe = None) -> dict:
    """Run the demo; returns ``{"history", "train_s", "k3_tables",
    "trainers"}`` and, unless ``--skip-bench`` (or on a rank past the
    first), ``"table"``, ``"calibration"``, ``"config"`` (the
    ``--json-out`` layout), ``"metrics"`` (per frame) and ``"engine"``.
    ``device`` overrides ``--device``."""
    args = parser().parse_args(argv)
    recipe = recipe or Recipe()
    dev = resolve_device(device if device is not None else args.device)
    mesh = None
    if args.mesh:
        from ..parallel import fleet, make_mesh

        fleet.init_distributed(device=dev.type)
        mesh = make_mesh(args.mesh, dev.type)
    trainers = make_trainers(args, recipe, dev, mesh)
    out = train(trainers)
    out["trainers"] = {stage: t for stage, (t, _) in trainers.items()}
    if args.skip_bench:
        print("skip-bench: training chunk done", flush=True)
        return out
    if mesh is not None and mesh.get_local_rank() != 0:
        return out
    state_dicts = {stage: t.model.state_dict() for stage, t in
                   out["trainers"].items()}
    res, engine = benchmark(args, recipe, state_dicts, dev)
    out.update(
        table=stats_table(res["metrics"]),
        calibration=({k: float(v) for k, v in res["calibration"].items()}
                     if res["calibration"] else None),
        config=run_config(args), metrics=res["metrics"], engine=engine)
    out["k3_tables"]["engine"] = engine.k3_tables
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as fp:
            json.dump({k: out[k] for k in ("table", "calibration", "config")},
                      fp, indent=2)
        print(f"wrote {args.json_out}", flush=True)
    return out


if __name__ == "__main__":
    main()
