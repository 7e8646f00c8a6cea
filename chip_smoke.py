"""On-card smoke test of the PyTorch + CUDA port (``mrcc_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

The main paths: bf16 inference (``InferenceEngine.predict_batch_arrays``),
segmentation training (``make_segmentation_train_step``) on the self-keyed
route and on the k3-table route, int8 inference (``conv_impl=
"pallas-int8"``: ``calibrate_q8``, then ``predict_batch_arrays``),
production-scale inference in bf16 and int8 (B = 2 clouds of 131072
points, whose large levels take the k3-table route: rank-kernel tables and
the k3-table convs), ``icp_refine(use_pallas=True)`` (the
nearest-neighbour kernel), scene-scale segmentation training (its large
levels on tables: the table conv's autograd Function and the k3-table dW
kernel), pose training (``make_pose_train_step``), the user's path to
the extrinsic (an engine from checkpoint paths, ``predict`` frame by frame,
``calibrate``), the voting, sparse keypoint and feature-extractor train
steps, the sparse ResNet50 classifier on its strided pyramid, the
engine on the minkunet50 (bottleneck) backbone, and the dense PointNet2
path (the engine's ``kp_backbone="pointnet2"`` stage, dense keypoint and
keypoint-to-pose training), data parallelism, and the trained demo
pipeline (three nets trained by the kernels, then ``BenchmarkApp``).
Phases, each
printing one line and its wall time (any failure exits non-zero before the
last line):

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: compile the kernels of ``mrcc_tpu_torch/csrc`` (one nvcc per
   source, all started together), with ptxas register / smem lines;
3. kernels vs their plain PyTorch twins at the main paths' shapes (exact
   for the sort; relative norm 2e-2 for bf16 against the f32 twin, 1e-5 for
   f32; the int8 convs bit-equal to their plain twins and within 3e-2 of
   the unquantised f32 plain conv, their quantised operands bit-equal to
   the quantisation's twin; beside each int8 case its quantisation pass,
   B7's list stage and ``torch._int_mm`` over the hits' pre-gathered int8
   rows, each timed alone), timed with CUDA events: the sort at the
   inference, training and production point sorts and past 2^17 rows ([1,
   307200], [1, 2^20]), beside ``torch.argsort(stable=True)``; the
   self-keyed conv also at Cin 3 and 416 -> 384 in f32 and on a level of
   padding rows; the forward kernels at the inference shapes in bf16, the
   int8 ones at the int8 path's shapes (the seg net's, one split into
   channel groups; the production table level also on f32 features, as an
   int8 engine at ``compute_dtype="float32"`` runs it), beside each k3 conv
   (self-keyed and table) ``torch.mm`` over each offset's hit rows gathered
   beforehand (the GEMM alone), the dW kernels at the training shapes in
   f32 (the k3-table dW at the K2 dW's shapes on tables and at the
   scene-scale level 0; two launches bit-equal; their hit lists exactly
   equal to the plain twin's, the list kernel timed once per source; beside
   each, the 3xTF32 bound and ``torch.mm`` over the same hits' operands
   gathered beforehand, the GEMM alone), K3's down and up convs also at the
   training step's level pairs in f32 (up 1 -> 0 416 -> 384 and 3 -> 2 512
   -> 384, down 0 -> 1 384 -> 416) and the inference up 1 -> 0 128 -> 96
   (two launches bit-equal; their list stage and child sum or zero pass
   timed alone; the f32 error of kernel and twin against an f64 result; the
   3xTF32 and 4xTF32 bounds and ``torch.mm`` over the hits' gathered
   per-octant operands), the rank kernel (exact; with the share of its
   windows, a block's per group and row set, that search global memory;
   with the kernels' own device time beside the timed launches, as for NN)
   and the k3-table convs at the production levels' shapes and at the
   widest f32 training shape, the int8 one also at a two-group resident
   shape, the nearest-neighbour kernel (indices and d2 bit-equal to the
   twin, which rounds in the kernel's order); then the backward of each
   autograd conv Function (the self-keyed and the table k3 convs, down, up,
   also down / up at the level 0 <-> 1 pair at 384 <-> 416) on the card
   against autograd through the plain twins on the card (f32, 1e-5); then
   one full 640 x 480 frame (B = 1, P = 307200): ``measure_seg_caps``,
   ``voxelize`` and ``build_hierarchy`` on the card against the CPU, every
   integer output equal;
4. the inference slice on the card vs on the CPU: one engine pair with the
   same weights, f32 (the k3-table route on every level), small size
   (integer outputs exact, poses 1e-3); int8 pairs with the same weights
   and the same calibrated scales, self-keyed and with
   ``k3_self_keyed=False`` (seg labels equal on >= 99.5 % of points); and
   on the card, bf16 with ``k3_self_keyed=False`` against the self-keyed
   route, same weights (seg labels >= 99.5 %, bit-equality reported);
5. train steps on the card vs on the CPU from the same weights and batch,
   f32: minkunet14A segmentation, B=2, self-keyed and with
   ``k3_self_keyed=False`` (loss 1e-5, gradients 1e-4 and the update 1e-3
   in relative norm, BN statistics 1e-5), and one pose step
   (RobotNetEncode minkunet14A, cos2, B=2 EE crops; the loss and the four
   distances 1e-5, the same gradient, update and BN bounds);
6. the inference main path at full width (B=8, P=16384, minkunet18 seg/kp,
   the 18D encoder for rotation, bf16, capacities from the occupancy
   probe): 12 batches timed one by one with every launch count set to 0
   before and read after -> clouds/s (median, quartiles), one batch
   synchronised at each stage boundary, one batch under torch.profiler
   (device time by kernel, device idle share), and sanity checks;
7. segmentation training at full width (minkunet = 18D, 3 classes, B=8
   scenes of 24096 points, 0.01 m voxels, capacity 16384, f32, AdamW lr
   1e-4): 2 warm-up steps, 6 steps timed one by one with every launch count
   set to 0 before and read after -> steps/s and clouds/s (median,
   quartiles), one step synchronised at the prepare / forward / backward /
   optimizer boundaries, one step under torch.profiler, peak memory, and
   sanity checks (finite losses; the loss on the fixed batch falls; no
   plain twin called);
8. the int8 inference path at phase 6's full width: ``calibrate_q8`` on the
   batch, then as phase 6 (12 batches timed, stages, profiler, launches
   per batch of every counter), with the int8 kernels launched, the bf16
   conv kernels only by the rotation stage, no plain twin called, and the
   share of seg labels equal to phase 6's bf16 engine on the same batch;
9. production-scale inference (``bench.py``'s big profile: B = 2 clouds of
   131072 points, capacities from the occupancy probe, EE crops of 8192):
   bf16, then int8 after ``calibrate_q8``, each timed as phase 6, with the
   rank kernel and the k3-table convs launched on exactly the levels
   ``uses_k3_tables`` names and the self-keyed kernels on the others, no
   plain twin called; the two k3 routes side by side on seg level 0 (rank
   build + table convs against the self-keyed kernels, same convs); and
   ``icp_refine(use_pallas=True)`` on the batch's EE crop against the
   default ICP;
10. training on tables and the pose trainer, at full width, each timed as
    phase 7: (a) phase 7's configuration with ``k3_self_keyed=False``
    (every level on tables), first one step against the self-keyed step
    from the same weights and batch (loss 1e-5, gradients 1e-4,
    bit-equality reported), with the rank kernel, the table conv and the
    k3-table dW launched and the self-keyed kernels not; (b) scene-scale
    segmentation training (minkunet18D, B = 2 scenes of 98304 points,
    capacity 65536: levels 0-2 on tables by the JAX train step's gate,
    3-4 self-keyed), the route checked conv by conv, voxel overflow
    reported, 2 warm-up and 4 timed steps; (c) pose training on B = 8 EE
    crops at capacity 4096: RobotNet 18D with cos2 (``train_pose``'s
    default), then RobotNetEncode 18D with the pose criterion (the
    rotation-only override); RobotNet's K2 time by level and conv (CUDA
    events around each launch of one step);
11. the user's path, run after phase 6 (``calibrate``): the bench
    configuration with the 6D rotation head, the confidence heads, flip
    disambiguation and the 2nd percentile translation, capacities from the
    occupancy probe of its frames.  (1) The engine's three stages written
    as reference ``.pth`` files and as the port trainer's ``.ckpt``; an
    engine of another seed built from each set of paths alone gives
    ``torch.equal`` outputs on phase 6's batch.  (2) 12 frames of the
    port's ``SyntheticDataEngine`` (3 positions x 4 frames, 24096 points
    a frame, subsampled to the capacity) through ``predict`` after one
    warm-up frame, with every launch count set to 0 before and read after
    (K1, K2 and K3 launched, no plain twin called), then ``calibrate`` ->
    ``predict_ms`` (median, quartiles), ``calibrate_ms``, confident frames
    and ``pose_camera_link`` (none is an acceptable answer for random
    weights).  (3) ``calibrate`` on hand-built confident results around
    the true extrinsic, averaged on the card: within 1 cm and 0.01 in the
    quaternion.  (4) ``predict`` card vs CPU on three frames with the
    same weights at phase 4's small size: f32 labels exact, ``ee_pose`` /
    ``key_points_pose`` / ``base_pose`` within 1e-3 with ICP off (ICP from
    random nets' poses is chaotic, ROADMAP C5: reported after ICP),
    keypoint classes and ``is_confident`` equal; bf16 seg labels >= 98.5 %
    equal (random weights: bf16 alone moves ~1 % of the labels,
    ``SEG_AGREE_BF16``);
12. the rest of training, run after phase 10 c (``train_more``), each cell
    timed as phase 7 and run to 20 steps on its fixed batch: (a) the
    voting step (``RobotNetVote`` 18D, 2 classes) and (b) the sparse
    keypoint step (``RobotNetSegmentation`` 18D, 6 classes) on B = 8 EE
    crops (seeds 50-57, ``AliveV2Dataset`` with ``voting_enabled`` /
    ``keypoints_enabled``) at capacity 4096, 1 cm voxels, every level
    self-keyed; (c) the feature-extractor step (``FeatureNet``,
    minkunet34A -> 16, the mined triplet loss) on B = 8 ``YCBDataset``
    clouds of 1024 points (two of each of classes 0-3 of its 8 classes),
    5 mm voxels, capacity 1024, every level on tables.  Each cell first runs one step card vs CPU at a reduced copy
    (minkunet14A, B = 2 crops at capacity 1024; B = 4 clouds of two classes
    for (c)) at phase 5's gates, against the CPU step at the batch or, where
    a ReLU gate of that reference sits within rounding of 0, at the batch's
    features moved by +-1e-7 relative (ROADMAP C21), then checks finite
    losses (for a and b the
    last 5 of 20 below the first 5), every kernel of its k3 route launched
    and none of the other route's, and no plain twin; it logs steps/s,
    clouds/s, device busy ms and idle share, device time by kernel,
    launches per step, voxels per level and the 20 losses;
13. the strided-pyramid models (``resnet``), run after phase 12: (a) the
    kernel cases of the two modes this path adds, at the full-width
    ResNet's shapes (B = 8 x 12544 voxels of the bench clouds): K3's
    strided map conv at the stem (8 x 12544 -> 6272, 3 -> 64, bf16) and
    conv5 (8 x 196 -> 98, 2048 -> 2048, f32: after the stem the f32
    instance-norm parameters promote the features, as in JAX), f32 1e-5
    and bf16 2e-2 against the plain twin, two launches bit-equal, beside
    ``torch.mm`` over each offset's gathered hits; the rank kernel's
    child-table mode at the stem (k3 s2), its pool and the first stage
    (k2 s2) and conv5 (k3 s3), exact against the rank kernel's twin and
    on hits against ``child_table_plain``, beside ``torch.searchsorted``;
    (b) a reduced SparseResNet50 (planes 8-32, B = 2, capacity 2048) on
    the card and on the CPU with the same random weights: logits f32 1e-4
    and bf16 2e-2, every child map and neighbour table of its pyramid
    equal on hits; (c) SparseResNet50 at its published widths (planes
    64-512 x 4, conv5 2048 -> 2048, 153 M parameters) at B = 8 x 12544
    with the default stage capacities, in bf16 and in f32: one forward
    with every launch count set to 0 before and read after, 8 forwards
    timed -> forwards/s (median, quartiles), device busy ms and idle share
    (torch.profiler), peak memory, finite [8, 40] logits;
14. the bottleneck backbone (``bottleneck``): phase 4's f32 card-vs-CPU
    engine pair with minkunet50 seg and keypoint nets, then the minkunet50
    engine on phase 6's bench inputs in bf16 and in f32, each timed as
    phase 6 (clouds/s, stages, profiler, launches of every kernel of its
    k3 route);
15. the dense PointNet2 path (``dense``; no kernel of its own: its point
    ops are plain PyTorch, as the JAX package's are plain ``jnp``): (a)
    phase 4's small f32 engine with ``kp_backbone="pointnet2"`` (crops of
    1024 points, 512 dense inputs), uniform and farthest sampling, card vs
    CPU: the crop and the integer outputs equal, every FPS index equal,
    ball groups equal but for rows with a member whose f64 squared
    distance lies within 1e-6 of r^2 (counted), poses 1e-3; then the
    card's dense stage again with ``allow_tf32 = True``: the same indices
    and keypoints; (b) phase 6's inputs and configuration with the dense
    stage (2048 dense inputs), uniform, farthest and int8 + uniform, each
    as phase 6 (K1-K3 and, in int8, B6 / B7 launches > 0, no plain twin)
    with the keypoint stage split into sampling, model and Kabsch, and
    the FPS calls' ms, steps and CUDA launches on a line of their own
    (``dense_fps``); (c) dense keypoint training (PointNet2SSG, B = 32 x
    2048 FPS samples) and (d) keypoint-to-pose training (a frozen
    PointNet2SSG feeding PointNet(7), B = 32 x 4096 uniform samples), each
    first one step card vs CPU in float64 at phase 5's gates (f32 reported
    beside the CPU's own spread: ROADMAP C31), then timed as phase 7 and
    run to 20 steps, whose loss must fall;
16. config, evaluation and the app's entry points (``eval``), in a
    temporary directory: a seeded sample set (``write_sample_set``, 10
    samples, 8 in the train split over positions p1-p3) and a ``Config``
    of the defaults naming it.  (a) ``test_segmentation`` on the train
    split (the default STRUCTURE backbone, 18D, 3 classes, capacity 8192,
    batch 4, f32, every level on tables: K1, rank, the k3-table conv, K3
    down / up) -> instances/s and launches, then again on the CPU with
    the same weights: every instance's accuracy / precision / recall
    within 1e-3, each batch's point labels equal on 99.5 %; (b) ``test_pose``,
    ``test_key_points``, ``test_vote`` on the test split, card vs CPU:
    distances within 1e-4 m (relative above 1 m), the same keypoints
    found; (c) ``test_app`` (the default YAML's engine: minkunet 18D seg,
    rotation and keypoints, bf16, self-keyed, ICP on) over
    ``PickleDataEngine``, 12 frames -> frames/s, per-stage ms, the report's
    path and type, the calibration error; the first frame of each
    position through a CPU engine of the same weights: seg accuracy within
    0.01; (d)
    ``MainApp.run`` over ``SyntheticDataEngine`` (5 positions x 2 frames)
    and ``calibrate_directory`` over pickles and ``_points.npy`` pairs;
    (e) the int8 engines the port refused before its per-conv gate
    (``compute_dtype="float32"``; a 64-row seg level and a 448-row kp
    level; minkunet50) at phase 4's size, card vs CPU with the same
    weights and scales: every conv of the card's batch replayed on its
    own card inputs (the gate's route; int8 convs bit-equal to their
    twins, feature-dtype convs within 1e-5 / 2e-2 of the f32 conv), the
    wrappers each configuration must take, the seg logits within 10 %
    (int8 roundings amplify the devices' rounding differences through a
    random net, ROADMAP C32: labels and the seg convs' input drift
    reported), each timed over 5 batches; B7's k3-table, down and up modes
    on f32 features at the f32 engine's seg levels as kernel records of
    path ``q8r``.  Launches of paths ``ev`` (a), ``app`` (c) and ``q8r``
    (e).  Its CPU references of (a)-(c) are computed by a child process
    of this script (``--eval-references``), started right after the
    build on the last three cores (this process keeps the others) and
    read when phase 16 begins;
17. data parallelism and the host modules (``parallel``): (a) phase 6's
    engine on a 1-rank NCCL mesh (``parallel.make_mesh``): the plain
    batch and ``fleet.globalize`` of it give outputs bit-equal to the
    engine without a mesh, every kernel of its path launched; (b) two
    ranks on the one card (two processes of this script, ``--dp-rank``,
    over gloo: NCCL refuses two ranks on one device), spawned after the
    build: each rank's engine rows (4 + 4 of phase 6's batch) bit-equal to
    this process's engine on that shard; 3 data-parallel phase-7 steps
    (``Trainer(mesh=...).step``: global batch norms, loss counts and
    summed gradients) with losses within 1e-4 of the single-process step,
    both ranks' parameters and BN statistics bit-equal; steps/s printed
    (two ranks share one card: no measure of data-parallel speed); (c) the
    host runtime (``native``, built with the host compiler) on a 640 x 480
    frame against the card voxelizer, ``farthest_point_sample`` and
    ``query_ball_point``; (d) the ArUco baseline without cv2: the tag pose
    from synthetic corners card vs CPU, ICP of the template from ~5 mm,
    the app's cropped ICP and ``calibrate`` card vs CPU within twice the
    CPU's own spread over ULP moves of the points, which an ICP cut to 7
    of its 15 iterations must exceed; (e)
    ``write_html_viewer`` of the engine's output.  Launches of path ``dp``
    (the mesh call and both ranks' engine calls and steps); (b) also runs
    3 data-parallel steps of phase 12 c's feature extractor, whose triplet
    miner sees both ranks' embeddings (ROADMAP C35), at lr 1e-5 (at 1e-4
    nothing is mined after the first step), against one process on the
    same 8 clouds: losses within 1e-5 (absolute), the first step's
    gradient norm and the parameters within 1e-4 (relative), both ranks
    bit-equal;
18. the trained pipeline (``demo``): ``python -m mrcc_tpu_torch.cli.
    demo_checkpoints`` (``main``) on the card at a short recipe: the r2
    recipe's 32 scenes for 6 epochs (24 segmentation steps at batch 8),
    256 EE crops for 2 epochs of the rotation and keypoint nets
    (minkunet14A, the JAX script's capacities), then ``BenchmarkApp`` on
    the trained engine over 5 held-out frames (its table on one line).
    Gates: epoch-6 segmentation loss <= 0.2 and accuracy >= 0.95; finite
    pose losses, the keypoint loss falls; the checkpoints written, and
    ``--bench-only`` restoring an engine whose outputs on 2 frames are
    bit-equal to the trained one's and whose table is the same; every one
    of K1, K2, K3 down / up and the three dW kernels launched, no plain
    twin called; the trained seg labels of 2 frames card vs CPU equal on
    >= 99 % of points.  Launches of path ``dm``.

``python3 chip_smoke.py --calibrate`` builds the kernels and runs only
phase 11, ``--train-more`` only phase 12.  ``--pose-k2`` builds them and runs only that
K2 breakdown; ``--dw`` (``--k3``) builds them and times each dW launch
(each K3 down / up launch) of one phase-7 step and one phase-10 b step by
kernel and shape (CUDA events), ``--inference`` runs only phase 6 and
``--q8`` only phase 3's int8 cases and phase 8, ``--int8`` only phases 6
and 8, to compare two versions of the kernels in one call (copy this file
into a checkout of the other version).  ``--resnet`` builds the kernels and runs only phases 13 and 14,
``--dense`` only phase 15, ``--eval`` only phase 16 (its CPU references
then run first), ``--parallel`` only phase 17, ``--demo-short`` only phase
18.  ``--demo`` runs the demo at the r2 recipe of ``RESULTS.md`` (32
scenes x 40 epochs, 2048 crops x 24 epochs, 20 held-out frames): the bf16
table, the int8 engine on the same checkpoints (its table, its seg labels
against bf16 on the 20 frames, the share of each int8 conv's inputs that
its calibrated scale clips: ROADMAP C32, C33) and, in a child process on
the CPU (three cores), the trained engine's seg labels on 4 frames and its
own table over the 20; ``--demo RECORD.json`` also writes the whole record
(the tables, the per-conv clipping) to that file.
``--rank-nn`` times the rank and
NN kernels at phase 3's shapes under several values of their wrappers'
constants (rank: query rows a block and shared-window keys; NN: blocks in
flight), in turns, each run compared with its twin; ``--icp`` builds phase
9's bf16 engine and runs only its ``icp_refine(use_pallas=True)`` check
and timing, three times.  Phases 6-10 count K3's list stage and
child sum beside its down / up launches and report ``k3_device_ms`` (its
list kernel, list GEMM, child sum and zero pass) beside
``dw_device_ms``; phases 8 and 9 count the int8 convs' quantisation, list
and child-sum launches, and report ``q8_device_ms`` (every int8 kernel),
the CUDA kernel launches of a profiled batch and the launches per int8
conv call by kind.

f32 phases run with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).  The last lines are the card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and op/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "tf32": 495e12}
TOL_BF16, TOL_F32 = 2e-2, 1e-5
TOL_Q8 = 3e-2      # int8 conv vs the unquantised f32 conv (bench.py's bound)
SEG_AGREE = 0.995  # int8 card vs CPU: share of equal seg labels
# bf16 card vs CPU through predict (phase 11): the two sum in other orders,
# and with random weights bf16 alone moves ~1 % of the labels (phase 11's
# three frames on an H100: the CPU's bf16 vs its f32 98.84-98.90 %, card
# vs CPU bf16 98.86-99.28 %)
SEG_AGREE_BF16 = 0.985
TRAIN_CAPACITY = 16384  # voxel capacity of the full-width train step
SCENE_POINTS = 98304    # scene-scale training: points per cloud
SCENE_CAPACITY = 65536  # and its voxel capacity
POSE_CAPACITY = 4096    # EE crops (train_mains.ee_capacity of the defaults)

# each kernel's source, and the TPU kernel (file:line) each record replaces
SOURCES = {
    "argsort": "mrcc_tpu_torch/csrc/sort.cu",
    "conv_sk": "mrcc_tpu_torch/csrc/conv_sk.cu",
    "conv_down": "mrcc_tpu_torch/csrc/conv_map.cu",
    "conv_up": "mrcc_tpu_torch/csrc/conv_map.cu",
    "dw_sk": "mrcc_tpu_torch/csrc/conv_dw_sk.cu",
    "dw_down": "mrcc_tpu_torch/csrc/conv_dw_map.cu",
    "dw_up": "mrcc_tpu_torch/csrc/conv_dw_map.cu",
    "conv_sk_q8": "mrcc_tpu_torch/csrc/conv_sk_q8.cu",
    "conv_down_q8": "mrcc_tpu_torch/csrc/conv_map_q8.cu",
    "conv_up_q8": "mrcc_tpu_torch/csrc/conv_map_q8.cu",
    "rank": "mrcc_tpu_torch/csrc/rank.cu",
    "conv_k3map": "mrcc_tpu_torch/csrc/conv_map.cu",
    "conv_map": "mrcc_tpu_torch/csrc/conv_map.cu",
    "conv_k3map_q8": "mrcc_tpu_torch/csrc/conv_map_q8.cu",
    "q8_quantize": "mrcc_tpu_torch/csrc/q8_quantize.cuh",
    "nn_search": "mrcc_tpu_torch/csrc/nn_search.cu",
    "dw_k3map": "mrcc_tpu_torch/csrc/conv_dw_map.cu",
    "dw_lists": "mrcc_tpu_torch/csrc/hit_lists.cuh",
}
K2_TPU = "mrcc_tpu/ops/conv_pallas.py:767"    # _gather_gemm_call_sk
K3_TPU = "mrcc_tpu/ops/conv_pallas.py:120"    # _gather_gemm_call
HBM_TPU = "mrcc_tpu/ops/conv_pallas.py:1495"  # _gather_gemm_call_hbm
SK_Q8_TPU = "mrcc_tpu/ops/conv_pallas.py:845"    # _gather_gemm_call_sk_q8
MAP_Q8_TPU = "mrcc_tpu/ops/conv_pallas.py:1235"  # _gather_gemm_call_q8
# the quantisation of the int8 wrappers (gather_gemm_conv_sk_q8, and
# gather_gemm_conv_tiled_q8 around _gather_gemm_call_q8)
Q8_QUANT_TPU = "mrcc_tpu/ops/conv_pallas.py:1017"
RANK_TPU = "mrcc_tpu/ops/rank_pallas.py:89"     # _rank_call
NN_TPU = "mrcc_tpu/ops/nn_pallas.py:42"         # nn_search_pallas
PROD_POINTS = 131072  # bench.py's production profile (BENCH_POINTS)
FRAME_POINTS = 640 * 480  # one full depth frame
DW_TPU = {"dw_sk": "mrcc_tpu/ops/conv_pallas.py:1076",   # _dw_call_sk
          "dw_down": "mrcc_tpu/ops/conv_pallas.py:1691",  # _dw_call
          "dw_up": "mrcc_tpu/ops/conv_pallas.py:1691",
          "dw_k3map": "mrcc_tpu/ops/conv_pallas.py:1691"}


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


def ulps(got, want):
    """Largest |got - want| in ulps of the output type (bf16: 8 significant
    bits, f32: 24) at the larger magnitude."""
    bits = 8 if got.dtype == torch.bfloat16 else 24
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - (bits - 1))
    return float(((g - w).abs() / ulp).max())


def kernel_device_ms(fn, prefix, iters=20):
    """Device time (ms) a call of ``fn`` of the kernels whose names start
    with ``prefix`` (torch.profiler, ``iters`` calls after one warm-up):
    the kernels' own time, apart from the host's time to launch them."""
    fn()
    times = profile_device_ms(lambda: [fn() for _ in range(iters)])
    return sum(v for k, v in times.items() if k.startswith(prefix)) / iters


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- phases

def phase_build():
    from mrcc_tpu_torch.ops import conv, conv_q8, nn, rank, sort
    from mrcc_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    infos = build_all([sort.LIB, *conv.LIBRARIES, *conv_q8.LIBRARIES,
                       rank.LIB, nn.LIB])
    log("build", seconds=round(time.perf_counter() - t0, 3),
        sources={i.name: {"seconds": round(i.seconds, 3),
                          "ptxas": i.resource_lines()} for i in infos})


def bench_levels(device, batch=8, points=16384, seed=0, tables=False):
    """Inputs and the seg hierarchy of a bench profile (capacities from the
    occupancy probe); ``tables``: neighbour tables on the levels the bf16
    engine's route gives them."""
    from mrcc_tpu_torch.app import measure_seg_caps
    from mrcc_tpu_torch.data.synthetic import build_batch
    from mrcc_tpu_torch.geometry import center_at_origin
    from mrcc_tpu_torch.sparse import build_hierarchy, uses_k3_tables, voxelize

    pts, rgb, mask = build_batch(batch, points, seed=seed)
    caps = measure_seg_caps(pts, rgb, mask, device=device)
    p = torch.as_tensor(pts, device=device)
    m = torch.as_tensor(mask, device=device)
    c, _ = center_at_origin(p, mask=m)
    vox, _ = voxelize(c, torch.as_tensor(rgb, device=device), m, 1 / 200.0,
                      caps[0])
    levels = build_hierarchy(vox, 4, capacities=caps[1:], k3_tables=(
        tuple(uses_k3_tables(n) for n in caps) if tables else None))
    return (pts, rgb, mask), caps, levels


def train_batch(batch=8, seed=0):
    """The full-width training batch: ``batch`` synthetic scenes of 24096
    points, centred, padded to 65536 rows (``DataConfig`` defaults)."""
    from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset

    data = SceneDataset(DataConfig(data_type=None), batch, seed=seed)
    return data.collate(data.items)


def train_levels(batch, device, capacity=TRAIN_CAPACITY):
    """The hierarchy the train step builds for ``batch`` (0.01 m voxels,
    capacities ``hierarchy_caps(capacity)``, the self-keyed route where the
    JAX step's gate keeps it, tables elsewhere): at 16384 every level
    self-keys, at 65536 levels 0-2 take tables."""
    from mrcc_tpu_torch.sparse import (build_hierarchy, hierarchy_caps,
                                       train_uses_k3_tables, voxelize)

    vox, _ = voxelize(*(torch.as_tensor(batch[k], device=device)
                        for k in ("points", "feats", "mask")), 0.01,
                      capacity)
    caps = hierarchy_caps(capacity)
    return build_hierarchy(vox, 4, capacities=caps, k3_tables=tuple(
        train_uses_k3_tables(n) for n in (capacity,) + caps))


def scene_batch(batch=2, seed=40):
    """Scene-scale training batch: ``batch`` synthetic scenes of
    SCENE_POINTS points (12288 EE, 24576 arm, 61440 background), centred,
    padded to SCENE_POINTS rows."""
    from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset

    data = SceneDataset(DataConfig(max_points=SCENE_POINTS, data_type=None),
                        batch, seed=seed, n_ee=12288, n_arm=24576,
                        n_bg=61440)
    return data.collate(data.items)


def phase_kernels(levels, tlevels, plevels, slevels, device):
    """Each kernel vs its plain twin at the main paths' shapes: ``levels``
    of the inference path, ``tlevels`` of the training path, ``plevels`` of
    the production path (tables on its levels 0 and 1), ``slevels`` of the
    scene-scale training path (tables on its levels 0-2)."""
    from mrcc_tpu_torch.ops import conv, nn, rank, sort
    from mrcc_tpu_torch.sparse import neighbor_tables
    from mrcc_tpu_torch.sparse.hierarchy import K3_DELTAS

    gen, feats, weights = case_inputs(7, device)
    records = []

    # K1: duplicate-heavy [8, 16384] (many points per voxel) and [8, 12544]
    # on the inference path; the train step's [8, 65536] point keys; the
    # production point sort [2, 131072]; past the first kernel's 2^17
    # limit (C20): a full 640 x 480 frame [1, 307200] and [1, 2^20]
    for b, n, hi, path in ((8, 16384, 3000, "inference"),
                           (8, 12544, 1 << 30, "inference"),
                           (8, 65536, 16000, "training"),
                           (2, PROD_POINTS, 1 << 30, "production"),
                           (1, FRAME_POINTS, 1 << 30, "frame"),
                           (1, 1 << 20, 1 << 18, "frame")):
        key = torch.randint(0, hi, (b, n), generator=gen,
                            dtype=torch.int32).to(device)
        key[:, : n // 5] = 1 << 30  # KEY_PAD rows
        got = sort.argsort(key)
        want = sort.argsort_plain(key)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        if not exact:
            raise AssertionError(f"argsort [{b}, {n}] differs from the "
                                 "stable plain sort")
        ms = cuda_ms(lambda: sort.argsort(key))
        # key read once, sorted key and permutation written once; three
        # radix passes of one digit each per entry
        records.append(dict(
            name=f"argsort[{b}x{n}]", kernel="argsort", path=path,
            route="cuda", source=SOURCES["argsort"],
            replaces="mrcc_tpu/ops/sort_pallas.py:107", max_abs_err=0.0,
            tolerance="exact", ms=ms,
            plain_ms=cuda_ms(lambda: sort.argsort_plain(key)),
            library_ms=cuda_ms(lambda: torch.argsort(key, dim=-1,
                                                     stable=True)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b * n * 12, 3 * b * n, "f32")))))

    def conv_case(name, kernel, replaces, fn, plain, args32, work, k,
                  path="inference"):
        """Timed in bf16 on the inference path, in f32 on the training
        path (the dtype each path runs)."""
        errs = {}
        want = plain(*args32)
        got32 = fn(*args32)
        errs["f32"] = rel_err(got32, want)
        args16 = [a.to(torch.bfloat16) if a.is_floating_point() else a
                  for a in args32]
        got16 = fn(*args16)
        errs["bf16"] = rel_err(got16, want)
        if errs["f32"] > TOL_F32 or errs["bf16"] > TOL_BF16:
            raise AssertionError(f"{name}: relative error {errs} over "
                                 f"(f32 {TOL_F32}, bf16 {TOL_BF16})")
        kind, args, got = (("f32", args32, got32)
                           if path.startswith("training")
                           else ("bf16", args16, got16))
        cin, cout = args32[1].shape[1:]
        # the rows the hits gather, the weights, the whole output (padding
        # rows are written as zeros) and the map entries of valid rows
        nbytes = ((4 if kind == "f32" else 2)
                  * (work["read"] * cin + k * cin * cout + want.numel())
                  + work["map_bytes"])
        ops = 2 * work["hits"] * cin * cout
        bms, by = bound_ms(nbytes, ops, kind)
        records.append(dict(
            name=name, kernel=kernel, path=path, route="cuda",
            source=SOURCES[kernel], replaces=replaces,
            max_abs_err=float((got.float() - want).abs().max()),
            rel_err=errs, tolerance={"f32": TOL_F32, "bf16": TOL_BF16},
            dtype=kind, work=work, ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: plain(*args)), library_ms=None,
            bound_ms=bms, bound_by=by))
        if kernel in ("conv_sk", "conv_down", "conv_up"):
            # the f32 routes on tensor cores: K2's three TF32 products a
            # term, K3's four
            for terms in (3, 4) if kernel != "conv_sk" else (3,):
                records[-1][f"bound_{terms}xtf32_ms"] = max(
                    1e3 * terms * ops / PEAK_OPS["tf32"],
                    1e3 * nbytes / HBM_BYTES_PER_S) if kind == "f32" else None
        if kernel in ("conv_sk", "conv_k3map"):
            # the yardstick of rows 3-9: the GEMM alone over each offset's
            # hits (K2's from the rank kernel's tables of its level)
            tables = (args[2:4] if kernel == "conv_k3map" else
                      rank.rank_lookup(args[2], args[2], K3_DELTAS, args[3]))
            records[-1].update(gemm_ms=offset_gemm_ms(args[0], args[1],
                                                      *tables),
                               gemm_call=OFFSET_GEMM)
        if kernel in ("conv_down", "conv_up"):
            if not torch.equal(fn(*args), got):
                raise AssertionError(f"{name}: two launches differ")
            records[-1].update(k3_stages(kernel.removeprefix("conv_"),
                                         *args))
            # the f32 kernel and the f32 twin against the f64 result
            exact = k3_f64(kernel.removeprefix("conv_"), *args32)
            records[-1]["rel_err_f64"] = {
                "kernel_f32": float((got32.double() - exact).norm()
                                    / exact.norm()),
                "plain_f32": float((want.double() - exact).norm()
                                   / exact.norm())}

    for li, cin, cout in ((0, 3, 32), (0, 128, 96), (3, 384, 256)):
        lv = levels[li]
        b, n = lv.key.shape
        conv_case(f"conv_sk[{b}x{n} {cin}->{cout}]", "conv_sk", K2_TPU,
                  conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
                  [feats(lv, cin), weights(27, cin, cout), lv.key, lv.kbits],
                  _sk_work(lv), 27)
    # the training step's level 0: the stem (Cin 3), the widest decoder
    # conv (384 -> 384) and the skip-concatenated one (416 -> 384)
    lv = tlevels[0]
    b, n = lv.key.shape
    for cin, cout in ((384, 384), (3, 32), (416, 384)):
        conv_case(f"conv_sk[{b}x{n} {cin}->{cout} f32]", "conv_sk", K2_TPU,
                  conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
                  [feats(lv, cin), weights(27, cin, cout), lv.key, lv.kbits],
                  _sk_work(lv), 27, path="training")
    # a level whose rows are all padding (kbits 0): every tile skips every
    # offset and writes zeros
    lv = dataclasses.replace(levels[3], kbits=torch.zeros_like(
        levels[3].kbits))
    b, n = lv.key.shape
    conv_case(f"conv_sk[{b}x{n} 384->256 all padding]", "conv_sk", K2_TPU,
              conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
              [feats(lv, 384), weights(27, 384, 256), lv.key, lv.kbits],
              _sk_work(lv), 27)
    # K3 down at the inference path's first down conv; at the training
    # step's level 0 -> 1, where the JAX step streams the over-budget f32
    # table (_gather_gemm_call_hbm): the stem's down conv (32 -> 32) and the
    # data cotangent of the up conv 1 -> 0 (384 -> 384)
    for lvs, cin, cout, path, replaces in (
            (levels, 32, 32, "inference", K3_TPU),
            (tlevels, 32, 32, "training", HBM_TPU),
            (tlevels, 384, 384, "training", HBM_TPU),
            (tlevels, 384, 416, "training", HBM_TPU)):
        fine, coarse = lvs[0], lvs[1]
        b, nf = fine.key.shape
        nc = coarse.key.shape[1]
        conv_case(f"conv_down[{b}x{nf}->{nc} {cin}->{cout}"
                  + (" f32]" if path == "training" else "]"), "conv_down",
                  replaces, conv.gather_gemm_down,
                  conv.gather_gemm_down_plain,
                  [feats(fine, cin), weights(8, cin, cout), coarse.child_idx,
                   coarse.child_hit], _down_work(coarse), 8, path=path)
    # K3 up at the inference path's deepest level pair (256 -> 256) and
    # level 1 -> 0 (128 -> 96); at the training step's level 1 -> 0 (416 ->
    # 384, the skip-concatenated decoder conv: a product 416 deep) and
    # 3 -> 2 (512 -> 384)
    for lvs, li, cin, cout, path in ((levels, 3, 256, 256, "inference"),
                                     (levels, 0, 128, 96, "inference"),
                                     (tlevels, 0, 416, 384, "training"),
                                     (tlevels, 2, 512, 384, "training")):
        fine, coarse = lvs[li], lvs[li + 1]
        b, nf = fine.key.shape
        nc = coarse.key.shape[1]
        conv_case(f"conv_up[{b}x{nc}->{nf} {cin}->{cout}"
                  + (" f32]" if path == "training" else "]"), "conv_up",
                  K3_TPU, conv.gather_gemm_up, conv.gather_gemm_up_plain,
                  [feats(coarse, cin), weights(8, cin, cout), fine.parent_idx,
                   fine.row_ok, fine.octant], _up_work(fine), 8, path=path)

    q8_cases(levels, tlevels, plevels, feats, weights, records)

    # B8: the rank kernel builds the 27 tables of production seg levels 0
    # and 1; its library yardstick is torch.searchsorted over the same
    # queries (ranks only, no hits)
    for li in (0, 1):
        lv = plevels[li]
        b, n = lv.key.shape
        want = rank.rank_lookup_plain(lv.key, lv.key, K3_DELTAS, lv.kbits)
        got = rank.rank_lookup(lv.key, lv.key, K3_DELTAS, lv.kbits)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"rank [{b}x{n}] differs from its twin")
        d = torch.tensor(K3_DELTAS, dtype=torch.int32, device=device)
        q = (lv.key[None] + d[:, None, None]).permute(1, 0, 2).reshape(b, -1)
        # keys, query bases and bitmaps read once, 27 int32 + bool written;
        # 9 searches of log2(N) compares and 27 compares a row
        steps = 9 * max(1, int(np.ceil(np.log2(n)))) + 27
        wide = rank.rank_windows(lv.key, lv.key, K3_DELTAS)[2]
        records.append(dict(
            name=f"rank[{b}x{n} k3]", kernel="rank", path="production",
            route="cuda", source=SOURCES["rank"], replaces=RANK_TPU,
            max_abs_err=0.0, tolerance="exact", hits=int(want[1].sum()),
            global_share=float(wide.float().mean()),
            block_windows=int(wide.numel()),
            ms=cuda_ms(lambda: rank.rank_lookup(lv.key, lv.key, K3_DELTAS,
                                                lv.kbits)),
            device_ms=kernel_device_ms(lambda: rank.rank_lookup(
                lv.key, lv.key, K3_DELTAS, lv.kbits), "rank_kernel"),
            plain_ms=cuda_ms(lambda: rank.rank_lookup_plain(
                lv.key, lv.key, K3_DELTAS, lv.kbits)),
            library_ms=cuda_ms(lambda: torch.searchsorted(lv.key, q)),
            library_call="torch.searchsorted (ranks only)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(12 * b * n + 27 * 5 * b * n, steps * b * n,
                                "f32")))))

    # the k3-table convs at the production seg levels (bf16 over the TPU's
    # budget: _gather_gemm_call_hbm there) and at a resident shape (the
    # bench level 0, as k3_self_keyed=False runs it: _gather_gemm_call)
    lv_bench = _with_tables(levels[0])
    for lv, cin, cout, replaces in ((plevels[0], 3, 32, HBM_TPU),
                                    (plevels[0], 128, 96, HBM_TPU),
                                    (plevels[1], 128, 96, HBM_TPU),
                                    (lv_bench, 128, 96, K3_TPU)):
        b, n = lv.key.shape
        conv_case(f"conv_k3map[{b}x{n} {cin}->{cout}]", "conv_k3map",
                  replaces, conv.gather_gemm_k3_map,
                  conv.gather_gemm_k3_map_plain,
                  [feats(lv, cin), weights(27, cin, cout), lv.nbr_idx,
                   lv.nbr_hit], _table_work(lv), 27, path="production")
    # B10 at the ICP's shapes: 1024 template points over an EE crop
    for b, m, n in ((2, 1024, 8192), (8, 1024, 2048)):
        tmpl = (torch.randn((b, m, 3), generator=gen) * 0.05 + 0.8).to(device)
        tgt = (torch.randn((b, n, 3), generator=gen) * 0.05 + 0.8).to(device)
        mask = (torch.rand((b, n), generator=gen) > 0.2).to(device)
        idx, d2 = nn.nn_search(tmpl, tgt, mask)
        w_idx, w_d2 = nn.nn_search_plain(tmpl, tgt, mask)
        err = float((d2 - w_d2).abs().max())
        if not (torch.equal(idx, w_idx) and torch.equal(d2, w_d2)):
            raise AssertionError(f"nn_search [{b}x{m}x{n}]: d2 off by {err}, "
                                 f"{int((idx != w_idx).sum())} indices "
                                 "differ from the twin")
        records.append(dict(
            name=f"nn_search[{b}x{m}x{n}]", kernel="nn_search",
            path="icp_pallas", route="cuda", source=SOURCES["nn_search"],
            replaces=NN_TPU, max_abs_err=err, tolerance="exact",
            splits=nn.nn_splits(b, m, n),
            ms=cuda_ms(lambda: nn.nn_search(tmpl, tgt, mask)),
            device_ms=kernel_device_ms(lambda: nn.nn_search(tmpl, tgt, mask),
                                       "nn_"),
            plain_ms=cuda_ms(lambda: nn.nn_search_plain(tmpl, tgt, mask)),
            library_ms=None,
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(4 * (3 * b * m + 3 * b * n + 2 * b * m)
                                + b * n, 8 * b * m * n, "f32")))))

    listed = set()

    def dw_case(name, kernel, fn, plain, f, g, maps, work, path="training"):
        want = plain(f, g, *maps)
        got32 = fn(f, g, *maps)
        got16 = fn(f.bfloat16(), g.bfloat16(), *maps)
        errs = {"f32": rel_err(got32, want), "bf16": rel_err(got16, want)}
        if errs["f32"] > TOL_F32 or errs["bf16"] > TOL_BF16:
            raise AssertionError(f"{name}: relative error {errs} over "
                                 f"(f32 {TOL_F32}, bf16 {TOL_BF16})")
        if not torch.equal(fn(f, g, *maps), got32):
            raise AssertionError(f"{name}: two launches differ")
        k, cin, cout = want.shape
        # the feature rows the hits gather, the g rows of outputs with a
        # hit, dW once, and the map entries of valid rows
        nbytes = (4 * (work["read"] * cin + work["written"] * cout
                       + want.numel()) + work["map_bytes"])
        ops = 2 * work["hits"] * cin * cout
        bms, by = bound_ms(nbytes, ops, "f32")
        # the hit lists, exact against their twin; then the yardstick of
        # the GEMM alone: torch.mm over the operands of the same hits,
        # gathered beforehand (f32, TF32 off)
        kind = kernel.removeprefix("dw_")
        n_in = f.shape[1]
        lists = conv.dw_hit_lists(kind, n_in, *maps)
        twin = conv.dw_hit_lists_plain(kind, n_in, *maps)
        if not all(torch.equal(a, b) for a, b in zip(lists, twin)):
            raise AssertionError(f"{name}: hit lists differ from the twin")
        ff, gg = f.reshape(-1, cin), g.reshape(-1, cout)
        pairs = [(ff[lists[0][j, :c].long()], gg[lists[1][j, :c].long()])
                 for j, c in enumerate(lists[2].tolist())]
        gemm_ms = cuda_ms(lambda: [torch.mm(a.T, b) for a, b in pairs])
        del pairs
        records.append(dict(
            name=name, kernel=kernel, path=path, route="cuda",
            source=SOURCES[kernel], replaces=DW_TPU[kernel],
            max_abs_err=float((got32 - want).abs().max()), rel_err=errs,
            tolerance={"f32": TOL_F32, "bf16": TOL_BF16}, dtype="f32",
            work=work, ms=cuda_ms(lambda: fn(f, g, *maps)),
            plain_ms=cuda_ms(lambda: plain(f, g, *maps)), library_ms=None,
            bound_ms=bms, bound_by=by,
            bound_3xtf32_ms=max(1e3 * 3 * ops / PEAK_OPS["tf32"],
                                1e3 * nbytes / HBM_BYTES_PER_S),
            gemm_ms=gemm_ms,
            gemm_call="torch.mm(A_k.T, G_k) for each offset k, operands "
                      "gathered beforehand, f32, TF32 off"))
        if kind in listed:
            return
        # the list kernel once per source: the maps of valid rows read,
        # two ints a hit and the counts written
        listed.add(kind)
        raw = [m.contiguous() for m in maps]
        records.append(dict(
            name=f"dw_lists[{kind} {name.split('[', 1)[1].split(' ')[0]}]",
            kernel="dw_lists", path=path, route="cuda",
            source=SOURCES["dw_lists"], replaces=DW_TPU[kernel],
            max_abs_err=0.0, tolerance="exact", work=work,
            ms=cuda_ms(lambda: conv._launch_hit_lists(kind, n_in, raw)),
            plain_ms=cuda_ms(lambda: conv.dw_hit_lists_plain(kind, n_in,
                                                             *maps)),
            library_ms=None, **dict(zip(("bound_ms", "bound_by"), bound_ms(
                work["map_bytes"] + 8 * work["hits"] + 4 * k, 0, "f32")))))

    for li, cin, cout in ((0, 3, 32), (0, 416, 384), (0, 384, 384),
                          (4, 128, 256)):
        lv = tlevels[li]
        b, n = lv.key.shape
        dw_case(f"dw_sk[{b}x{n} {cin}x{cout}]", "dw_sk", conv.dw_sk,
                conv.dw_sk_plain, feats(lv, cin), feats(lv, cout),
                (lv.key, lv.kbits), _sk_work(lv))
    for li, cin, cout in ((0, 32, 32), (3, 128, 128)):
        fine, coarse = tlevels[li], tlevels[li + 1]
        b, nf = fine.key.shape
        nc = coarse.key.shape[1]
        dw_case(f"dw_down[{b}x{nf}->{nc} {cin}x{cout}]", "dw_down",
                conv.dw_down, conv.dw_down_plain, feats(fine, cin),
                feats(coarse, cout), (coarse.child_idx, coarse.child_hit),
                _down_work(coarse))
    for li, cin, cout in ((3, 256, 384), (0, 384, 384)):
        fine, coarse = tlevels[li], tlevels[li + 1]
        b, nf = fine.key.shape
        nc = coarse.key.shape[1]
        dw_case(f"dw_up[{b}x{nc}->{nf} {cin}x{cout}]", "dw_up", conv.dw_up,
                conv.dw_up_plain, feats(coarse, cin), feats(fine, cout),
                (fine.parent_idx, fine.row_ok, fine.octant), _up_work(fine))

    # the k3-table route of training: the dW kernel at dw_sk's shapes on
    # tables (phase 10 (a), every level on tables; f32 16384-row tables,
    # which the JAX step streams), at the scene-scale level 0 (phase 10
    # (b)), and the forward table conv at the widest training shape
    lv_train = dataclasses.replace(tlevels[0], **dict(zip(
        ("nbr_idx", "nbr_hit"), neighbor_tables(tlevels[0]))))
    for lv, cin, cout, path in ((lv_train, 3, 32, "training_tables"),
                                (lv_train, 416, 384, "training_tables"),
                                (lv_train, 384, 384, "training_tables"),
                                (slevels[0], 416, 384, "training_scene")):
        b, n = lv.key.shape
        dw_case(f"dw_k3map[{b}x{n} {cin}x{cout}]", "dw_k3map",
                conv.dw_k3_map, conv.dw_k3_map_plain, feats(lv, cin),
                feats(lv, cout), (lv.nbr_idx, lv.nbr_hit), _table_work(lv),
                path=path)
    b, n = lv_train.key.shape
    conv_case(f"conv_k3map[{b}x{n} 384->384 f32]", "conv_k3map", HBM_TPU,
              conv.gather_gemm_k3_map, conv.gather_gemm_k3_map_plain,
              [feats(lv_train, 384), weights(27, 384, 384), lv_train.nbr_idx,
               lv_train.nbr_hit], _table_work(lv_train), 27,
              path="training_tables")
    log("kernels", cases=[{k: r.get(k) for k in CASE_KEYS}
                          for r in records])
    return records


# what the kernel phase logs of each case
CASE_KEYS = ("name", "path", "replaces", "ms", "device_ms", "quantise_ms",
             "lists_ms", "plain_ms", "library_ms", "library_call", "bound_ms",
             "bound_by",
             "bound_3xtf32_ms", "bound_4xtf32_ms", "gemm_ms", "gemm_call",
             "stage_ms", "rel_err_f64", "work", "groups", "hits",
             "global_share", "block_windows", "splits", "max_abs_err",
             "rel_err", "tolerance")


OFFSET_GEMM = ("torch.mm(A_k, W_k) for each offset k over its hit rows, "
               "gathered beforehand, in the path's dtype (TF32 off)")


def offset_gemm_ms(f, w, idx, hit):
    """The GEMM alone of a k3 conv: ``torch.mm`` of each offset's hit rows
    of ``f`` [B, N, Cin] (``idx`` / ``hit`` [27, B, N], rows gathered
    beforehand) by its weight slice."""
    b, n, cin = f.shape
    flat = f.reshape(-1, cin)
    base = (torch.arange(b, device=f.device) * n)[:, None]
    rows = [flat[(i.long() + base)[h]] for i, h in zip(idx, hit)]
    ms = cuda_ms(lambda: [torch.mm(a, w[k]) for k, a in enumerate(rows)])
    del rows
    return ms


def case_inputs(seed, device):
    """``(generator, feats(level, c), weights(k, cin, cout))`` of the kernel
    cases: features zero on padding rows, weights scaled by
    1 / sqrt(k cin)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def feats(level, c):
        x = torch.randn(level.key.shape + (c,), generator=gen).to(device)
        return torch.where(level.valid[..., None], x, 0.0)

    def weights(k, cin, cout):
        return (torch.randn((k, cin, cout), generator=gen)
                / np.sqrt(k * cin)).to(device)

    return gen, feats, weights


def phase_int8_paths():
    """``--int8``: phase 6 (bf16) and phase 8 (int8) alone, on the same
    batch, for comparing kernel versions end to end (the counters a
    version lacks are left out)."""
    from mrcc_tpu_torch.ops import conv, conv_q8, sort

    inputs, caps, _ = bench_levels(torch.device("cuda"))
    counters = [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
                conv.K3_SUM]
    _, bf16_seg = phase_main_path(inputs, caps, counters)
    phase_int8_main_path(inputs, caps, counters + [
        getattr(conv_q8, n) for n in ("SK_Q8", "DOWN_Q8", "UP_Q8",
                                      "Q8_QUANT", "Q8_LISTS", "Q8_SUM")
        if hasattr(conv_q8, n)], bf16_seg)


def phase_q8_only():
    """``--q8``: the int8 convs' kernel cases and phase 8 alone (without
    its agreement with phase 6's labels), for comparing kernel versions."""
    from mrcc_tpu_torch.ops import conv, conv_q8, sort

    dev = torch.device("cuda")
    inputs, caps, levels = bench_levels(dev)
    plevels = bench_levels(dev, batch=2, points=PROD_POINTS, tables=True)[2]
    tlevels = train_levels(train_batch(), dev)
    records = []
    q8_cases(levels, tlevels, plevels, *case_inputs(7, dev)[1:], records)
    log("q8_kernels", card=smi_line(),
        cases=[{k: r.get(k) for k in CASE_KEYS} for r in records])
    phase_int8_main_path(inputs, caps, [
        sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS, conv.K3_SUM,
        conv_q8.SK_Q8, conv_q8.DOWN_Q8, conv_q8.UP_Q8, conv_q8.Q8_QUANT,
        conv_q8.Q8_LISTS, conv_q8.Q8_SUM], None)


def _with_tables(level):
    """``level`` with its neighbour tables (the rank kernel's)."""
    from mrcc_tpu_torch.sparse import neighbor_tables

    return dataclasses.replace(level, **dict(zip(("nbr_idx", "nbr_hit"),
                                                 neighbor_tables(level))))


def q8_case(records, name, kernel, replaces, mode, fn, plain, unquantised, f,
            w, maps, n_table, work, path="int8"):
    """An int8 conv on bf16 or f32 features (appended to ``records``):
    bit-equal to its plain twin (its int32 sums are exact), within TOL_Q8
    of the unquantised f32 plain conv, two launches bit-equal, its
    quantised operands bit-equal to the twin's.  ``ms`` is the wrapper
    (quantisation and kernels, what the path pays); ``quantise_ms`` the
    quantisation pass alone, ``lists_ms`` (down / up) the list stage
    alone, ``gemm_ms`` the yardstick of the integer product alone:
    ``torch._int_mm`` over each offset's hits, gathered beforehand."""
    from mrcc_tpu_torch.ops import conv, conv_q8

    want = plain(f, w, *maps)
    got = fn(f, w, *maps)
    err = {"ulps_vs_plain": ulps(got, want),
           "rel_vs_f32": rel_err(got, unquantised(f.float(), w, *maps))}
    if not torch.equal(got, want) or err["rel_vs_f32"] > TOL_Q8:
        raise AssertionError(f"{name}: {err} over (0 ulp, {TOL_Q8})")
    if not torch.equal(fn(f, w, *maps), got):
        raise AssertionError(f"{name}: two launches differ")
    k, cin, cout = w.shape
    octant = mode == "up"
    ops = conv_q8.quantize_operands(mode, f, w, n_table,
                                    per_octant=octant)
    twin = conv_q8.quantize_operands_plain(mode, f, w, n_table,
                                           per_octant=octant)
    if not all(torch.equal(a, b) for a, b in zip(ops[:3], twin[:3])):
        raise AssertionError(f"{name}: quantised operands differ from "
                             "the twin's")
    stages = {"quantise_ms": cuda_ms(lambda: conv_q8.quantize_operands(
        mode, f, w, n_table, per_octant=octant))}
    kind = {"k3": "sk", "k3_table": "k3map"}.get(mode, mode)
    if kind in ("down", "up"):
        stages["lists_ms"] = cuda_ms(lambda: q8_lists(kind, f.shape[1],
                                                      maps))
    fidx, _, count = conv.dw_hit_lists(kind, f.shape[1], *maps)
    rows = ops.q.reshape(-1, ops.cpad)
    pairs = []
    for j, c in enumerate(count.tolist()):
        idx = fidx[j, :c].long()
        if c <= 16:  # torch._int_mm takes more than 16 rows
            idx = torch.nn.functional.pad(idx, (0, 32 - c))
        pairs.append((rows[idx], ops.wq[j].t()))
    stages["gemm_ms"] = cuda_ms(
        lambda: [torch._int_mm(a, b) for a, b in pairs])
    del pairs, fidx, rows
    groups = ops.groups
    # int8 rows the hits gather, int8 weights, f32 scales, the output in
    # the features' dtype (padding rows included) and the map entries of
    # valid rows
    nbytes = (work["read"] * cin + k * cin * cout
              + 4 * len(groups) * (8 if octant else 1) * cout
              + want.element_size() * want.numel() + work["map_bytes"])
    bms, by = bound_ms(nbytes, 2 * work["hits"] * cin * cout, "int8")
    records.append(dict(
        name=name, kernel=kernel, path=path, route="cuda",
        source=SOURCES[kernel], replaces=replaces,
        max_abs_err=float((got.float() - want.float()).abs().max()),
        rel_err=err, tolerance={"ulps": 0, "rel_vs_f32": TOL_Q8},
        dtype=("f32" if f.dtype == torch.float32 else "bf16") + " -> int8",
        groups=len(groups), work=work,
        ms=cuda_ms(lambda: fn(f, w, *maps)), **stages,
        gemm_call="torch._int_mm(A_k, Wq_k^T) for each offset k, A_k "
                  "the hits' int8 rows gathered beforehand",
        plain_ms=cuda_ms(lambda: plain(f, w, *maps)), library_ms=None,
        bound_ms=bms, bound_by=by))
    if mode == "k3" and cin == 384:
        # the quantisation pass on its own record: x read, q written,
        # W read twice, wq and m written
        records.append(dict(
            name=f"q8_quantize[{name.split('[', 1)[1]}", kernel=
            "q8_quantize", path=path, route="cuda",
            source=SOURCES["q8_quantize"], replaces=Q8_QUANT_TPU,
            max_abs_err=0.0, tolerance="exact", ms=stages["quantise_ms"],
            plain_ms=cuda_ms(lambda: conv_q8.quantize_operands_plain(
                mode, f, w, n_table)), library_ms=None,
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                f.numel() * (2 + 1) + w.numel() * (4 + 1)
                + 4 * len(groups) * cout, 0, "int8")))))


def q8_cases(levels, tlevels, plevels, feats, weights, records):
    """The int8 convs' phase-3 cases (appended to ``records``): at the int8
    path's shapes and at the production int8 path's table levels, each with
    its stages timed alone and the ``torch._int_mm`` yardstick;
    ``feats(level, c)`` and ``weights(k, cin, cout)`` make the inputs."""
    from mrcc_tpu_torch.ops import conv, conv_q8

    # the int8 path's shapes: the seg net's stem, level-0 decoder and
    # level-3 decoder k3 convs (384 channels: three groups), its first down
    # conv and the 4 -> 3 up conv; a down conv over a 16384-row table at
    # 384 channels, which splits 256 + 128 (a 5 MiB table budget group)
    for li, cin, cout in ((0, 3, 32), (0, 128, 96), (3, 384, 256)):
        lv = levels[li]
        b, n = lv.key.shape
        q8_case(records, f"conv_sk_q8[{b}x{n} {cin}->{cout}]", "conv_sk_q8",
                SK_Q8_TPU, "k3", conv_q8.gather_gemm_sk_q8,
                conv_q8.gather_gemm_sk_q8_plain, conv.gather_gemm_sk_plain,
                feats(lv, cin).bfloat16(), weights(27, cin, cout),
                (lv.key, lv.kbits), n, _sk_work(lv))
    for lvs, cin, cout in ((levels, 32, 32), (tlevels, 384, 256)):
        fine, coarse = lvs[0], lvs[1]
        b, nf = fine.key.shape
        nc = coarse.key.shape[1]
        q8_case(records, f"conv_down_q8[{b}x{nf}->{nc} {cin}->{cout}]",
                "conv_down_q8", MAP_Q8_TPU, "down",
                conv_q8.gather_gemm_down_q8,
                conv_q8.gather_gemm_down_q8_plain,
                conv.gather_gemm_down_plain, feats(fine, cin).bfloat16(),
                weights(8, cin, cout), (coarse.child_idx, coarse.child_hit),
                nf, _down_work(coarse))
    fine, coarse = levels[3], levels[4]
    b, nf = fine.key.shape
    nc = coarse.key.shape[1]
    q8_case(records, f"conv_up_q8[{b}x{nc}->{nf} 256->256]", "conv_up_q8",
            MAP_Q8_TPU, "up", conv_q8.gather_gemm_up_q8,
            conv_q8.gather_gemm_up_q8_plain, conv.gather_gemm_up_plain,
            feats(coarse, 256).bfloat16(), weights(8, 256, 256),
            (fine.parent_idx, fine.row_ok, fine.octant), nc, _up_work(fine))

    # the table conv at the production int8 path's level 0 (128-channel
    # groups) and at a resident two-group shape
    lv = plevels[0]
    b, n = lv.key.shape
    q8_case(records, f"conv_k3map_q8[{b}x{n} 128->96]", "conv_k3map_q8",
            HBM_TPU, "k3_table", conv_q8.gather_gemm_k3_map_q8,
            conv_q8.gather_gemm_k3_map_q8_plain, conv.gather_gemm_k3_map_plain,
            feats(lv, 128).bfloat16(), weights(27, 128, 96),
            (lv.nbr_idx, lv.nbr_hit), n, _table_work(lv),
            path="production_int8")
    # and on f32 features there, as an int8 engine at
    # compute_dtype="float32" (path q8r) runs it on a production level
    q8_case(records, f"conv_k3map_q8[{b}x{n} 128->96 f32]", "conv_k3map_q8",
            HBM_TPU, "k3_table", conv_q8.gather_gemm_k3_map_q8,
            conv_q8.gather_gemm_k3_map_q8_plain, conv.gather_gemm_k3_map_plain,
            feats(lv, 128), weights(27, 128, 96), (lv.nbr_idx, lv.nbr_hit), n,
            _table_work(lv), path="q8r")
    lv = _with_tables(levels[0])
    b, n = lv.key.shape
    q8_case(records, f"conv_k3map_q8[{b}x{n} 384->256]", "conv_k3map_q8",
            MAP_Q8_TPU, "k3_table", conv_q8.gather_gemm_k3_map_q8,
            conv_q8.gather_gemm_k3_map_q8_plain, conv.gather_gemm_k3_map_plain,
            feats(lv, 384).bfloat16(), weights(27, 384, 256),
            (lv.nbr_idx, lv.nbr_hit), n, _table_work(lv),
            path="production_int8")


def q8_lists(kind, n_in, maps):
    """B7's list stage alone ("down" / "up"): its instantiation of the hit
    list kernel (Q8ChildMap / Q8ParentMap) into fresh buffers."""
    from mrcc_tpu_torch.ops import conv, conv_q8
    from mrcc_tpu_torch.ops.build import ptr, stream_ptr

    raw = [m.contiguous() for m in maps]
    b, n = raw[0].shape[-2:]
    lists, status, count = conv._list_buffers(8, b * n, raw[0].device)
    conv_q8.MAP_Q8_LIB.call(f"mrcc_conv_{kind}_lists_q8", *map(ptr, raw),
                            ptr(lists), ptr(status), ptr(count), b, n_in, n,
                            stream_ptr(raw[0]))
    return lists, count


def k3_f64(kind, f, w, *maps):
    """K3's down or up conv in f64 on the card (the reference of the f32
    kernel's and twin's rounding)."""
    from mrcc_tpu_torch.ops.conv import _gather

    f, w = f.double(), w.double()
    if kind == "down":
        idx, hit = maps
        return sum(torch.where(hit[k][..., None], _gather(f, idx[k]), 0.0)
                   @ w[k] for k in range(8))
    parent, ok, octant = maps
    g = torch.where(ok[..., None], _gather(f, parent), 0.0)
    return sum(torch.where((octant == k)[..., None], g @ w[k], 0.0)
               for k in range(8))


def k3_stages(kind, f, w, *maps):
    """K3's stages at one down / up case (``f``, ``w`` in the dtype the
    path runs): the list stage and the child sum (down) or zero pass (up)
    timed alone, and the yardstick of the GEMM alone: ``torch.mm`` over the
    per-octant operands of the same hits, gathered beforehand, summed over
    the octants (f32 with TF32 off, or bf16)."""
    from mrcc_tpu_torch.ops import conv
    from mrcc_tpu_torch.ops.build import ptr, stream_ptr

    n_in = f.shape[1]
    raw = [m.contiguous() for m in maps]
    stage_ms = {"lists": cuda_ms(
        lambda: conv._launch_hit_lists(kind, n_in, raw, k3=True))}
    cout = w.shape[-1]
    if kind == "down":
        y = torch.randn(f.shape[:2] + (cout,), device=f.device)
        stage_ms["child_sum"] = cuda_ms(
            lambda: conv.child_sum(y, *raw, f.dtype))
    else:
        out = torch.empty(raw[0].shape + (cout,), dtype=f.dtype,
                          device=f.device)
        sfx = "f32" if f.dtype == torch.float32 else "bf16"
        stage_ms["zero_rows"] = cuda_ms(lambda: conv.MAP_LIB.call(
            f"mrcc_zero_rows_{sfx}", ptr(raw[1]), ptr(raw[2]), ptr(out),
            out.shape[0] * out.shape[1], cout, stream_ptr(out)))
    fidx, _, count = conv.dw_hit_lists(kind, n_in, *raw)
    ff = f.reshape(-1, f.shape[-1])
    pairs = [(ff[fidx[k, :c].long()], w[k])
             for k, c in enumerate(count.tolist())]
    return {"stage_ms": stage_ms,
            "gemm_ms": cuda_ms(lambda: [torch.mm(a, b) for a, b in pairs]),
            "gemm_call": "torch.mm(A_k, W_k) for each octant k, A_k the "
                         f"hits' rows gathered beforehand, {f.dtype}, TF32 "
                         "off"}


def phase_backward(tlevels, device):
    """Backward of each autograd conv Function at a training level (kernels)
    against autograd through the plain forward twins, both on the card."""
    from mrcc_tpu_torch.ops import conv
    from mrcc_tpu_torch.sparse import conv as C

    gen = torch.Generator(device="cpu").manual_seed(9)

    def feats(level, c):
        x = torch.randn(level.key.shape + (c,), generator=gen).to(device)
        return torch.where(level.valid[..., None], x, 0.0)

    from mrcc_tpu_torch.sparse import neighbor_tables

    l0, l1, l2, l3, l4 = tlevels
    t2 = dataclasses.replace(l2, **dict(zip(("nbr_idx", "nbr_hit"),
                                            neighbor_tables(l2))))
    cases = {
        "k3[level 2 128x128]": (
            27, 128, 128, l2, l2, lambda f, w: C.conv_k3(f, w, l2),
            lambda f, w: conv.gather_gemm_sk_plain(f, w, l2.key, l2.kbits)),
        "k3map[level 2 128x128]": (
            27, 128, 128, t2, t2, lambda f, w: C.conv_k3(f, w, t2),
            lambda f, w: conv.gather_gemm_k3_map_plain(f, w, t2.nbr_idx,
                                                       t2.nbr_hit)),
        "down[level 0->1 32x32]": (
            8, 32, 32, l0, l1, lambda f, w: C.conv_down(f, w, l0, l1),
            lambda f, w: conv.gather_gemm_down_plain(f, w, l1.child_idx,
                                                     l1.child_hit)),
        "up[level 4->3 256x384]": (
            8, 256, 384, l4, l3,
            lambda f, w: C.conv_transpose_up(f, w, l4, l3),
            lambda f, w: conv.gather_gemm_up_plain(
                f, w, l3.parent_idx, l3.row_ok, l3.octant)),
        # the widest level pair: the data cotangent of each runs the other
        # conv at 8 x 16384 rows
        "down[level 0->1 384x416]": (
            8, 384, 416, l0, l1, lambda f, w: C.conv_down(f, w, l0, l1),
            lambda f, w: conv.gather_gemm_down_plain(f, w, l1.child_idx,
                                                     l1.child_hit)),
        "up[level 1->0 416x384]": (
            8, 416, 384, l1, l0,
            lambda f, w: C.conv_transpose_up(f, w, l1, l0),
            lambda f, w: conv.gather_gemm_up_plain(
                f, w, l0.parent_idx, l0.row_ok, l0.octant)),
    }
    errs = {}
    for name, (taps, cin, cout, src, dst, fn, plain) in cases.items():
        f0 = feats(src, cin)
        w0 = (torch.randn((taps, cin, cout), generator=gen) / 8).to(device)
        ct = feats(dst, cout)
        grads = []
        before = conv.DW_K3MAP.launches
        for run in (fn, plain):
            f = f0.clone().requires_grad_()
            w = w0.clone().requires_grad_()
            (run(f, w) * ct).sum().backward()
            grads.append((f.grad, w.grad))
        errs[name] = {"dfeats": rel_err(grads[0][0], grads[1][0]),
                      "dW": rel_err(grads[0][1], grads[1][1])}
        if name.startswith("k3map") and conv.DW_K3MAP.launches != before + 1:
            raise AssertionError(f"backward {name}: the k3-table dW kernel "
                                 "did not run")
        if max(errs[name].values()) > TOL_F32:
            raise AssertionError(f"backward {name}: {errs[name]} over "
                                 f"{TOL_F32}")
    log("backward", tolerance=TOL_F32, rel_err=errs)


def phase_frame(counters, seed=60):
    """C20 on the path: ``measure_seg_caps``, ``voxelize`` and
    ``build_hierarchy`` (depth 4, self-keyed bitmaps) of one full 640 x 480
    frame (B = 1, P = 307200) on the card and on the CPU; every integer
    output exactly equal.  Returns the launches of the card's voxelize +
    build_hierarchy."""
    from mrcc_tpu_torch.app import measure_seg_caps
    from mrcc_tpu_torch.data.synthetic import build_batch
    from mrcc_tpu_torch.geometry import center_at_origin
    from mrcc_tpu_torch.sparse import build_hierarchy, voxelize

    pts, rgb, mask = build_batch(1, FRAME_POINTS, seed=seed)
    caps = measure_seg_caps(pts, rgb, mask, device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        p, c, m = (torch.as_tensor(x, device=dev) for x in (pts, rgb, mask))
        cen, _ = center_at_origin(p, mask=m)
        if dev == "cuda":
            torch.cuda.synchronize()
            for ctr in counters:
                ctr.launches = 0
        t = time.perf_counter()
        with plain_calls() as plain:
            vox, pv = voxelize(cen, c, m, 1 / 200.0, caps[0])
            levels = build_hierarchy(vox, 4, capacities=caps[1:])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {ctr.name: ctr.launches for ctr in counters}
            if plain:
                raise AssertionError(f"frame: plain twins called: {plain}")
        out[dev] = (vox, pv, levels, 1e3 * (time.perf_counter() - t))
    (gv, gpv, glv, g_ms), (cv, cpv, clv, c_ms) = out["cuda"], out["cpu"]
    pairs = [("vox." + k, getattr(gv, k), getattr(cv, k))
             for k in ("off", "key", "valid", "count")]
    pairs.append(("point_to_voxel", gpv, cpv))
    for li, (a, b) in enumerate(zip(glv, clv)):
        for k in ("off", "key", "valid", "count", "parent_idx", "parent_ok",
                  "row_ok", "octant", "child_idx", "child_hit", "kbits"):
            if getattr(b, k) is not None:
                pairs.append((f"level{li}.{k}", getattr(a, k), getattr(b, k)))
    differ = [name for name, a, b in pairs if not torch.equal(a.cpu(), b)]
    if differ:
        raise AssertionError(f"frame: card vs CPU differ in {differ}")
    if not launches.get("argsort"):
        raise AssertionError(f"frame: the sort kernel did not run: "
                             f"{launches}")
    log("frame", points=FRAME_POINTS, real_points=int(mask.sum()),
        capacities=list(caps), voxels=[int(lv.count[0]) for lv in glv],
        equal_outputs=len(pairs), feats_max_abs_err=float(
            (gv.feats.cpu() - cv.feats).abs().max()),
        card_ms=g_ms, cpu_ms=c_ms, launches=launches)
    return launches


def _sk_work(level):
    """K2's work on this run's data: ``hits`` (row, offset) pairs with a
    real neighbour, the distinct rows they gather (``read``), the rows with
    at least one (``written``), and the key and bitmap bytes of the valid
    rows (``map_bytes``)."""
    from mrcc_tpu_torch.ops.conv import _K3_DELTAS, _sk_neighbours

    b, n = level.key.shape
    key = level.key.contiguous()
    read = torch.zeros((b, n + 1), dtype=torch.bool, device=key.device)
    written = torch.zeros_like(level.valid)
    hits = 0
    for k, d in enumerate(_K3_DELTAS):
        idx, hit = _sk_neighbours(key, level.kbits, k, d)
        hits += int(hit.sum())
        read.scatter_(1, torch.where(hit, idx, n).long(), True)
        written |= hit
    return {"hits": hits, "read": int(read[:, :n].sum()),
            "written": int(written.sum()),
            "map_bytes": 8 * int(level.count.sum())}


def _table_work(level):
    """The k3-table conv's work: the table's hits, the distinct rows they
    gather, the rows with one, and 27 index + hit entries of valid rows."""
    b, n = level.key.shape
    hit = level.nbr_hit
    read = torch.zeros((b, n + 1), dtype=torch.bool, device=hit.device)
    read.scatter_(1, torch.where(hit, level.nbr_idx, n).permute(1, 0, 2)
                  .reshape(b, -1).long(), True)
    return {"hits": int(hit.sum()), "read": int(read[:, :n].sum()),
            "written": int(hit.any(dim=0).sum()),
            "map_bytes": 27 * 5 * int(level.count.sum())}


def _down_work(coarse):
    """K3 down's work: each hit gathers its own fine row; the child map's
    8 index + hit entries of every valid coarse row."""
    hits = int(coarse.child_hit.sum())
    return {"hits": hits, "read": hits,
            "written": int(coarse.child_hit.any(dim=0).sum()),
            "map_bytes": 8 * 5 * int(coarse.count.sum())}


def _up_work(fine):
    """K3 up's work: one hit per ``row_ok`` row; the distinct parents they
    gather; parent index, row mask and octant of every valid fine row."""
    b, n = fine.key.shape
    ok = fine.row_ok
    n_par = int(fine.parent_idx.max()) + 2
    read = torch.zeros((b, n_par), dtype=torch.bool, device=ok.device)
    read.scatter_(1, torch.where(ok, fine.parent_idx, n_par - 1).long(),
                  True)
    return {"hits": int(ok.sum()), "read": int(read[:, :-1].sum()),
            "written": int(ok.sum()), "map_bytes": 9 * int(fine.count.sum())}


def _quat_close(a, b, tol):
    d = torch.minimum((a - b).abs().amax(-1), (a + b).abs().amax(-1))
    return bool((d <= tol).all()), float(d.max())


def phase_card_vs_cpu(seg_backbone="minkunet18", kp_backbone="minkunet18"):
    """Same weights, f32, small size: card engine vs CPU engine."""
    from mrcc_tpu_torch.app import (InferenceConfig, InferenceEngine,
                                    measure_seg_caps)
    from mrcc_tpu_torch.data.synthetic import build_batch

    pts, rgb, mask = build_batch(2, 2048, seed=11)
    caps = measure_seg_caps(pts, rgb, mask, device="cpu")
    cfg = InferenceConfig(
        point_capacity=2048, seg_voxel_capacity=caps[0],
        seg_hierarchy_caps=caps[1:], ee_point_capacity=1024,
        ee_voxel_capacity=1024, kp_voxel_capacity=512,
        ee_hierarchy_caps=(512, 256, 128, 64),
        kp_hierarchy_caps=(384, 256, 128, 64), icp_iterations=15,
        icp_template_points=512, seg_backbone=seg_backbone,
        rot_backbone="minkunet18", kp_backbone=kp_backbone,
        compute_dtype="float32")
    cpu = InferenceEngine(cfg, device="cpu", seed=3)
    gpu = InferenceEngine(cfg, device="cuda", seed=5)
    for stage, model in gpu.models().items():
        model.load_state_dict(cpu.models()[stage].state_dict())
    want = cpu.predict_batch_arrays(pts, rgb, mask)
    got = {k: v.cpu() for k, v in
           gpu.predict_batch_arrays(pts, rgb, mask).items()}
    for k in ("segmentation", "seg_overflow", "ee_count", "kp_found",
              "kp_ok"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"card vs CPU: {k} differs")
    report = {}
    for k in ("ee_pose", "kp_pose"):
        pos_err = float((got[k][:, :3] - want[k][:, :3]).abs().max())
        ok_q, q_err = _quat_close(got[k][:, 3:], want[k][:, 3:], 1e-3)
        report[k] = {"pos": pos_err, "quat": q_err}
        if pos_err > 1e-3 or not ok_q:
            raise AssertionError(f"card vs CPU: {k} off by {report[k]}")
    log("card_vs_cpu", seg_backbone=seg_backbone, kp_backbone=kp_backbone,
        ee_count=want["ee_count"].tolist(), max_err=report)


def _small_bf16_config(**kw):
    """phase 4's small bf16 engine configuration (B = 2, P = 2048)."""
    from mrcc_tpu_torch.app import InferenceConfig, measure_seg_caps
    from mrcc_tpu_torch.data.synthetic import build_batch

    pts, rgb, mask = build_batch(2, 2048, seed=11)
    caps = measure_seg_caps(pts, rgb, mask, device="cpu")
    cfg = InferenceConfig(
        point_capacity=2048, seg_voxel_capacity=caps[0],
        seg_hierarchy_caps=caps[1:], ee_point_capacity=1024,
        ee_voxel_capacity=1024, kp_voxel_capacity=512,
        ee_hierarchy_caps=(512, 256, 128, 64),
        kp_hierarchy_caps=(384, 256, 128, 128), icp_iterations=15,
        icp_template_points=512, seg_backbone="minkunet18",
        rot_backbone="minkunet18", kp_backbone="minkunet18",
        compute_dtype="bfloat16", **kw)
    return (pts, rgb, mask), cfg


def phase_bf16_routes_on_card():
    """bf16 on the card, same weights: ``k3_self_keyed=False`` (the
    k3-table route on every level) against the default route.  The table
    conv and K2 share their tile arithmetic, so every output is expected
    bit-equal; the check is seg labels >= 99.5 % equal, finite poses."""
    from mrcc_tpu_torch.app import InferenceEngine

    (pts, rgb, mask), cfg = _small_bf16_config()
    sk = InferenceEngine(cfg, device="cuda", seed=3)
    tables = InferenceEngine(dataclasses.replace(cfg, k3_self_keyed=False),
                             device="cuda", seed=5)
    for stage, model in tables.models().items():
        model.load_state_dict(sk.models()[stage].state_dict())
    want = sk.predict_batch_arrays(pts, rgb, mask)
    got = tables.predict_batch_arrays(pts, rgb, mask)
    m = torch.as_tensor(mask, device="cuda")
    agree = float((got["segmentation"] == want["segmentation"])[m]
                  .float().mean())
    report = {"seg_agree": agree, "tolerance": {"seg_agree": SEG_AGREE},
              "bit_equal": {k: bool(torch.equal(got[k], want[k]))
                            for k in want},
              "k3_tables": tables.k3_tables}
    finite = all(bool(torch.isfinite(got[k]).all())
                 for k in ("ee_pose", "kp_pose"))
    if agree < SEG_AGREE or not finite or not all(tables.k3_tables["seg"]):
        raise AssertionError(f"bf16 tables vs self-keyed: {report}")
    log("bf16_tables_vs_self_keyed", **report)


def phase_int8_card_vs_cpu(k3_self_keyed=True):
    """Same weights and calibrated scales, bf16 / int8, small size: card
    engine vs CPU engine; ``k3_self_keyed=False``: the k3-table route (the
    resident int8 table plan) on every level."""
    from mrcc_tpu_torch.app import InferenceEngine

    (pts, rgb, mask), cfg = _small_bf16_config(
        conv_impl="pallas-int8", k3_self_keyed=k3_self_keyed)
    cpu = InferenceEngine(cfg, device="cpu", seed=3).calibrate_q8(pts, rgb,
                                                                   mask)
    gpu = InferenceEngine(cfg, device="cuda", seed=5)
    for stage, model in gpu.models().items():
        model.load_state_dict(cpu.models()[stage].state_dict())
    want = cpu.predict_batch_arrays(pts, rgb, mask)
    got = {k: v.cpu() for k, v in
           gpu.predict_batch_arrays(pts, rgb, mask).items()}
    m = torch.as_tensor(mask)
    agree = float((got["segmentation"] == want["segmentation"])[m]
                  .float().mean())
    report = {"seg_agree": agree, "tolerance": {"seg_agree": SEG_AGREE},
              "ee_count": [want["ee_count"].tolist(),
                           got["ee_count"].tolist()],
              "kp_found_equal": bool(torch.equal(got["kp_found"],
                                                 want["kp_found"]))}
    for k in ("ee_pose", "kp_pose"):
        report[k + "_max_abs_diff"] = float((got[k] - want[k]).abs().max())
    finite = all(bool(torch.isfinite(got[k]).all())
                 for k in ("ee_pose", "kp_pose"))
    if agree < SEG_AGREE or not finite:
        raise AssertionError(f"int8 card vs CPU: {report}")
    log("int8_card_vs_cpu" if k3_self_keyed else "int8_tables_card_vs_cpu",
        k3_tables=gpu.k3_tables, **report)


def bench_config(pts, caps, **kw):
    """The JAX bench configuration (``bench.py:276-314``) at full width;
    with more than 32768 points its production profile (``big``: EE crops
    of 8192 points and voxels, kp capacity 4096)."""
    from mrcc_tpu_torch.app import InferenceConfig

    big = pts.shape[1] > 32768
    return InferenceConfig(
        point_capacity=pts.shape[1], seg_voxel_capacity=caps[0],
        seg_hierarchy_caps=caps[1:],
        ee_point_capacity=8192 if big else 2048,
        ee_voxel_capacity=8192 if big else 2048,
        kp_voxel_capacity=4096 if big else 1024,
        ee_hierarchy_caps=(4096, 1536, 512, 128) if big
        else (1024, 384, 128, 128),
        kp_hierarchy_caps=(3072, 2560, 1536, 512) if big
        else (768, 640, 384, 128), icp_iterations=15,
        icp_template_points=1024, **{
            **dict(seg_backbone="minkunet18", rot_backbone="minkunet",
                   kp_backbone="minkunet18", compute_dtype="bfloat16"),
            **kw})


@contextlib.contextmanager
def plain_calls():
    """Count calls of every plain twin of ``ops`` (the wrappers look them up
    by module attribute, so a counting stand-in sees each one)."""
    from mrcc_tpu_torch.ops import conv, conv_q8, nn, rank, sort

    calls, saved = {}, []
    for mod in (sort, conv, conv_q8, rank, nn):
        for name in dir(mod):
            if not name.endswith("_plain"):
                continue
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def k3_calls():
    """Record every k3 conv of a run: ``(level rows, level carries tables,
    Cin, Cout, the k3 kernel counters it moved)``."""
    from mrcc_tpu_torch.ops import conv, conv_q8
    from mrcc_tpu_torch.sparse import conv as C

    ctrs = (conv.SK, conv.K3MAP, conv_q8.SK_Q8, conv_q8.K3MAP_Q8)
    calls, orig = [], C.conv_k3

    def recorded(feats, weights, level, *a, **kw):
        before = [c.launches for c in ctrs]
        out = orig(feats, weights, level, *a, **kw)
        calls.append((level.key.shape[1], level.nbr_idx is not None,
                      feats.shape[-1], weights.shape[-1],
                      tuple(c.name for c, n in zip(ctrs, before)
                            if c.launches != n)))
        return out

    C.conv_k3 = recorded
    try:
        yield calls
    finally:
        C.conv_k3 = orig


def check_k3_routes(engine, p, c, m):
    """Drive the three stages one by one and hold every level's k3 route
    to ``engine.k3_tables`` (the JAX engine's route): the rank kernel once
    per table level, each k3 conv of a table level through the k3-table
    kernel, of the other levels through the self-keyed one, no plain twin.
    Returns ``{stage: {"table_levels", "rank", "convs"}}`` and the seg
    level-0 conv shapes."""
    from mrcc_tpu_torch.ops import rank

    report, seg0 = {}, []
    stages = (("seg", lambda: engine.seg_stage(p, c, m)),
              ("rot", lambda: engine.pose_stage(*seg[2:5])),
              ("kp", lambda: engine.kp_stage(*seg[2:5])))
    seg = None
    with plain_calls() as plain:
        for stage, run in stages:
            rank.RANK.launches = 0
            with k3_calls() as calls:
                out = run()
                torch.cuda.synchronize()
            if stage == "seg":
                seg = out
            caps = engine.level_caps[stage]
            route = engine.k3_tables[stage]
            q8 = stage != "rot" and engine.cfg.conv_impl == "pallas-int8"
            want_tables = {n for n, t in zip(caps, route) if t}
            kind = ("conv_k3map_q8", "conv_sk_q8") if q8 else ("conv_k3map",
                                                              "conv_sk")
            bad = [cl for cl in calls
                   if cl[4] != ((kind[0],) if cl[1] else (kind[1],))
                   or cl[1] != (cl[0] in want_tables)]
            got_tables = {cl[0] for cl in calls if cl[1]}
            if (bad or got_tables != want_tables
                    or rank.RANK.launches != sum(route)):
                raise AssertionError(
                    f"{stage}: k3 route {route} over {caps}: tables on "
                    f"{sorted(got_tables)}, rank launches "
                    f"{rank.RANK.launches}, wrong convs {bad[:4]}")
            report[stage] = {
                "table_levels": [l for l, t in enumerate(route) if t],
                "rank": rank.RANK.launches,
                "convs": {k: sum(1 for cl in calls if cl[4] == (k,))
                          for k in kind}}
            if stage == "seg":
                seg0 = [(cl[2], cl[3]) for cl in calls if cl[0] == caps[0]]
    if plain:
        raise AssertionError(f"plain twins called: {plain}")
    return report, seg0


def _sk_q8_groups(f, w, level, groups):
    """B6 on its kernel with the given channel groups (its wrapper takes
    ``_sk_plan``'s, which has none for levels over 40960 rows)."""
    from mrcc_tpu_torch.ops import conv_q8

    return conv_q8._tile_launch(
        conv_q8.SK_Q8_LIB, "mrcc_conv_sk_q8", f, w,
        (level.key.contiguous(), level.kbits.contiguous()), "k3", None,
        groups=groups)


def compare_k3_routes(engine, p, c, m, shapes, q8):
    """Seg level 0 of the batch: route A (rank build of the 27 tables, then
    every k3 conv of the level through the table conv) against route B
    (the same convs through the self-keyed kernel; int8: B6 with the same
    128-channel groups), timed with CUDA events; dynamic int8 scales on
    both."""
    from mrcc_tpu_torch.geometry import center_at_origin, normalize_colors
    from mrcc_tpu_torch.ops import conv, conv_q8
    from mrcc_tpu_torch.sparse import neighbor_tables, voxelize

    cfg = engine.cfg
    rgb = normalize_colors(c, mask=m)
    svox, _ = voxelize(center_at_origin(p, mask=m)[0], rgb, m,
                       1.0 / cfg.seg_scale, cfg.seg_voxel_capacity)
    lv = engine._hierarchy(svox, "seg")[0]
    b, n = lv.key.shape
    gen = torch.Generator(device="cpu").manual_seed(13)
    args = []
    for cin, cout in shapes:
        f = torch.randn((b, n, cin), generator=gen).to(p.device)
        f = torch.where(lv.valid[..., None], f, 0.0).to(torch.bfloat16)
        w = (torch.randn((27, cin, cout), generator=gen)
             / np.sqrt(27 * cin)).to(p.device)
        args.append((f, w if q8 else w.bfloat16()))

    def route_a():
        idx, hit = neighbor_tables(lv)
        conv_fn = conv_q8.gather_gemm_k3_map_q8 if q8 else \
            conv.gather_gemm_k3_map
        return [conv_fn(f, w, idx, hit) for f, w in args]

    def route_b():
        if q8:
            return [_sk_q8_groups(f, w, lv, conv_q8.q8_channel_groups(
                "k3_table", n, f.shape[-1])) for f, w in args]
        return [conv.gather_gemm_sk(f, w, lv.key, lv.kbits) for f, w in args]

    agree = max((ulps if q8 else rel_err)(x, y)
                for x, y in zip(route_a(), route_b()))
    if agree > (1.0 if q8 else TOL_BF16):
        raise AssertionError(f"routes A and B disagree on level 0: {agree}")
    idx, hit = neighbor_tables(lv)
    return {"level_rows": [b, n], "convs": [list(x) for x in shapes],
            "route_a_ms": cuda_ms(route_a, iters=5),
            "rank_ms": cuda_ms(lambda: neighbor_tables(lv), iters=5),
            "route_b_ms": cuda_ms(route_b, iters=5),
            "a_vs_b": {"ulps" if q8 else "rel_err": agree},
            "table_hits": int(hit.sum())}


def phase_production(inputs, caps, counters, paths, iters=8):
    """Production-scale inference (``bench.py``'s big profile), bf16 then
    int8 after ``calibrate_q8``; returns the launches of one batch of each
    (``paths``: the two path names) and of ``icp_refine(use_pallas=True)``."""
    from mrcc_tpu_torch.app import InferenceEngine

    pts, rgb, mask = inputs
    if caps[0] <= 40960:
        raise AssertionError(f"production seg level 0 of {caps[0]} rows: "
                             "not over 40960, the route is not shown")
    launches = {}
    for path, impl in zip(paths, ("auto", "pallas-int8")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngine(bench_config(pts, caps, conv_impl=impl),
                                 seed=0)
        dev = engine.device
        p = torch.as_tensor(pts, device=dev)
        c = torch.as_tensor(rgb, device=dev)
        m = torch.as_tensor(mask, device=dev)
        extra = {}
        if impl == "pallas-int8":
            t = time.perf_counter()
            engine.calibrate_q8(p, c, m)
            torch.cuda.synchronize()
            extra["calibrate_ms"] = 1e3 * (time.perf_counter() - t)
        engine.predict_batch_arrays(p, c, m)  # warm-up
        torch.cuda.synchronize()
        for ctr in counters:
            ctr.launches = 0
        with plain_calls() as plain:
            out = engine.predict_batch_arrays(p, c, m)
            torch.cuda.synchronize()
        launches[path] = {ctr.name: ctr.launches for ctr in counters}
        if plain:
            raise AssertionError(f"{path}: plain twins called: {plain}")
        routes, seg0 = check_k3_routes(engine, p, c, m)
        report = _inference_report(engine, (p, c, m), out, iters)
        ab = compare_k3_routes(engine, p, c, m, seg0,
                               impl == "pallas-int8")
        if impl == "pallas-int8":
            extra["launches_per_q8_call"] = q8_launches_per_call(
                launches[path], report)
        log(path, batch=int(pts.shape[0]), points=int(pts.shape[1]),
            seg_caps=list(caps), level_caps=engine.level_caps,
            k3_tables=engine.k3_tables, k3_routes=routes,
            launches=launches[path], level0_routes=ab, **extra, **report)

    launches["icp_pallas"] = icp_pallas(engine, p, c, m, counters)
    return launches


def icp_pallas(engine, p, c, m, counters, iters=5):
    """``icp_refine(use_pallas=True)`` on the engine's EE crop of the batch
    (15 iterations, NN launched 15 times) against the default ICP: both
    timed (CUDA events, ``iters`` calls), NN's own device time a call, the
    poses compared.  Returns the launches of one call."""
    from mrcc_tpu_torch.ops import nn
    from mrcc_tpu_torch.solve import icp_refine

    seg = engine.seg_stage(p, c, m)
    ee_pose, _ = engine.pose_stage(*seg[2:5])
    for ctr in counters:
        ctr.launches = 0
    kern = icp_refine(engine.template, seg[2], seg[4], ee_pose,
                      iterations=15, use_pallas=True)
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.launches for ctr in counters}
    if launches[nn.NN.name] != 15:
        raise AssertionError(f"icp_refine(use_pallas=True) launched "
                             f"{launches}")
    plain_icp = icp_refine(engine.template, seg[2], seg[4], ee_pose,
                           iterations=15)
    icp = {}
    for name, use in (("kernel", True), ("default", False)):
        icp[name + "_ms"] = cuda_ms(lambda: icp_refine(
            engine.template, seg[2], seg[4], ee_pose, iterations=15,
            use_pallas=use), iters=iters, warmup=1)
    icp["nn_device_ms"] = kernel_device_ms(lambda: icp_refine(
        engine.template, seg[2], seg[4], ee_pose, iterations=15,
        use_pallas=True), "nn_", iters=iters)
    poses = torch.cat([kern, plain_icp])
    qn = poses[:, 3:].norm(dim=-1)
    dq = torch.minimum((kern[:, 3:] - plain_icp[:, 3:]).abs().amax(-1),
                       (kern[:, 3:] + plain_icp[:, 3:]).abs().amax(-1))
    icp.update(pos_diff=float((kern[:, :3] - plain_icp[:, :3]).abs().max()),
               quat_diff=float(dq.max()),
               finite=bool(torch.isfinite(poses).all()),
               unit=bool(((qn - 1).abs() < 1e-3).all()),
               ee_count=seg[1].tolist())
    if not (icp["finite"] and icp["unit"]):
        raise AssertionError(f"icp_refine(use_pallas=True): {icp}")
    log("icp_pallas", iterations=15, template_points=1024, launches=launches,
        **icp)
    return launches


def phase_icp(rounds=3):
    """``--icp``: phase 9's bf16 production engine and batch, then only
    :func:`icp_pallas`, ``rounds`` times (to compare NN versions in one
    call: copy this file into a checkout of the other version)."""
    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.ops import nn

    (pts, rgb, mask), caps, _ = bench_levels(torch.device("cuda"), batch=2,
                                             points=PROD_POINTS)
    engine = InferenceEngine(bench_config(pts, caps), seed=0)
    p, c, m = (torch.as_tensor(x, device=engine.device)
               for x in (pts, rgb, mask))
    for _ in range(rounds):
        icp_pallas(engine, p, c, m, [nn.NN], iters=10)


def phase_main_path(inputs, caps, counters, iters=12):
    """The bench configuration at full width; returns per-kernel launches
    and the batch's seg labels."""
    from mrcc_tpu_torch.app import InferenceEngine

    pts, rgb, mask = inputs
    engine = InferenceEngine(bench_config(pts, caps), seed=0)
    dev = engine.device
    p = torch.as_tensor(pts, device=dev)
    c = torch.as_tensor(rgb, device=dev)
    m = torch.as_tensor(mask, device=dev)
    engine.predict_batch_arrays(p, c, m)  # warm-up (builds, allocator)
    torch.cuda.synchronize()

    for ctr in counters:
        ctr.launches = 0
    out = engine.predict_batch_arrays(p, c, m)
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.launches for ctr in counters}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    report = _inference_report(engine, (p, c, m), out, iters)
    log("main_path", batch=int(pts.shape[0]), points=int(pts.shape[1]),
        seg_caps=list(caps), launches=launches, **report)
    return launches, out["segmentation"]


CALIBRATE_HEADS = dict(rot_6d=True, compute_confidence=True,
                       rot_flip_disambiguation=True,
                       translation_z_percentile=2.0)


def _stream_frames(n, point_capacity, seed=300):
    """``n`` frames of the port's ``SyntheticDataEngine`` (3 positions, 4
    frames each; 24096 points a frame), and their subsampled padded batch
    for the occupancy probe (``InferenceEngine._pad``'s rule)."""
    from mrcc_tpu_torch.app import (InferenceConfig, InferenceEngine,
                                    SyntheticDataEngine)

    source = SyntheticDataEngine(n_positions=3, frames_per_position=4,
                                 seed=seed)
    frames = [source.get() for _ in range(n)]
    pad = InferenceEngine(InferenceConfig(point_capacity=point_capacity),
                          calibration_only=True)._pad
    padded = [pad(f.points, f.rgb)[:3] for f in frames]
    return frames, tuple(np.concatenate(a) for a in zip(*padded))


def _save_stages(engine, root):
    """``engine``'s stages as reference ``.pth`` files
    (``{"model_state_dict": ...}``) and as the port trainer's ``.ckpt``."""
    from mrcc_tpu_torch.train import checkpoint_save

    fields = ("seg_checkpoint", "rot_checkpoint", "kp_checkpoint")
    pth, ckpt = {}, {}
    for field, (stage, model) in zip(fields, engine.models().items()):
        path = f"{root}/{stage}.pth"
        torch.save({"model_state_dict": model.state_dict()}, path)
        pth[field] = path
        ckpt[field] = checkpoint_save(model, torch.optim.AdamW(
            model.parameters()), root, stage, 1)
    return pth, ckpt


def _known_extrinsic(engine, seed=0):
    """``calibrate`` on 3 positions x 4 confident results around the true
    extrinsic (position noise 3 mm, quaternion 0.002): the averages run on
    the engine's card.  Returns the position and quaternion errors."""
    from mrcc_tpu_torch.app import ResultDTO
    from mrcc_tpu_torch.data.synthetic import gt_base2cam_pose

    rng = np.random.default_rng(seed)
    want = gt_base2cam_pose().astype(np.float32)
    want_q = want[3:] / np.linalg.norm(want[3:])
    data = {}
    for pos in ("p1", "p2", "p3"):
        rows = []
        for _ in range(4):
            r = ResultDTO(segmentation=None, is_confident=True)
            r.ee_pose = np.zeros(7, np.float32)
            noise = np.concatenate([rng.normal(size=3) * 0.003,
                                    rng.normal(size=4) * 0.002])
            r.base_pose = np.concatenate([want[:3], want_q]) + noise
            r.key_points_base_pose = r.base_pose.copy()
            rows.append(r)
        data[pos] = rows
    got = engine.calibrate(data).pose_camera_link
    if got is None:
        raise AssertionError("known extrinsic: no pose_camera_link")
    q_err = min(np.linalg.norm(got[3:] - want_q),
                np.linalg.norm(got[3:] + want_q))
    return float(np.abs(got[:3] - want[:3]).max()), float(q_err)


def _engines_same_weights(cfg, seed=3):
    """``{(dtype, device): engine}`` for bf16 and f32 on the card and the
    CPU; one seed gives every engine the same weights (drawn on the CPU).
    Seed 3's nets find the EE in phase 11's frames, so the f32 pair
    compares poses and keypoints."""
    from mrcc_tpu_torch.app import InferenceEngine

    return {(dtype, device): InferenceEngine(
        dataclasses.replace(cfg, compute_dtype=dtype), device=device,
        seed=seed) for dtype in ("bfloat16", "float32")
        for device in ("cpu", "cuda")}


def _pose_err(a, b):
    """Largest position and quaternion (up to sign) difference; None where
    both are None, inf where one is."""
    if a is None or b is None:
        return None if a is None and b is None else float("inf")
    q = min(np.abs(a[3:] - b[3:]).max(), np.abs(a[3:] + b[3:]).max())
    return float(max(np.abs(a[:3] - b[:3]).max(), q))


def _predict_card_vs_cpu(frames):
    """Check 4: phase 4's small configuration with the four options on,
    ``frames`` over the point capacity through ``predict``, card vs CPU
    with the same weights: bf16 seg labels >= SEG_AGREE_BF16 equal (the
    CPU's own bf16 vs f32 agreement reported beside); f32 labels exact,
    ee_pose / key_points_pose / base_pose within 1e-3 with ICP off,
    keypoint classes and is_confident equal.  ICP from the poses of random
    nets is chaotic (ROADMAP C5): the f32 poses after ICP are reported,
    not held (phases 4 and 9 hold ICP)."""
    _, cfg = _small_bf16_config(
        ee_point_counts_threshold=64, sanity_min_num_of_ee_points=256,
        **CALIBRATE_HEADS)
    engines = _engines_same_weights(cfg)
    pose_keys = ("ee_pose", "key_points_pose", "base_pose")
    report, failed = [], False
    for frame in frames:
        out = {k: e.predict(frame) for k, e in engines.items()}
        bf16 = out["bfloat16", "cuda"], out["bfloat16", "cpu"]
        f32 = out["float32", "cuda"], out["float32", "cpu"]
        with_icp = {k: _pose_err(getattr(f32[0], k), getattr(f32[1], k))
                    for k in pose_keys}
        for k in ("cuda", "cpu"):
            engines["float32", k].cfg.icp_enabled = False
        got, want = (engines["float32", k].predict(frame)
                     for k in ("cuda", "cpu"))
        for k in ("cuda", "cpu"):
            engines["float32", k].cfg.icp_enabled = True
        errs = {k: _pose_err(getattr(got, k), getattr(want, k))
                for k in pose_keys}
        row = {
            "bf16_seg_agree": float((bf16[0].segmentation
                                     == bf16[1].segmentation).mean()),
            "cpu_bf16_f32_seg_agree": float((bf16[1].segmentation
                                             == f32[1].segmentation).mean()),
            "f32_seg_equal": all(np.array_equal(a.segmentation,
                                                b.segmentation)
                                 for a, b in (f32, (got, want))),
            "f32_pose_err": errs, "f32_pose_err_after_icp": with_icp,
            "f32_kp_classes": [[k for k, _ in r.key_points]
                               for r in (got, want)],
            "f32_is_confident": [got.is_confident, want.is_confident],
            "f32_ee_points": int((want.segmentation == 2).sum())}
        failed |= (row["bf16_seg_agree"] < SEG_AGREE_BF16
                   or not row["f32_seg_equal"]
                   or any(e is not None and e > 1e-3
                          for e in errs.values())
                   or row["f32_kp_classes"][0] != row["f32_kp_classes"][1]
                   or got.is_confident != want.is_confident)
        report.append(row)
    report = {"frames": report, "tolerance": {
        "bf16_seg_agree": SEG_AGREE_BF16, "f32_pose": 1e-3}}
    if failed:
        raise AssertionError(f"predict card vs CPU: {report}")
    return report


def phase_calibrate(inputs, counters, frames=12):
    """The user's path at full width (the bench configuration with the 6D
    head, confidences, flip disambiguation and the 2nd percentile
    translation): checkpoints written and read back; a stream of
    ``frames`` synthetic frames over the point capacity through
    ``predict`` (after one warm-up frame) and ``calibrate``; ``calibrate``
    on a known extrinsic; ``predict`` card vs CPU.  Returns the stream's
    launches per kernel."""
    import tempfile

    from mrcc_tpu_torch.app import InferenceEngine, measure_seg_caps
    from mrcc_tpu_torch.ops.build import BUILD_DIR

    pts = inputs[0]
    stream, batch = _stream_frames(frames + 1, pts.shape[1])
    caps = measure_seg_caps(*batch, device="cuda")
    cfg = bench_config(pts, caps, **CALIBRATE_HEADS)
    engine = InferenceEngine(cfg, seed=0)

    # 1. checkpoints: a seed-1 engine from the paths alone equals engine
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        pth, ckpt = _save_stages(engine, root)
        want = engine.predict_batch_arrays(*inputs)
        round_trip = {}
        for name, paths in (("pth", pth), ("ckpt", ckpt)):
            other = InferenceEngine(dataclasses.replace(cfg, **paths),
                                    seed=1)
            got = other.predict_batch_arrays(*inputs)
            round_trip[name] = all(torch.equal(got[k], want[k])
                                   for k in want)
            del other
    if not all(round_trip.values()):
        raise AssertionError(f"checkpoint round trip: {round_trip}")

    # 2. the stream: predict each frame, then calibrate by position
    engine.predict(stream[0])  # warm-up
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.launches = 0
    rows, frame_s = [], []
    with plain_calls() as plain:
        for frame in stream[1:]:
            t0 = time.perf_counter()
            rows.append(engine.predict(frame))
            frame_s.append(time.perf_counter() - t0)
    launches = {ctr.name: ctr.launches for ctr in counters}
    results = {}
    for frame, r in zip(stream[1:], rows):
        results.setdefault(frame.id, []).append(r)
    t0 = time.perf_counter()
    calibration = engine.calibrate(results)
    calibrate_ms = 1e3 * (time.perf_counter() - t0)
    if (min(launches[c] for c in ("argsort", "conv_sk", "conv_down",
                                  "conv_up")) <= 0 or plain
            or any(len(r.segmentation) != len(f.points)
                   for r, f in zip(rows, stream[1:]))):
        raise AssertionError(f"predict: launches {launches}, plain twins "
                             f"{plain}")
    q1, med, q3 = np.percentile(frame_s, [25, 50, 75])

    # 3. a known extrinsic, averaged on the card
    pos_err, q_err = _known_extrinsic(engine)
    if pos_err > 0.01 or q_err > 0.01:
        raise AssertionError(f"known extrinsic: position {pos_err}, "
                             f"quaternion {q_err}")
    del engine
    torch.cuda.empty_cache()

    # 4. predict, card vs CPU
    card_vs_cpu = _predict_card_vs_cpu(stream[:3])
    log("calibrate", frames=frames, points_per_frame=len(stream[0].points),
        point_capacity=int(pts.shape[1]), seg_caps=list(caps),
        heads=CALIBRATE_HEADS, checkpoint_round_trip_equal=round_trip,
        predict_ms_median=1e3 * med, predict_ms_q1_q3=[1e3 * q1, 1e3 * q3],
        predict_ms_all=[1e3 * s for s in frame_s], card=smi_line(),
        calibrate_ms=calibrate_ms,
        confident_frames=sum(r.is_confident for r in rows),
        ee_points=[int((r.segmentation == 2).sum()) for r in rows],
        pose_camera_link=(None if calibration.pose_camera_link is None
                          else calibration.pose_camera_link.tolist()),
        pose_camera_link_note=("none: random weights confirm no frame, an "
                               "acceptable answer" if
                               calibration.pose_camera_link is None
                               else "from the confident frames"),
        known_extrinsic_err={"position_m": pos_err, "quaternion": q_err,
                             "tolerance": 0.01},
        predict_card_vs_cpu=card_vs_cpu, launches=launches,
        plain_twin_calls=plain)
    return launches


def phase_int8_main_path(inputs, caps, counters, bf16_seg, iters=12):
    """The bench configuration at full width in int8: calibrate on the
    batch, then drive it; returns per-kernel launches of one batch."""
    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.ops import conv, conv_q8

    pts, rgb, mask = inputs
    engine = InferenceEngine(bench_config(pts, caps, conv_impl="pallas-int8"),
                             seed=0)  # phase 6's weights
    dev = engine.device
    p = torch.as_tensor(pts, device=dev)
    c = torch.as_tensor(rgb, device=dev)
    m = torch.as_tensor(mask, device=dev)
    t = time.perf_counter()
    engine.calibrate_q8(p, c, m)
    torch.cuda.synchronize()
    calibrate_ms = 1e3 * (time.perf_counter() - t)
    engine.predict_batch_arrays(p, c, m)  # warm-up
    torch.cuda.synchronize()

    for ctr in counters:
        ctr.launches = 0
    with plain_calls() as plain:
        out = engine.predict_batch_arrays(p, c, m)
        torch.cuda.synchronize()
    launches = {ctr.name: ctr.launches for ctr in counters}
    q8 = tuple(c for c in counters if c.name.startswith(("conv_", "q8_"))
               and "q8" in c.name)
    bf16 = (conv.SK, conv.DOWN, conv.UP)
    # the bf16 conv kernels run in the rotation stage and nowhere else
    for ctr in counters:
        ctr.launches = 0
    seg = engine.seg_stage(p, c, m)
    engine.kp_stage(*seg[2:5])
    seg_kp = {ctr.name: ctr.launches for ctr in q8 + bf16}
    for ctr in counters:
        ctr.launches = 0
    engine.pose_stage(*seg[2:5])
    rot = {ctr.name: ctr.launches for ctr in q8 + bf16}
    torch.cuda.synchronize()
    if (min(launches[ctr.name] for ctr in q8) <= 0 or plain
            or any(seg_kp[ctr.name] for ctr in bf16)
            or any(rot[ctr.name] for ctr in q8)
            or any(launches[ctr.name] != rot[ctr.name] for ctr in bf16)):
        raise AssertionError(f"int8 path routing: launches {launches}, seg + "
                             f"kp {seg_kp}, rotation {rot}, plain {plain}")
    report = _inference_report(engine, (p, c, m), out, iters)
    agree = (None if bf16_seg is None else
             float((out["segmentation"] == bf16_seg)[m].float().mean()))
    log("int8_main_path", batch=int(pts.shape[0]), points=int(pts.shape[1]),
        seg_caps=list(caps), calibrate_ms=calibrate_ms,
        seg_labels_equal_to_bf16=agree, launches=launches,
        launches_seg_kp=seg_kp, launches_rotation=rot,
        launches_per_q8_call=q8_launches_per_call(launches, report),
        plain_twin_calls=plain, **report)
    return launches


def q8_launches_per_call(launches, report):
    """Launches per int8 conv call by kind, from one batch's counts: the
    conv kernel (one a call), the quantisation pass, the list kernel (down
    and up), the child sum (down), and every int8 kernel of the profiled
    batch (the split k3 tiles' resolve launches and the up conv's zero pass
    included) per call."""
    n = {k: launches.get(k, 0) for k in (
        "conv_sk_q8", "conv_k3map_q8", "conv_down_q8", "conv_up_q8",
        "q8_quantize", "q8_lists", "q8_child_sum")}
    calls = sum(n[k] for k in ("conv_sk_q8", "conv_k3map_q8", "conv_down_q8",
                               "conv_up_q8"))
    if not calls:
        return {"calls": 0}
    return {"calls": calls, "conv": 1.0,
            "quantise": n["q8_quantize"] / calls,
            "lists": n["q8_lists"] / max(n["conv_down_q8"] + n["conv_up_q8"],
                                         1),
            "child_sum": n["q8_child_sum"] / max(n["conv_down_q8"], 1),
            "all_q8_kernels_profiled": report["q8_kernel_launches"] / calls}


def _inference_report(engine, inputs, out, iters):
    """Clouds/s over ``iters`` batches timed one by one, one batch
    synchronised at each stage boundary, one under torch.profiler, and the
    sanity checks of ``out``."""
    p, c, m = inputs
    batch_s = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = engine.predict_batch_arrays(p, c, m)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(batch_s, [25, 50, 75])

    # one more batch, synchronised at every stage boundary
    stages = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    seg = engine.seg_stage(p, c, m)
    torch.cuda.synchronize()
    stages["seg"] = time.perf_counter() - t
    t = time.perf_counter()
    ee_pose, _ = engine.pose_stage(*seg[2:5])
    torch.cuda.synchronize()
    stages["pose"] = time.perf_counter() - t
    t = time.perf_counter()
    kp = engine.kp_stage(*seg[2:5])
    torch.cuda.synchronize()
    stages["kp"] = time.perf_counter() - t
    t = time.perf_counter()
    engine.icp_stage(seg[2], seg[4], ee_pose, kp[0])
    torch.cuda.synchronize()
    stages["icp"] = time.perf_counter() - t

    kernel_launches = {}
    device_ms = profile_device_ms(lambda: engine.predict_batch_arrays(p, c,
                                                                      m),
                                  kernel_launches)
    busy = sum(device_ms.values())
    batch_ms = 1e3 * med
    top = dict(sorted(device_ms.items(), key=lambda kv: -kv[1])[:12])
    ported = {k: sum(v for n, v in device_ms.items() if k in n)
              for k in ("radix_", "KeySearch", "NbrTable", *K3_NAMES,
                        *Q8_NAMES, "rank_kernel")}

    poses = torch.cat([out["ee_pose"], out["kp_pose"]])
    qnorm = poses[:, 3:].norm(dim=-1)
    checks = {
        "finite_poses": bool(torch.isfinite(poses).all()),
        "unit_quaternions": bool(((qnorm - 1).abs() < 1e-3).all()),
        "ee_count": out["ee_count"].tolist(),
        "seg_overflow": out["seg_overflow"].tolist(),
    }
    if not (checks["finite_poses"] and checks["unit_quaternions"]
            and not any(checks["seg_overflow"])):
        raise AssertionError(f"main path sanity failed: {checks}")
    b = p.shape[0]
    return dict(
        batches=iters, clouds_per_s_median=b / med,
        clouds_per_s_q1_q3=[b / q3, b / q1], card=smi_line(),
        batch_ms_median=batch_ms, batch_ms_all=[1e3 * s for s in batch_s],
        stage_ms={k: 1e3 * v for k, v in stages.items()},
        device_busy_ms=busy, device_idle_share=1 - busy / batch_ms,
        ported_kernel_device_ms=ported, top_device_ms=top,
        k3_device_ms=k3_device_ms(device_ms),
        q8_device_ms=q8_device_ms(device_ms),
        cuda_kernel_launches=sum(kernel_launches.values()),
        q8_kernel_launches=sum(v for n, v in kernel_launches.items()
                               if "q8" in n.lower()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **checks)


# K3's down and up kernels: its instantiations of the list kernel (under
# their own source names), the list GEMM, the child sum and the zero pass
K3_NAMES = ("K3ChildMap", "K3ParentMap", "list_mma_kernel",
            "child_sum_kernel", "zero_rows_kernel")


# the int8 convs' kernels (B6, B7 and their quantisation, lists, child sum
# and zero pass): each name holds "q8" or "Q8" (the tiles' and the lists'
# row sources Q8Keys, Q8Table, Q8ChildMap, Q8ParentMap)
Q8_NAMES = ("Q8Keys", "Q8Table", "Q8ChildMap", "Q8ParentMap",
            "list_mma_q8_kernel", "child_sum_q8_kernel",
            "zero_rows_q8_kernel", "act_absmax_q8_kernel",
            "quantize_q8_kernel", "quantize_w_q8_kernel")


def q8_device_ms(device_ms):
    """The int8 convs' device time of one profile."""
    return sum(v for n, v in device_ms.items() if "q8" in n.lower())


def k3_device_ms(device_ms):
    """K3's down and up device time of one profile."""
    return sum(v for n, v in device_ms.items()
               if any(k in n for k in K3_NAMES))


def dw_device_ms(device_ms):
    """The dW kernels' device time of one profile: their list kernel
    instantiations (every one but K3's and B7's), the MMA kernel, the slot
    sum."""
    return sum(v for n, v in device_ms.items()
               if ("hit_lists_kernel" in n and "K3" not in n
                   and "Q8" not in n)
               or "dw_mma_kernel" in n or "dw_reduce" in n)


def profile_device_ms(fn, launches=None):
    """Device time (ms) by kernel over one profiled call of ``fn``:
    device-side events only (an operator's own row repeats its kernels'
    time); ``launches``, if given, gets the kernel launches by name
    (memsets and copies left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ")[:120]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
        if launches is not None and not name.startswith(("Memset",
                                                          "Memcpy")):
            launches[name] = launches.get(name, 0) + e.count
    return out


def _train_pair_errors(cpu, gpu, before, zero_grad=()):
    """Gradient, update and BN-statistic errors of a card model against a
    CPU model after one step from the same weights ``before``.  The update
    is compared where the CPU gradient is 0 or above 1 % of its tensor's
    rms: Adam's first step is lr * g / (|g| + eps), noise where |g| is.
    ``zero_grad`` names tensors whose exact gradient is 0 (a bias before a
    train-mode BN): their update is all noise and is left out, and
    ``zero_grad_max`` reports their largest |g| on either side over the
    CPU gradients' rms."""
    gd = gn = ud = un = 0.0
    worst = {"grad": 0.0, "update": 0.0, "bn": 0.0}
    zero_max = 0.0
    gparams = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        q = gparams[name]
        g, gq = p.grad, q.grad.cpu()
        gd += float((gq - g).norm() ** 2)
        gn += float(g.norm() ** 2)
        worst["grad"] = max(worst["grad"], rel_err(gq, g))
        if name in zero_grad:
            zero_max = max(zero_max, float(g.abs().max()),
                           float(gq.abs().max()))
            continue
        keep = (g == 0) | (g.abs() > 1e-2 * g.pow(2).mean().sqrt())
        u = (p.detach() - before[name])[keep]
        uq = (q.detach().cpu() - before[name])[keep]
        ud += float((uq - u).norm() ** 2)
        un += float(u.norm() ** 2)
        worst["update"] = max(worst["update"], rel_err(uq, u))
    gbufs = dict(gpu.named_buffers())
    for name, buf in cpu.named_buffers():
        worst["bn"] = max(worst["bn"], rel_err(gbufs[name].cpu(), buf))
    n_params = sum(p.numel() for p in cpu.parameters())
    return {"grad": (gd / gn) ** 0.5, "update": (ud / un) ** 0.5,
            "bn": worst["bn"], "worst_tensor": worst,
            "zero_grad_max": zero_max / (gn / n_params) ** 0.5}


def _cpu_noise_floor(start, reference, cfg, batch, before, rel=1e-7):
    """The CPU train step again from ``start`` with the input colours moved
    by +-``rel`` relative (two seeded draws): the largest gradient and
    update errors against ``reference`` over the four runs, the resolution
    of a card-vs-CPU step check (C21)."""
    from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step

    worst = {"grad": 0.0, "update": 0.0}
    for seed in (0, 1):
        noise = np.random.default_rng(seed).standard_normal(
            batch["feats"].shape)
        for sign in (1, -1):
            model = copy.deepcopy(start)
            moved = dict(batch, feats=(batch["feats"] * (
                1 + sign * rel * noise)).astype(np.float32))
            step, _ = make_segmentation_train_step(model, cfg, TrainConfig(),
                                                   4096, device="cpu")
            step(moved, 1e-4)
            errs = _train_pair_errors(reference, model, before)
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
    return worst


def phase_train_card_vs_cpu(k3_self_keyed=True):
    """One train step from the same weights and batch on the card and on
    the CPU: minkunet14A, B=2, f32, capacity 4096; ``k3_self_keyed=False``:
    every level on tables (the table conv, its Function and the k3-table
    dW kernel on the card, their plain twins on the CPU).  The self-keyed
    pair also reports ``cpu_noise_floor``: how far the CPU step itself
    moves when its input colours move by 1e-7 relative (ROADMAP C21),
    the most over four draws."""
    from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step

    cfg = DataConfig(max_points=4096, data_type=None)
    data = SceneDataset(cfg, 2, seed=21, n_ee=512, n_arm=1024, n_bg=2048)
    batch = data.collate(data.items)
    cpu = init_parameters(RobotNetSegmentation(backbone="minkunet14A"), 5)
    gpu = copy.deepcopy(cpu)
    cpu_start = copy.deepcopy(cpu)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        step, _ = make_segmentation_train_step(
            model, cfg, TrainConfig(k3_self_keyed=k3_self_keyed), 4096,
            device=dev)
        out[dev] = {k: float(v) for k, v in step(batch, 1e-4).items()}
    loss_err = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(
        out["cpu"]["loss"])
    errs = _train_pair_errors(cpu, gpu, before)
    report = dict(loss=out, loss_rel_err=loss_err, **errs,
                  k3_tables=step.k3_tables,
                  tolerance={"loss": 1e-5, "grad": 1e-4, "update": 1e-3,
                             "bn": 1e-5})
    if k3_self_keyed:
        report["cpu_noise_floor"] = _cpu_noise_floor(cpu_start, cpu, cfg,
                                                     batch, before)
    if (loss_err > 1e-5 or errs["grad"] > 1e-4 or errs["update"] > 1e-3
            or errs["bn"] > 1e-5
            or any(step.k3_tables) == k3_self_keyed):
        raise AssertionError(f"train step, card vs CPU: {report}")
    log("train_card_vs_cpu" if k3_self_keyed else
        "train_tables_card_vs_cpu", **report)


POSE_METRICS = ("loss", "dist", "dist_position", "dist_orientation",
                "angle_diff")


def phase_pose_card_vs_cpu():
    """One pose step from the same weights and batch on the card and on the
    CPU: RobotNetEncode minkunet14A, cos2, B=2 EE crops, capacity 1024,
    f32 (loss and distances 1e-5, gradients 1e-4, update 1e-3, BN 1e-5)."""
    from mrcc_tpu_torch.data.dataset import DataConfig, PoseDataset
    from mrcc_tpu_torch.models import RobotNetEncode
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import (LossConfig, TrainConfig,
                                      make_pose_train_step)

    cfg = DataConfig(max_points=2048)
    data = PoseDataset(cfg, 2, seed=23, n_ee=2048, n_arm=1024, n_bg=2048)
    batch = data.collate(data.items)
    cpu = init_parameters(RobotNetEncode(backbone="minkunet14A"), 6)
    gpu = copy.deepcopy(cpu)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        step, _ = make_pose_train_step(model, cfg, LossConfig(),
                                       TrainConfig(), 1024, device=dev)
        out[dev] = {k: float(v) for k, v in step(batch, 1e-4).items()}
    metric_err = {k: abs(out["cuda"][k] - out["cpu"][k])
                  / max(abs(out["cpu"][k]), 1e-3) for k in POSE_METRICS}
    errs = _train_pair_errors(cpu, gpu, before)
    report = dict(metrics=out, metric_rel_err=metric_err, **errs,
                  tolerance={"metrics": 1e-5, "grad": 1e-4, "update": 1e-3,
                             "bn": 1e-5})
    if (max(metric_err.values()) > 1e-5 or errs["grad"] > 1e-4
            or errs["update"] > 1e-3 or errs["bn"] > 1e-5):
        raise AssertionError(f"pose step, card vs CPU: {report}")
    log("pose_card_vs_cpu", **report)


def _train_run(step, batch, counters, warmup, timed, lr=1e-4, falls=True):
    """Drive ``step`` on one fixed batch: ``warmup`` steps, then ``timed``
    steps timed one by one with every launch count set to 0 before the
    first (its launches are one step's; no plain twin may run in it) and
    read after the first and the last, one more step synchronised at the
    prepare / forward / backward / optimizer boundaries, one under
    torch.profiler.  Returns ``(launches of one step, report)``; the
    report's losses must be finite and, with ``falls``, the last below the
    first."""
    b = batch["points"].shape[0]
    losses = []

    def run():
        t0 = time.perf_counter()
        metrics = step(batch, lr)
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        return time.perf_counter() - t0

    for _ in range(warmup):
        run()
    torch.cuda.reset_peak_memory_stats()
    for ctr in counters:
        ctr.launches = 0
    with plain_calls() as plain:
        step_s = [run()]  # the counted run: one train step
    launches = {ctr.name: ctr.launches for ctr in counters}
    if plain:
        raise AssertionError(f"plain twins called in training: {plain}")
    step_s += [run() for _ in range(timed - 1)]
    total = {ctr.name: ctr.launches for ctr in counters}
    if total != {k: timed * v for k, v in launches.items()}:
        raise AssertionError(f"launches differ between steps: {total}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    q1, med, q3 = np.percentile(step_s, [25, 50, 75])

    stages = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    prepared = step.prepare(batch)
    torch.cuda.synchronize()
    stages["prepare"] = time.perf_counter() - t
    t = time.perf_counter()
    _, loss = step.forward(*prepared)
    torch.cuda.synchronize()
    stages["forward"] = time.perf_counter() - t
    t = time.perf_counter()
    step.backward(loss)
    torch.cuda.synchronize()
    stages["backward"] = time.perf_counter() - t
    t = time.perf_counter()
    step.update(lr)
    torch.cuda.synchronize()
    stages["optimizer"] = time.perf_counter() - t
    losses.append(float(loss.detach()))

    device_ms = profile_device_ms(lambda: run())
    busy = sum(device_ms.values())
    step_ms = 1e3 * med
    top = dict(sorted(device_ms.items(), key=lambda kv: -kv[1])[:14])
    ported = {k: sum(v for n, v in device_ms.items() if k in n)
              for k in ("radix_", "KeySearch", *K3_NAMES,
                        "NbrTable", "rank_kernel", "SkSource",
                        "DownSource", "UpSource", "TableSource",
                        "dw_mma_kernel", "dw_reduce")}
    checks = {"finite_losses": bool(np.isfinite(losses).all()),
              "loss_first": losses[0], "loss_last": losses[-1]}
    if not (checks["finite_losses"] and (losses[-1] < losses[0]
                                         or not falls)):
        raise AssertionError(f"training sanity failed: {losses}")
    return launches, dict(
        batch=b, points=int(batch["points"].shape[1]), warmup_steps=warmup,
        steps=timed, card=smi_line(),
        steps_per_s_median=1 / med, steps_per_s_q1_q3=[1 / q3, 1 / q1],
        clouds_per_s_median=b / med, clouds_per_s_q1_q3=[b / q3, b / q1],
        step_ms_median=step_ms, step_ms_all=[1e3 * x for x in step_s],
        stage_ms={k: 1e3 * v for k, v in stages.items()},
        device_busy_ms=busy, device_idle_share=1 - busy / step_ms,
        ported_kernel_device_ms=ported, top_device_ms=top,
        dw_device_ms=dw_device_ms(device_ms),
        k3_device_ms=k3_device_ms(device_ms),
        launches_per_step=launches, peak_mem_gb=peak_gb, losses=losses,
        **checks)


def _seg_step(model, k3_self_keyed=True, capacity=TRAIN_CAPACITY):
    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step

    return make_segmentation_train_step(
        model, DataConfig(data_type=None),
        TrainConfig(batch_size=8, k3_self_keyed=k3_self_keyed), capacity)[0]


def phase_train(counters, warmup=2, timed=6):
    """Segmentation training at full width on one fixed batch; returns the
    launches of one step (the first timed one) of every kernel."""
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters

    model = init_parameters(RobotNetSegmentation(backbone="minkunet"), 1)
    launches, report = _train_run(_seg_step(model), train_batch(), counters,
                                  warmup, timed)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran in training: {launches}")
    log("train", voxel_capacity=TRAIN_CAPACITY, backbone="minkunet (18D)",
        **report)
    return launches


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def phase_train_tables(counters, warmup=2, timed=6):
    """Phase 10 (a): phase 7's configuration with ``k3_self_keyed=False``
    (every level on rank tables).  One step from the same weights and batch
    against the self-keyed step (loss 1e-5, gradients 1e-4 in relative
    norm; bit-equality reported), then timed as phase 7, with the rank
    kernel, the table conv and the k3-table dW kernel launched and the
    self-keyed kernels not."""
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.ops import conv, rank
    from mrcc_tpu_torch.sparse.nn import init_parameters

    batch = train_batch()
    base = init_parameters(RobotNetSegmentation(backbone="minkunet"), 1)
    results = {}
    for sk in (True, False):
        model = copy.deepcopy(base)
        step = _seg_step(model, k3_self_keyed=sk)
        metrics = step(batch, 1e-4)
        results[sk] = (float(metrics["loss"]), _grads(model), step, model)
    (l_sk, g_sk, _, _), (l_t, g_t, step, _) = results[True], results[False]
    del results[True]
    flat = [torch.cat([g[n].flatten() for n in g_sk]) for g in (g_t, g_sk)]
    cmp = {"loss": [l_sk, l_t], "loss_rel_err": abs(l_t - l_sk) / abs(l_sk),
           "grad_rel_err": rel_err(*flat),
           "bit_equal": {"loss": l_t == l_sk,
                         "grads": all(torch.equal(g_t[n], g_sk[n])
                                      for n in g_sk)},
           "tolerance": {"loss": 1e-5, "grad": 1e-4}}
    if cmp["loss_rel_err"] > 1e-5 or cmp["grad_rel_err"] > 1e-4 \
            or not all(step.k3_tables):
        raise AssertionError(f"tables vs self-keyed training: {cmp}")
    launches, report = _train_run(step, batch, counters, warmup, timed)
    names = {ctr.name for ctr in (rank.RANK, conv.K3MAP, conv.DW_K3MAP)}
    if any(launches[k] <= 0 for k in names) or launches[conv.SK.name] \
            or launches[conv.DW_SK.name]:
        raise AssertionError(f"table training launches: {launches}")
    log("train_tables", voxel_capacity=TRAIN_CAPACITY,
        backbone="minkunet (18D)", k3_tables=step.k3_tables,
        vs_self_keyed=cmp, **report)
    return launches


def phase_train_scene(counters, warmup=2, timed=4):
    """Phase 10 (b): scene-scale segmentation training (minkunet18D, B=2
    scenes of SCENE_POINTS points, voxel capacity SCENE_CAPACITY): the k3
    route checked level by level against the JAX gate (the table conv on
    levels 0-2, the self-keyed one on 3-4; one dW launch per k3 conv of
    its route, the rank kernel once per table level), voxel overflow, then
    timed as phase 7."""
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.ops import conv, rank
    from mrcc_tpu_torch.sparse import train_uses_k3_tables
    from mrcc_tpu_torch.sparse.nn import init_parameters

    batch = scene_batch()
    model = init_parameters(RobotNetSegmentation(backbone="minkunet18D"), 2)
    step = _seg_step(model, capacity=SCENE_CAPACITY)
    caps = (SCENE_CAPACITY,) + step.caps
    want = tuple(train_uses_k3_tables(n) for n in caps)
    if step.k3_tables != want or want != (True,) * 3 + (False,) * 2:
        raise AssertionError(f"scene route {step.k3_tables} over {caps}")
    step(batch, 1e-4)  # builds, allocator
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.launches = 0
    with k3_calls() as calls, plain_calls() as plain:
        step(batch, 1e-4)
        torch.cuda.synchronize()
    got = {ctr.name: ctr.launches for ctr in counters}
    table_rows = {n for n, t in zip(caps, want) if t}
    bad = [cl for cl in calls
           if cl[1] != (cl[0] in table_rows)
           or cl[4] != (("conv_k3map",) if cl[1] else ("conv_sk",))]
    n_table = sum(1 for cl in calls if cl[1])
    n_sk = len(calls) - n_table
    if (bad or plain or got[rank.RANK.name] != sum(want)
            or got[conv.DW_K3MAP.name] != n_table
            or got[conv.DW_SK.name] != n_sk or not n_table or not n_sk):
        raise AssertionError(f"scene k3 route: wrong convs {bad[:4]}, "
                             f"launches {got}, plain {plain}")
    routes = {str(n): {"tables": t, "k3_convs": sum(1 for cl in calls
                                                    if cl[0] == n)}
              for n, t in zip(caps, want)}
    vox, _, levels = step.prepare(batch)
    occupancy = {"capacities": list(caps),
                 "voxels": [lv.count.tolist() for lv in levels],
                 "points": batch["mask"].sum(1).tolist()}
    occupancy["overflow"] = [[c >= cap for c in lv]
                             for lv, cap in zip(occupancy["voxels"], caps)]
    del vox, levels
    launches, report = _train_run(step, batch, counters, warmup, timed)
    log("train_scene", voxel_capacity=SCENE_CAPACITY,
        backbone="minkunet18D", k3_tables=step.k3_tables, k3_routes=routes,
        occupancy=occupancy, **report)
    return launches


@contextlib.contextmanager
def sk_timed():
    """Time every K2 launch of a run with CUDA events (the autograd
    Function looks the wrapper up by module attribute): yields a list of
    ``(rows, Cin, Cout, start event, end event)``."""
    from mrcc_tpu_torch.ops import conv

    calls, orig = [], conv.gather_gemm_sk

    def timed(feats, weights, key, kbits):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(feats, weights, key, kbits)
        end.record()
        calls.append((key.shape[1], feats.shape[-1], weights.shape[-1],
                      start, end))
        return out

    conv.gather_gemm_sk = timed
    try:
        yield calls
    finally:
        conv.gather_gemm_sk = orig


def pose_k2_breakdown(step, batch, lr=1e-4):
    """K2's device time in one pose train step by level capacity (rows,
    with the valid voxels of the levels of that capacity) and conv
    (Cin -> Cout; a data cotangent runs Cout -> Cin with W[26 - k]^T), from
    CUDA events around each launch."""
    step(batch, lr)  # warm
    torch.cuda.synchronize()
    with sk_timed() as calls:
        step(batch, lr)
        torch.cuda.synchronize()
    # levels of one capacity share a key (RobotNet's levels 0 and 1 both
    # have 4096 rows): their voxels are summed
    voxels = {}
    for lv in step.prepare(batch)[1]:
        rows = lv.key.shape[1]
        voxels[rows] = voxels.get(rows, 0) + int(lv.count.sum())
    by = {}
    for rows, cin, cout, start, end in calls:
        d = by.setdefault(f"{rows} rows ({voxels.get(rows)} voxels) "
                          f"{cin}->{cout}", {"calls": 0, "ms": 0.0})
        d["calls"] += 1
        d["ms"] += start.elapsed_time(end)
    per_level = {}
    for rows, _, _, start, end in calls:
        per_level[rows] = per_level.get(rows, 0.0) + start.elapsed_time(end)
    return {"k2_ms": sum(per_level.values()), "k2_calls": len(calls),
            "k2_ms_by_level": per_level, "k2_by_conv": by}


# (RANK_ROWS, RANK_WINDOW) and NN_BLOCKS values that --rank-nn times
RANK_VARIANTS = ((256, 4096), (128, 2048), (256, 2048), (256, 8192),
                 (512, 8192))
NN_VARIANTS = (132, 264, 528, 1056)


def phase_rank_nn(rounds=2):
    """``--rank-nn``: the rank kernel at phase 3's production levels and NN
    at the ICP's shapes, timed under each value of their wrappers'
    constants in ``RANK_VARIANTS`` / ``NN_VARIANTS`` (the module constants
    set for the run, then restored; a checkout whose wrappers have no such
    constants is timed as it is), ``rounds`` times in turns, each run's
    tables compared with the twin's."""
    from mrcc_tpu_torch.ops import nn, rank
    from mrcc_tpu_torch.sparse.hierarchy import K3_DELTAS

    dev = torch.device("cuda")
    plevels = bench_levels(dev, batch=2, points=PROD_POINTS, tables=True)[2]
    gen = torch.Generator().manual_seed(7)
    icp = []
    for b, m, n in ((2, 1024, 8192), (8, 1024, 2048)):
        icp.append(((torch.randn((b, m, 3), generator=gen) * 0.05 + 0.8).to(
            dev), (torch.randn((b, n, 3), generator=gen) * 0.05 + 0.8).to(
            dev), (torch.rand((b, n), generator=gen) > 0.2).to(dev)))
    cases = []  # (record key, set the variant, call, twin, kernel prefix)
    for variant in (RANK_VARIANTS if hasattr(rank, "RANK_ROWS") else [()]):
        for lv in plevels[:2]:
            args = (lv.key, lv.key, K3_DELTAS, lv.kbits)
            cases.append(((f"rank[{'x'.join(map(str, lv.key.shape))}]",
                           f"rows, window {variant}"),
                          (rank, ("RANK_ROWS", "RANK_WINDOW"), variant),
                          lambda a=args: rank.rank_lookup(*a),
                          lambda a=args: rank.rank_lookup_plain(*a),
                          "rank_kernel"))
    for variant in (NN_VARIANTS if hasattr(nn, "NN_BLOCKS") else [None]):
        for args in icp:
            cases.append(((f"nn_search[{'x'.join(map(str, args[0].shape[:2]))}"
                           f"x{args[1].shape[1]}]", f"blocks {variant}"),
                          (nn, ("NN_BLOCKS",), () if variant is None
                           else (variant,)),
                          lambda a=args: nn.nn_search(*a),
                          lambda a=args: nn.nn_search_plain(*a), "nn_"))
    times = {}
    for _ in range(rounds):
        for key, (mod, names, values), call, twin, prefix in cases:
            saved = [getattr(mod, k) for k in names[:len(values)]]
            try:
                for k, v in zip(names, values):
                    setattr(mod, k, v)
                rec = times.setdefault(key, {"equal": all(
                    map(torch.equal, call(), twin())), "ms": [],
                    "device_ms": []})
                rec["ms"].append(cuda_ms(call))
                rec["device_ms"].append(kernel_device_ms(call, prefix))
            finally:
                for k, v in zip(names, saved):
                    setattr(mod, k, v)
    for (name, variant), rec in times.items():
        log("rank_nn", kernel=name, variant=variant, **rec)


def phase_pose_k2(seed=50):
    """``--pose-k2``: only K2's breakdown in one RobotNet 18D pose step
    (phase 10 c's configuration), for comparing kernel versions."""
    from mrcc_tpu_torch.cli.train_mains import (PoseModelConfig,
                                                select_pose_model)
    from mrcc_tpu_torch.data.dataset import DataConfig, PoseDataset
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import (LossConfig, TrainConfig,
                                      make_pose_train_step)

    data_cfg = DataConfig()
    data = PoseDataset(data_cfg, 8, seed=seed)
    model = init_parameters(select_pose_model(PoseModelConfig(), data_cfg), 3)
    step, _ = make_pose_train_step(model, data_cfg,
                                   LossConfig(loss_type="cos2"),
                                   TrainConfig(batch_size=8), POSE_CAPACITY)
    log("pose_k2", card=smi_line(),
        **pose_k2_breakdown(step, data.collate(data.items)))


@contextlib.contextmanager
def timed_wrappers(names, rows_out):
    """Time every call of the ``ops.conv`` wrappers ``names`` in a run with
    CUDA events (the autograd Functions look the wrappers up by module
    attribute): yields a list of ``(name, B, rows in, rows out, Cin, Cout,
    start event, end event)``; ``rows_out(args)`` reads the output rows
    from a call's arguments."""
    from mrcc_tpu_torch.ops import conv

    calls, orig = [], {n: getattr(conv, n) for n in names}

    def timed(name):
        def run(feats, other, *maps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig[name](feats, other, *maps)
            end.record()
            calls.append((name, feats.shape[0], feats.shape[1],
                          rows_out(other, maps), feats.shape[-1],
                          out.shape[-1], start, end))
            return out
        return run

    for n in names:
        setattr(conv, n, timed(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(conv, n, orig[n])


# the dW wrappers (their g is the output level's cotangent) and K3's (the
# map's last dimension is the output level)
DW_WRAPPERS = (("dw_sk", "dw_k3_map", "dw_down", "dw_up"),
               lambda g, maps: g.shape[1])
K3_WRAPPERS = (("gather_gemm_down", "gather_gemm_up"),
               lambda w, maps: maps[0].shape[-1])


def wrapper_breakdown(step, batch, wrappers, label, lr=1e-4):
    """The device time of one train step's calls of ``wrappers`` by
    wrapper and shape, from CUDA events around each call (the step warmed
    first): ``{label}_ms``, ``{label}_calls``, ``{label}_by_shape``."""
    step(batch, lr)
    torch.cuda.synchronize()
    with timed_wrappers(*wrappers) as calls:
        step(batch, lr)
        torch.cuda.synchronize()
    by = {}
    for name, b, n_in, n_out, cin, cout, start, end in calls:
        rows = f"{b}x{n_in}" + (f"->{n_out}" if n_out != n_in else "")
        d = by.setdefault(f"{name}[{rows} {cin}x{cout}]",
                          {"calls": 0, "ms": 0.0})
        d["calls"] += 1
        d["ms"] += start.elapsed_time(end)
    return {f"{label}_ms": sum(d["ms"] for d in by.values()),
            f"{label}_calls": len(calls), f"{label}_by_shape": by}


def phase_step_breakdown(wrappers, label):
    """``--dw`` / ``--k3``: only the breakdown of one phase-7 step
    (minkunet 18D, B = 8, capacity 16384, self-keyed) and one phase-10 b
    step (scene scale, levels 0-2 on tables) over ``wrappers``, for
    comparing kernel versions."""
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters

    model = init_parameters(RobotNetSegmentation(backbone="minkunet"), 1)
    log(f"{label}_step", cell="training", card=smi_line(),
        **wrapper_breakdown(_seg_step(model), train_batch(), wrappers,
                            label))
    del model
    torch.cuda.empty_cache()
    model = init_parameters(RobotNetSegmentation(backbone="minkunet18D"), 2)
    log(f"{label}_step", cell="training_scene", card=smi_line(),
        **wrapper_breakdown(_seg_step(model, capacity=SCENE_CAPACITY),
                            scene_batch(), wrappers, label))


def phase_pose_train(counters, warmup=2, timed=6):
    """Phase 10 (c): pose training at full width on B=8 EE crops at voxel
    capacity POSE_CAPACITY: RobotNet 18D with cos2 (``train_pose``'s
    default), then RobotNetEncode 18D with the pose criterion (the
    rotation-only override: 5 mm voxels, no position term); each timed as
    phase 7.  Returns the launches of one step of each."""
    from mrcc_tpu_torch.cli.train_mains import (PoseModelConfig,
                                                select_pose_model)
    from mrcc_tpu_torch.data.dataset import DataConfig, PoseDataset
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import (LossConfig, TrainConfig,
                                      make_pose_train_step)

    runs = (("pose_robotnet", PoseModelConfig(), DataConfig(), "cos2",
             LossConfig(loss_type="cos2")),
            ("pose_encode", PoseModelConfig(encode_only=True),
             DataConfig(scale=200.0), "pose",
             LossConfig(loss_type="pose", disable_position=True)))
    out = {}
    for name, model_cfg, data_cfg, loss, loss_cfg in runs:
        torch.cuda.empty_cache()
        data = PoseDataset(data_cfg, 8, seed=50)
        batch = data.collate(data.items)
        model = init_parameters(select_pose_model(model_cfg, data_cfg), 3)
        step, _ = make_pose_train_step(model, data_cfg, loss_cfg,
                                       TrainConfig(batch_size=8),
                                       POSE_CAPACITY)
        vox = step.prepare(batch)[0]
        launches, report = _train_run(step, batch, counters, warmup, timed)
        if name == "pose_robotnet":
            report["k2"] = pose_k2_breakdown(step, batch)
        log(name, model=type(model).__name__, backbone="minkunet (18D)",
            loss=loss, voxel_size=data_cfg.quantization_size,
            voxel_capacity=POSE_CAPACITY, k3_tables=step.k3_tables,
            voxels=vox.count.tolist(), **report)
        out[name] = launches
    return out


# phase 12: which kernel counters each cell must move (the "yes" rows of
# the kernel table for it) and which it must not (the other k3 route)
SK_ROUTE = ("argsort", "conv_sk", "conv_down", "conv_up", "dw_sk", "dw_down",
            "dw_up")
TABLE_ROUTE = ("argsort", "rank", "conv_k3map", "conv_down", "conv_up",
               "dw_k3map", "dw_down", "dw_up")
LOSS_STEPS = 20  # phase 12: steps of the loss curve on the fixed batch


def _labelled_crops(n, seed, sample_kw=None, **cfg_kw):
    """``n`` AliveV2Dataset items of synthetic scenes ``seed``, ``seed +
    1``, ... under ``DataConfig(**cfg_kw)`` (EE crops by default),
    collated; every crop must hold points."""
    from mrcc_tpu_torch.data.dataset import AliveV2Dataset, DataConfig
    from mrcc_tpu_torch.data.synthetic import generate_sample

    data = AliveV2Dataset(samples=[generate_sample(seed=seed + i,
                                                   **(sample_kw or {}))
                                   for i in range(n)],
                          cfg=DataConfig(**cfg_kw))
    items = [data[i] for i in range(n)]
    if any(it is None for it in items):
        raise AssertionError(f"an empty EE crop among seeds {seed}+{n}")
    return data.collate(items)


def _object_batch(n_classes, per_class, classes, seed=0):
    """The first two clouds of each of ``classes`` in
    ``YCBDataset(num_classes=n_classes, samples_per_class=per_class,
    max_points=1024, seed=seed)``, collated: a triple needs a class twice
    and a second class."""
    from mrcc_tpu_torch.data.ycb import YCBDataset

    data = YCBDataset(num_classes=n_classes, samples_per_class=per_class,
                      max_points=1024, seed=seed)
    return data.collate([data[i] for c in classes
                         for i in [k for k, it in enumerate(data.items)
                                   if it[1] == c][:2]])


def _train_more_cells():
    """Phase 12's cells: ``(name, model, step factory (model, device,
    capacity), full-width batch, capacity, reduced model, reduced batch,
    reduced capacity, k3 route, tensors with a zero exact gradient)``."""
    from mrcc_tpu_torch.cli.train_mains import FEATURE_CAPACITY
    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.models import (FeatureNet, RobotNetSegmentation,
                                       RobotNetVote)
    from mrcc_tpu_torch.data.ycb import YCBDataset
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import (TrainConfig,
                                      make_metric_learning_train_step,
                                      make_segmentation_train_step)

    small = dict(n_ee=2048, n_arm=1024, n_bg=2048)
    cells = []
    for name, cfg_kw, build in (
            ("train_vote", dict(voting_enabled=True),
             lambda bb: RobotNetVote(backbone=bb, num_classes=2)),
            ("train_key_points", dict(keypoints_enabled=True),
             lambda bb: RobotNetSegmentation(backbone=bb, num_classes=6))):
        def make(model, dev, cap, _kw=cfg_kw):
            return make_segmentation_train_step(
                model, DataConfig(**_kw), TrainConfig(batch_size=8), cap,
                device=dev)[0]

        cells.append((name, init_parameters(build("minkunet"), 4), make,
                      _labelled_crops(8, 50, **cfg_kw), POSE_CAPACITY,
                      init_parameters(build("minkunet14A"), 6),
                      _labelled_crops(2, 23, small, max_points=2048,
                                      **cfg_kw), 1024, SK_ROUTE, ()))
    ycb_cfg = YCBDataset(num_classes=1, samples_per_class=1,
                         max_points=1024).cfg

    def make_feature(model, dev, cap):
        return make_metric_learning_train_step(
            model, ycb_cfg, TrainConfig(batch_size=8), cap, device=dev)[0]

    cells.append(("train_feature_extractor",
                  init_parameters(FeatureNet(backbone="minkunet34A"), 4),
                  make_feature, _object_batch(8, 6, range(4)),
                  FEATURE_CAPACITY,
                  init_parameters(FeatureNet(backbone="minkunet14A"), 6),
                  _object_batch(2, 2, range(2), seed=4), FEATURE_CAPACITY,
                  TABLE_ROUTE, ("final.bias",)))
    return cells


ULP_MOVE = 1e-7  # relative move of the features: about one f32 ulp


def _head_card_vs_cpu(model, make, batch, capacity, zero_grad):
    """One step of a phase-12 head on the card against the CPU step from
    the same weights, f32, at phase 5's gates: loss 1e-5, gradients 1e-4
    and the update 1e-3 in relative norm, BN statistics 1e-5; the tensors
    of ``zero_grad`` held under 1e-4 of the gradients' rms instead of by
    their update.

    The CPU step's gradient is not continuous: where a ReLU gate of the
    reference sits within rounding of 0, an input one ulp away takes the
    other side and moves the gradients by up to ~1e-4 and the update by
    ~1e-2 (ROADMAP C21), past the gates.  So the reference is the CPU step
    at the batch and, in turn until one holds the card within every gate,
    at the batch with its features moved by +-ULP_MOVE relative (seeded
    draws 0-2): the card step must equal the CPU step at an input within
    f32 resolution of the batch.  Every reference tried is reported."""
    gpu = copy.deepcopy(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    card = float(make(gpu, "cuda", capacity)(batch, 1e-4)["loss"])
    tried = []
    for draw, sign in [(None, 0)] + [(d, sg) for d in range(3)
                                     for sg in (1, -1)]:
        moved = batch if draw is None else dict(batch, feats=(
            batch["feats"] * (1 + sign * ULP_MOVE * np.random.default_rng(
                draw).standard_normal(batch["feats"].shape))).astype(
                    np.float32))
        cpu = copy.deepcopy(model)
        ref = float(make(cpu, "cpu", capacity)(moved, 1e-4)["loss"])
        errs = _train_pair_errors(cpu, gpu, before, zero_grad)
        errs.pop("worst_tensor")
        rec = dict(cpu_features=("batch" if draw is None else
                                f"{sign * ULP_MOVE:+g} relative, draw {draw}"),
                   loss={"cpu": ref, "cuda": card},
                   loss_rel_err=abs(card - ref) / max(abs(ref), 1e-3), **errs)
        tried.append(rec)
        if (rec["loss_rel_err"] <= 1e-5 and errs["grad"] <= 1e-4
                and errs["update"] <= 1e-3 and errs["bn"] <= 1e-5
                and errs["zero_grad_max"] <= 1e-4 and ref > 0):
            return dict(held_by=rec, references_tried=tried,
                        tolerance={"loss": 1e-5, "grad": 1e-4,
                                   "update": 1e-3, "bn": 1e-5,
                                   "zero_grad_max": 1e-4})
    raise AssertionError(f"card vs CPU: no reference holds: {tried}")


def phase_train_more(counters, warmup=2, timed=6):
    """Phase 12: the voting, sparse keypoint and feature-extractor steps at
    full width on one fixed batch each, timed as phase 7 and run to
    LOSS_STEPS steps: (a) RobotNetVote 18D, 2 classes, and (b)
    RobotNetSegmentation 18D, 6 keypoint classes, on B = 8 EE crops (seeds
    50-57) at capacity POSE_CAPACITY, 1 cm voxels, every level self-keyed;
    (c) FeatureNet (minkunet34A -> 16) with the mined triplet loss on B = 8
    object clouds of 1024 points (two of each of classes 0-3 of the
    feature extractor's 8-class dataset: its first shuffled batch of 8,
    [4, 7, 6, 1, 6, 0, 2, 1], mines no triple at init, and its loss stays
    0), 5 mm voxels, capacity 1024, every level on tables.  Each first checks one step card vs CPU at a reduced copy
    (minkunet14A, B = 2 crops at capacity 1024; for (c) B = 4 clouds of two
    classes, since a triple needs a positive and a negative).  Returns the
    launches of one step of each."""
    out = {}
    for (name, model, make, batch, cap, small, small_batch, small_cap,
         route, zero_grad) in _train_more_cells():
        torch.cuda.empty_cache()
        vs_cpu = _head_card_vs_cpu(small, make, small_batch, small_cap,
                                   zero_grad)
        step = make(model, "cuda", cap)
        feature = name == "train_feature_extractor"
        prepared = step.prepare(batch)
        vox, levels = prepared[0], prepared[1 if feature else 2]
        occupancy = dict(voxels=[lv.count.tolist() for lv in levels],
                         labelled_voxels=None if feature else int(
                             (vox.valid & (prepared[1] >= 0)).sum()))
        del prepared, vox, levels
        launches, report = _train_run(step, batch, counters, warmup, timed,
                                      falls=not feature)
        losses = report["losses"] + [
            float(step(batch, 1e-4)["loss"])
            for _ in range(LOSS_STEPS - len(report["losses"]))]
        torch.cuda.synchronize()
        other = [k for k in SK_ROUTE + TABLE_ROUTE if k not in route]
        if (any(launches[k] <= 0 for k in route)
                or any(launches[k] for k in other)
                or not np.isfinite(losses).all()
                or (not feature and np.mean(losses[-5:])
                    >= np.mean(losses[:5]))):
            raise AssertionError(f"{name}: launches {launches}, losses "
                                 f"{losses}")
        report["losses"] = losses
        log(name, model=type(model).__name__, voxel_capacity=cap,
            k3_tables=step.k3_tables, level_caps=(cap,) + step.caps,
            vs_cpu=vs_cpu, **occupancy, **report)
        out[name] = launches
    return out


# ------------------------------------------- the strided-pyramid models

RESNET_CAPACITY = 12544  # the bench profile's level-0 capacity
RESNET_CLASSES = 40      # ModelNet40's classes (the classifier's head)


def resnet_level0(device, batch=8, points=16384, seed=0,
                  capacity=RESNET_CAPACITY):
    """The ResNet's input: the bench profile's clouds (centred, 0.5 cm
    voxels, colours as features) at ``capacity`` voxels an item, as a
    depth-0 hierarchy.  Returns ``(features, level 0, points an item whose
    voxel did not fit the capacity)``."""
    from mrcc_tpu_torch.data.synthetic import build_batch
    from mrcc_tpu_torch.geometry import center_at_origin
    from mrcc_tpu_torch.sparse import build_hierarchy, voxelize

    pts, rgb, mask = build_batch(batch, points, seed=seed)
    m = torch.as_tensor(mask, device=device)
    c, _ = center_at_origin(torch.as_tensor(pts, device=device), mask=m)
    vox, p2v = voxelize(c, torch.as_tensor(rgb, device=device), m,
                        1 / 200.0, capacity)
    (level0,) = build_hierarchy(vox, 0)
    return vox.feats, level0, ((p2v == capacity) & m).sum(dim=1)


def resnet_pyramid(level0, caps=None):
    """The pyramid ``SparseResNetBase.forward`` builds from ``level0``:
    ``[(label, fine, coarse, stride, kernel_size)]`` for the stem (k3 s2),
    its pool (k2 s2), the four stages (k2 s2) and conv5 (k3 s3)."""
    from mrcc_tpu_torch.sparse import downsample_level

    cap = level0.valid.shape[-1]
    caps = caps or tuple(max(cap >> i, 64) for i in range(1, 8))
    plan = ([("stem", caps[0], 2, 3), ("pool", caps[1], 2, 2)]
            + [(f"stage{s + 1}", caps[2 + s], 2, 2) for s in range(4)]
            + [("conv5", max(64, caps[-1]), 3, 3)])
    out, level = [], level0
    for label, c, stride, k in plan:
        fine, coarse = downsample_level(level, c, stride=stride,
                                        kernel_size=k)
        out.append((label, fine, coarse, stride, k))
        level = coarse
    return out


def _map_work(coarse, n_in):
    """The strided map conv's work: the map's hits, the distinct input
    rows they gather, the output rows with one, and the whole map (an int32
    index and a bool a entry) read once."""
    hit = coarse.child_hit
    k, b, n = hit.shape
    read = torch.zeros((b, n_in + 1), dtype=torch.bool, device=hit.device)
    read.scatter_(1, torch.where(hit, coarse.child_idx, n_in)
                  .permute(1, 0, 2).reshape(b, -1).long(), True)
    return {"hits": int(hit.sum()), "read": int(read[:, :n_in].sum()),
            "written": int(hit.any(dim=0).sum()), "map_bytes": 5 * k * b * n}


def resnet_kernel_cases(device):
    """Row 3's strided-map mode and row 8's child-table mode at the
    full-width ResNet's shapes (B = 8 x 12544): the map conv at the stem
    (3 -> 64, bf16 on the ResNet path) and at conv5 (2048 -> 2048, f32:
    the f32 instance-norm parameters promote the features after the stem,
    as in JAX), each against its plain twin in f32 (1e-5) and bf16 (2e-2)
    with ``torch.mm`` over each offset's gathered hits as the yardstick;
    the child tables at the stem (k3 s2), its pool and the first stage (k2
    s2) and conv5 (k3 s3), exact against the rank kernel's plain twin and,
    on hits, against the searchsorted twin ``child_table_plain``, beside
    ``torch.searchsorted`` over the same queries."""
    from mrcc_tpu_torch.ops import conv, rank
    from mrcc_tpu_torch.sparse.hierarchy import (child_table_plain,
                                                 kernel_offsets)

    _, level0, _ = resnet_level0(device)
    pyramid = {p[0]: p for p in resnet_pyramid(level0)}
    gen, feats, weights = case_inputs(13, device)
    records = []
    for label, cin, cout, kind in (("stem", 3, 64, "bf16"),
                                   ("conv5", 2048, 2048, "f32")):
        _, fine, coarse, stride, _ = pyramid[label]
        maps = (coarse.child_idx, coarse.child_hit)
        f32 = feats(fine, cin)
        w32 = weights(27, cin, cout)
        want = conv.gather_gemm_map_plain(f32, w32, *maps)
        got = {"f32": conv.gather_gemm_map(f32, w32, *maps),
               "bf16": conv.gather_gemm_map(f32.bfloat16(), w32.bfloat16(),
                                            *maps)}
        errs = {k: rel_err(v, want) for k, v in got.items()}
        if errs["f32"] > TOL_F32 or errs["bf16"] > TOL_BF16:
            raise AssertionError(f"conv_map {label}: relative error {errs}")
        if not torch.equal(conv.gather_gemm_map(f32, w32, *maps),
                           got["f32"]):
            raise AssertionError(f"conv_map {label}: two launches differ")
        f, w = ((f32, w32) if kind == "f32"
                else (f32.bfloat16(), w32.bfloat16()))
        b, n_in = fine.key.shape
        n_out = coarse.key.shape[1]
        work = _map_work(coarse, n_in)
        nbytes = ((4 if kind == "f32" else 2)
                  * (work["read"] * cin + 27 * cin * cout + b * n_out * cout)
                  + work["map_bytes"])
        ops = 2 * work["hits"] * cin * cout
        bms, by = bound_ms(nbytes, ops, kind)
        # the yardstick: torch.mm of each offset's hit rows, gathered
        # beforehand, by its weight slice (the GEMM alone)
        ff = f.reshape(-1, cin)
        rows = torch.arange(b, device=device)[:, None] * n_in
        gathered = [ff[(coarse.child_idx[k] + rows)[coarse.child_hit[k]]
                       .long()] for k in range(27)]
        records.append(dict(
            name=f"conv_map[{label} {b}x{n_in}->{n_out} {cin}->{cout} "
                 f"{kind}]", kernel="conv_map", path="resnet", route="cuda",
            source=SOURCES["conv_map"], replaces=K3_TPU,
            max_abs_err=float((got[kind].float() - want).abs().max()),
            rel_err=errs, tolerance={"f32": TOL_F32, "bf16": TOL_BF16},
            dtype=kind, work=work,
            ms=cuda_ms(lambda: conv.gather_gemm_map(f, w, *maps)),
            device_ms=kernel_device_ms(
                lambda: conv.gather_gemm_map(f, w, *maps), "mrcc::tc::"),
            plain_ms=cuda_ms(lambda: conv.gather_gemm_map_plain(f, w,
                                                                *maps)),
            library_ms=cuda_ms(lambda: [torch.mm(a, w[k]) for k, a in
                                        enumerate(gathered)]),
            library_call="torch.mm(A_k, W[k]) for each offset k, the hit "
                         "rows gathered beforehand" + (", TF32 off"
                                                       if kind == "f32"
                                                       else ""),
            bound_ms=bms, bound_by=by,
            bound_3xtf32_ms=(max(1e3 * 3 * ops / PEAK_OPS["tf32"],
                                 1e3 * nbytes / HBM_BYTES_PER_S)
                             if kind == "f32" else None)))
        del gathered
    for label in ("stem", "pool", "stage1", "conv5"):
        _, fine, coarse, stride, ks = pyramid[label]
        offsets = kernel_offsets(ks)
        k = len(offsets)
        args = (coarse.off, coarse.key, coarse.valid, fine.key, offsets)
        idx, hit = rank.child_tables(*args, stride=stride)
        qbase = rank.child_query_base(coarse.key, coarse.valid, stride)
        deltas = [int(d) for d in offsets @ np.array([1 << 20, 1 << 10, 1])]
        qbits = rank.border_bits(coarse.off, coarse.valid, offsets, stride)
        want = rank.rank_lookup_plain(fine.key, qbase, deltas, qbits)
        p_idx, p_hit = child_table_plain(coarse.off, coarse.valid, fine.key,
                                         offsets, stride=stride)
        if not (torch.equal(idx, want[0]) and torch.equal(hit, want[1])
                and torch.equal(hit, p_hit) and torch.equal(
                    torch.where(hit, idx, -1), torch.where(hit, p_idx, -1))):
            raise AssertionError(f"child_tables {label} differ from the "
                                 "plain twins")
        b, n = fine.key.shape
        nq = coarse.key.shape[1]
        d = torch.tensor(deltas, dtype=torch.int32, device=device)
        q = (qbase[None] + d[:, None, None]).permute(1, 0, 2).reshape(b, -1)
        groups = len(rank.rank_groups(deltas))
        wide = rank.rank_windows(fine.key, qbase, deltas)[2]
        # keys, query bases and bitmaps read once, K int32 + bool written;
        # a search of log2(N) compares per chained group and K compares a
        # query row
        steps = groups * max(1, int(np.ceil(np.log2(n)))) + k
        records.append(dict(
            name=f"rank[child {label} k{ks}s{stride} {b}x{n}->{nq}]",
            kernel="rank", path="resnet", route="cuda",
            source=SOURCES["rank"], replaces=RANK_TPU, max_abs_err=0.0,
            tolerance="exact", hits=int(hit.sum()),
            global_share=float(wide.float().mean()),
            block_windows=int(wide.numel()),
            ms=cuda_ms(lambda: rank.child_tables(*args, stride=stride)),
            device_ms=kernel_device_ms(
                lambda: rank.child_tables(*args, stride=stride),
                "rank_kernel"),
            plain_ms=cuda_ms(lambda: child_table_plain(
                coarse.off, coarse.valid, fine.key, offsets, stride=stride)),
            library_ms=cuda_ms(lambda: torch.searchsorted(fine.key, q)),
            library_call="torch.searchsorted (ranks only)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(4 * b * n + 8 * b * nq + 5 * k * b * nq,
                                steps * b * nq, "f32")))))
    log("resnet_kernels", cases=[{k: r.get(k) for k in CASE_KEYS}
                                 for r in records])
    return records


def _resnet_net(device, **kw):
    """SparseResNet50 (3 -> RESNET_CLASSES) with random weights from seed
    0, in eval mode on ``device``."""
    from mrcc_tpu_torch.models import SparseResNet50
    from mrcc_tpu_torch.sparse.nn import init_parameters

    net = init_parameters(SparseResNet50(3, RESNET_CLASSES, **kw), 0)
    return net.to(device).eval()


def phase_resnet_card_vs_cpu():
    """A reduced SparseResNet50 (planes 8-32, init_dim 16), B = 2 clouds at
    capacity 2048, on the card and on the CPU with the same weights: logits
    f32 1e-4, bf16 2e-2 in relative norm; every child map of the pyramid
    with equal hits and equal idx on hits, and the neighbour tables of the
    coarse levels likewise."""
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    kw = dict(planes=(8, 16, 16, 32), init_dim=16)
    net_c = _resnet_net(cpu, **kw)
    net_g = copy.deepcopy(net_c).to(dev)
    fc, l0c, _ = resnet_level0(cpu, batch=2, points=4096, seed=21,
                               capacity=2048)
    fg, l0g, _ = resnet_level0(dev, batch=2, points=4096, seed=21,
                               capacity=2048)
    if not torch.equal(l0c.key, l0g.key.cpu()):
        raise AssertionError("resnet card vs CPU: level-0 keys differ")
    report = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, TOL_BF16)):
        with torch.no_grad():
            want = net_c(fc.to(dtype), l0c)
            got = net_g(fg.to(dtype), l0g).cpu()
        err = rel_err(got, want)
        report[str(dtype).removeprefix("torch.")] = err
        if not err <= tol:
            raise AssertionError(f"resnet card vs CPU {dtype}: logits off "
                                 f"by {err} (tolerance {tol})")
    maps = {}
    for (label, _, cc, _, _), (_, _, cg, _, _) in zip(resnet_pyramid(l0c),
                                                      resnet_pyramid(l0g)):
        for name in ("child", "nbr"):
            hit = getattr(cc, f"{name}_hit")
            idx = getattr(cc, f"{name}_idx")
            if not (torch.equal(getattr(cg, f"{name}_hit").cpu(), hit)
                    and torch.equal(
                        torch.where(hit, getattr(cg, f"{name}_idx").cpu(),
                                    -1), torch.where(hit, idx, -1))):
                raise AssertionError(f"resnet card vs CPU: {label} "
                                     f"{name} map differs")
        maps[label] = int(cc.child_hit.sum())
    log("resnet_card_vs_cpu", logits_rel_err=report, map_hits=maps)


def phase_resnet(counters, iters=8):
    """Full-width SparseResNet50 (published widths, conv5 2048 -> 2048) at
    B = 8 x 12544 with the default stage capacities, in bf16 and in f32:
    one forward with every launch count set to 0 before and read after
    (each of ``counters`` must have launched), then ``iters`` forwards
    timed one by one -> forwards/s (median, quartiles), one under
    torch.profiler (device busy ms, idle share, device time by kernel),
    peak memory, and sanity checks (finite [8, 40] logits)."""
    dev = torch.device("cuda")
    feats, level0, dropped = resnet_level0(dev)
    net = _resnet_net(dev)
    n_params = sum(p.numel() for p in net.parameters())
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = feats.to(dtype)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            net(x, level0)  # warm-up (allocator)
            torch.cuda.synchronize()
            for ctr in counters:
                ctr.launches = 0
            logits = net(x, level0)
            torch.cuda.synchronize()
            launches = {ctr.name: ctr.launches for ctr in counters}
            if min(launches.values()) <= 0:
                raise AssertionError(f"a kernel never ran on the ResNet "
                                     f"path: {launches}")
            if logits.shape != (8, RESNET_CLASSES) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"ResNet logits {tuple(logits.shape)} "
                                     "not finite")
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                net(x, level0)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            kernel_launches = {}
            device_ms = profile_device_ms(lambda: net(x, level0),
                                          kernel_launches)
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        busy = sum(device_ms.values())
        name = "resnet" if dtype == torch.bfloat16 else "resnet_f32"
        out[name] = launches
        log(name, batch=8, capacity=RESNET_CAPACITY,
            voxels=level0.count.tolist(), points_dropped=dropped.tolist(),
            params=n_params,
            launches=launches, forwards=iters,
            forwards_per_s_median=1 / med,
            forwards_per_s_q1_q3=[1 / q3, 1 / q1],
            clouds_per_s_median=8 / med,
            forward_ms_all=[1e3 * t for t in times],
            device_busy_ms=busy, device_idle_share=1 - busy / (1e3 * med),
            top_device_ms=dict(sorted(device_ms.items(),
                                      key=lambda kv: -kv[1])[:12]),
            map_conv_device_ms=sum(v for k, v in device_ms.items()
                                   if "StridedMap" in k),
            rank_device_ms=sum(v for k, v in device_ms.items()
                               if "rank_kernel" in k),
            cuda_kernel_launches=sum(kernel_launches.values()),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            card=smi_line())
    return out


def resnet_counters():
    """The kernels of the ResNet path: the key sort of every
    ``downsample_level``, the rank kernel (child maps and neighbour
    tables), the strided map conv (stem, conv5), K3 down (the strided
    blocks' k2 s2 convs, with its list stage and child sum) and the
    k3-table conv (the blocks on the coarse levels)."""
    from mrcc_tpu_torch.ops import conv, rank, sort

    return [sort.SORT, rank.RANK, conv.MAP, conv.DOWN, conv.K3_LISTS,
            conv.K3_SUM, conv.K3MAP]


def bottleneck_counters():
    """The kernels of the minkunet50 engine by compute dtype: bf16 runs
    phase 6's (self-keyed k3 convs), f32 takes tables on every level (the
    rank kernel and the k3-table conv instead of the self-keyed one)."""
    from mrcc_tpu_torch.ops import conv, rank, sort

    shared = [sort.SORT, conv.DOWN, conv.UP, conv.K3_LISTS, conv.K3_SUM]
    return {"bfloat16": shared + [conv.SK],
            "float32": shared + [rank.RANK, conv.K3MAP]}


def phase_resnet_only(counters, engine_counters):
    """``--resnet``: the ResNet's kernel cases, its card-vs-CPU pair, the
    full-width ResNet and the minkunet50 engine, with the launches of each
    kernel case's path."""
    records = resnet_kernel_cases(torch.device("cuda"))
    phase_resnet_card_vs_cpu()
    launches = phase_resnet(counters)
    launches.update(phase_bottleneck(engine_counters))
    for r in records:
        r["launches"] = launches[r["path"]][r["kernel"]]
    log("resnet_records", records=[
        {k: r.get(k) for k in ("name", "launches", "ms", "device_ms",
                               "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "max_abs_err")}
        for r in records])


def phase_bottleneck(counters, iters=8):
    """The minkunet50 engine (seg and keypoint nets on the bottleneck
    backbone, rotation on the default 18D encoder): first phase 4's small
    f32 card-vs-CPU pair on that backbone (integer outputs exact, poses
    1e-3), then on the bench inputs (B = 8, P = 16384) in bf16 and in f32,
    each as phase 6 (launches of every counter of its dtype in
    ``counters``, batches timed, stages, profiler, sanity)."""
    from mrcc_tpu_torch.app import InferenceEngine

    backbones = dict(seg_backbone="minkunet50", kp_backbone="minkunet50")
    phase_card_vs_cpu(**backbones)
    (pts, rgb, mask), caps, _ = bench_levels(torch.device("cuda"))
    out = {}
    for dtype, ctrs in counters.items():
        engine = InferenceEngine(bench_config(pts, caps, **dict(
            backbones, compute_dtype=dtype)), seed=0)
        dev = engine.device
        p, c, m = (torch.as_tensor(a, device=dev) for a in (pts, rgb, mask))
        torch.cuda.reset_peak_memory_stats()
        engine.predict_batch_arrays(p, c, m)  # warm-up
        torch.cuda.synchronize()
        for ctr in ctrs:
            ctr.launches = 0
        res = engine.predict_batch_arrays(p, c, m)
        torch.cuda.synchronize()
        launches = {ctr.name: ctr.launches for ctr in ctrs}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel never ran on the minkunet50 "
                                 f"path: {launches}")
        report = _inference_report(engine, (p, c, m), res, iters)
        name = "bottleneck" if dtype == "bfloat16" else "bottleneck_f32"
        out[name] = launches
        log(name, batch=int(pts.shape[0]), points=int(pts.shape[1]),
            seg_caps=list(caps), launches=launches, **report)
        del engine
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the dense PointNet2 path

DENSE_POINTS = 2048    # num_of_dense_input_points (override_key_points.yaml)
KP_POSE_POINTS = 4096  # override_kp_to_pose.yaml's dense sample
DENSE_BATCH = 32       # both overrides' batch_size
DENSE_SEED = 70        # the dense training batches' first scene
# the frozen keypoint predictor of (d): its head's weights scaled so that a
# random net's softmax passes the 0.75 gate (in eval mode its logits are
# ~1e-2: no class is found and kp_pose_match is 0; scaled, one class of
# six is found in each cloud)
KP_HEAD_SCALE = 300.0
BALL_EDGE = 1e-6  # a ball row may differ where a member's f64 d2 is this
                  # close to r^2


@contextlib.contextmanager
def dense_index_calls():
    """Record every FPS and ball query of a run, in order: ``("fps",
    (xyz, npoint), idx)`` and ``("ball", (radius, xyz, new_xyz), idx)``
    (the model and the engine look both up on ``ops.points``)."""
    from mrcc_tpu_torch.ops import points

    calls = []
    fps, ball = points.farthest_point_sample, points.query_ball_point

    def rec_fps(xyz, npoint, start_idx=0):
        out = fps(xyz, npoint, start_idx)
        calls.append(("fps", (xyz, npoint), out))
        return out

    def rec_ball(radius, nsample, xyz, new_xyz):
        out = ball(radius, nsample, xyz, new_xyz)
        calls.append(("ball", (radius, xyz, new_xyz), out))
        return out

    points.farthest_point_sample, points.query_ball_point = rec_fps, rec_ball
    try:
        yield calls
    finally:
        points.farthest_point_sample, points.query_ball_point = fps, ball


def _fps_divergence(xyz, got, want):
    """Where two FPS index rows first part: the step, both picks and the
    f64 distance of each to the points picked before (the step's key)."""
    b, i = [int(v) for v in (got != want).nonzero()[0]]
    x = xyz[b].double()
    chosen = x[want[b, :i].long()]
    d = lambda j: float(((x[j] - chosen) ** 2).sum(-1).min())  # noqa: E731
    return dict(item=b, step=i, card=int(got[b, i]), cpu=int(want[b, i]),
                card_d2_f64=d(int(got[b, i])), cpu_d2_f64=d(int(want[b, i])))


def compare_dense_calls(gpu_calls, cpu_calls):
    """Card against CPU record of :func:`dense_index_calls`: FPS indices
    exactly (a difference raises, with :func:`_fps_divergence`); ball
    groups exactly except rows where a point's f64 squared distance to
    the query lies within BALL_EDGE of r^2 (counted).  Returns the
    counts."""
    if [c[0] for c in gpu_calls] != [c[0] for c in cpu_calls]:
        raise AssertionError("dense card vs CPU: other FPS / ball calls")
    report = {"fps_calls": 0, "fps_indices": 0, "ball_calls": 0,
              "ball_rows": 0, "ball_rows_differ": 0, "ball_rows_at_edge": 0}
    for (kind, args, got), (_, cargs, want) in zip(gpu_calls, cpu_calls):
        got = got.cpu()
        if kind == "fps":
            report["fps_calls"] += 1
            report["fps_indices"] += want.numel()
            if not torch.equal(got, want):
                raise AssertionError(f"dense card vs CPU: FPS indices differ "
                                     f"{_fps_divergence(cargs[0], got, want)}")
            continue
        radius, xyz, new_xyz = cargs
        report["ball_calls"] += 1
        report["ball_rows"] += want.shape[0] * want.shape[1]
        rows = (got != want).any(-1).nonzero().tolist()
        report["ball_rows_differ"] += len(rows)
        for b, s in rows:
            d2 = ((xyz[b].double() - new_xyz[b, s].double()) ** 2).sum(-1)
            if not bool(((d2 - radius ** 2).abs() < BALL_EDGE).any()):
                raise AssertionError(
                    f"dense card vs CPU: ball row {(b, s)} at radius "
                    f"{radius} differs with no member at the edge")
            report["ball_rows_at_edge"] += 1
    return report


def _dense_small_config(method):
    """Phase 4's small f32 engine with the dense keypoint stage: B = 2,
    crops of 1024 points, 512 dense inputs."""
    from mrcc_tpu_torch.app import InferenceConfig, measure_seg_caps
    from mrcc_tpu_torch.data.synthetic import build_batch

    pts, rgb, mask = build_batch(2, 2048, seed=11)
    caps = measure_seg_caps(pts, rgb, mask, device="cpu")
    cfg = InferenceConfig(
        point_capacity=2048, seg_voxel_capacity=caps[0],
        seg_hierarchy_caps=caps[1:], ee_point_capacity=1024,
        ee_voxel_capacity=1024, ee_hierarchy_caps=(512, 256, 128, 64),
        icp_iterations=15, icp_template_points=512,
        seg_backbone="minkunet18", rot_backbone="minkunet18",
        kp_backbone="pointnet2", kp_sampling_method=method,
        num_of_dense_input_points=512, compute_dtype="float32")
    return (pts, rgb, mask), cfg


def phase_dense_card_vs_cpu():
    """Phase 15 (a): the dense engine on the card against the CPU, same
    weights, f32, both sampling methods: the crop and every integer
    output equal, every FPS index equal, ball groups as
    :func:`compare_dense_calls`, poses 1e-3; then the card's dense stage
    again with ``torch.backends.cuda.matmul.allow_tf32 = True``: the same
    indices and outputs bit for bit."""
    from mrcc_tpu_torch.app import InferenceEngine

    out = {}
    for method in ("uniform", "farthest"):
        (pts, rgb, mask), cfg = _dense_small_config(method)
        cpu = InferenceEngine(cfg, device="cpu", seed=3)
        gpu = InferenceEngine(cfg, device="cuda", seed=5)
        for stage, model in gpu.models().items():
            model.load_state_dict(cpu.models()[stage].state_dict())
        seg = {}
        for name, eng in (("cpu", cpu), ("cuda", gpu)):
            args = [torch.as_tensor(a, device=eng.device)
                    for a in (pts, rgb, mask)]
            seg[name] = [t.cpu() if torch.is_tensor(t) else t
                         for t in eng.seg_stage(*args)]
        if not all(torch.equal(a, b) for a, b in zip(seg["cpu"],
                                                     seg["cuda"])):
            raise AssertionError(f"dense card vs CPU ({method}): the "
                                 "segmentation stage differs")
        ee = seg["cpu"][2:5]
        with dense_index_calls() as cpu_calls:
            want = cpu.kp_stage(*ee)
        ee_g = [t.cuda() for t in ee]
        with dense_index_calls() as gpu_calls:
            got = [t.cpu() for t in gpu.kp_stage(*ee_g)]
        report = compare_dense_calls(gpu_calls, cpu_calls)
        for i, k in ((1, "kp_ok"), (2, "kp_coords"), (3, "kp_found")):
            if not torch.equal(got[i], want[i]):
                raise AssertionError(f"dense card vs CPU ({method}): {k} "
                                     "differs")
        pos_err = float((got[0][:, :3] - want[0][:, :3]).abs().max())
        ok_q, q_err = _quat_close(got[0][:, 3:], want[0][:, 3:], 1e-3)
        if pos_err > 1e-3 or not ok_q:
            raise AssertionError(f"dense card vs CPU ({method}): kp_pose off "
                                 f"by {pos_err}, {q_err}")
        full = {k: v.cpu() for k, v in gpu.predict_batch_arrays(
            *[torch.as_tensor(a, device="cuda")
              for a in (pts, rgb, mask)]).items()}
        full_cpu = cpu.predict_batch_arrays(pts, rgb, mask)
        for k in ("segmentation", "ee_count", "kp_found", "kp_ok"):
            if not torch.equal(full[k], full_cpu[k]):
                raise AssertionError(f"dense card vs CPU ({method}): "
                                     f"predict_batch_arrays {k} differs")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with dense_index_calls() as tf32_calls:
                tf32 = [t.cpu() for t in gpu.kp_stage(*ee_g)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        # indices, keypoints and confidences; Kabsch's own 3 x 3 matmuls
        # follow the global flag
        same = (len(tf32_calls) == len(gpu_calls)
                and all(torch.equal(a[2], b[2])
                        for a, b in zip(tf32_calls, gpu_calls)))
        if not (same and all(torch.equal(tf32[i], got[i])
                             for i in (1, 2, 3, 4))):
            raise AssertionError(f"dense ({method}): TF32 on moved the "
                                 "dense stage's indices or keypoints")
        out[method] = dict(report, ee_count=seg["cpu"][1].tolist(),
                           kp_found=int(want[3].sum()),
                           kp_pose_err={"pos": pos_err, "quat": q_err},
                           tf32_same_indices=same,
                           tf32_kp_pose_max_diff=float(
                               (tf32[0] - got[0]).abs().max()))
    log("dense_card_vs_cpu", **out)


def _fps_profile(shapes):
    """CUDA kernel launches and device ms of the FPS calls ``shapes``
    ((B, N, npoint) each) on random clouds, under torch.profiler."""
    from mrcc_tpu_torch.ops import points

    clouds = [(torch.rand((b, n, 3), device="cuda"), k)
              for b, n, k in shapes]
    launches = {}
    device_ms = profile_device_ms(
        lambda: [points.farthest_point_sample(x, k) for x, k in clouds],
        launches)
    return sum(launches.values()), sum(device_ms.values())


def _dense_kp_split(engine, p, c, m, variant):
    """One batch's dense keypoint stage split into the sample (with its
    FPS when farthest), the model (its set abstractions' FPS timed apart)
    and the keypoints + Kabsch, synchronised at each boundary; the FPS
    calls' ms, steps and CUDA launches are logged on a line of their own
    (``dense_fps``)."""
    from mrcc_tpu_torch.ops import points

    ee = engine.seg_stage(p, c, m)[2:5]
    fps, calls = points.farthest_point_sample, []

    def timed_fps(xyz, npoint, start_idx=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fps(xyz, npoint, start_idx)
        torch.cuda.synchronize()
        calls.append((tuple(xyz.shape[:2]) + (npoint,),
                      time.perf_counter() - t0))
        return out

    split = {}
    points.farthest_point_sample = timed_fps
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        x, order, s_valid = engine.dense_sample(*ee)
        torch.cuda.synchronize()
        split["sampling"] = time.perf_counter() - t
        n_sample = len(calls)
        t = time.perf_counter()
        with torch.no_grad(), points.full_f32():
            logits, _ = engine.kp_model(x)
        torch.cuda.synchronize()
        split["model"] = time.perf_counter() - t
    finally:
        points.farthest_point_sample = fps
    t = time.perf_counter()
    engine.dense_key_points(logits, order, s_valid, ee[0], ee[2])
    torch.cuda.synchronize()
    split["kabsch"] = time.perf_counter() - t
    split = {k: 1e3 * v for k, v in split.items()}
    split["fps_in_sampling"] = 1e3 * sum(s for _, s in calls[:n_sample])
    split["fps_in_model"] = 1e3 * sum(s for _, s in calls[n_sample:])
    shapes = [s for s, _ in calls]
    launches, device_ms = _fps_profile(shapes)
    fps_ms = split["fps_in_sampling"] + split["fps_in_model"]
    log("dense_fps", variant=variant, calls=shapes,
        steps=sum(k for _, _, k in shapes), ms=fps_ms,
        share_of_kp=fps_ms / (split["sampling"] + split["model"]
                              + split["kabsch"]),
        cuda_launches=launches, device_ms=device_ms, card=smi_line())
    return split


def phase_dense(counters, q8_counters, iters=12):
    """Phase 15 (b): the bench configuration (B = 8, P = 16384, phase 6's
    inputs) with ``kp_backbone="pointnet2"`` and 2048 dense inputs, by
    uniform and by farthest sampling, and int8 + uniform (after
    ``calibrate_q8``), each as phase 6 (launches of one batch with no
    plain twin, 12 batches timed, stages, profiler, sanity, peak memory)
    with the keypoint stage split by :func:`_dense_kp_split`.  Returns
    each variant's launches."""
    from mrcc_tpu_torch.app import InferenceEngine

    (pts, rgb, mask), caps, _ = bench_levels(torch.device("cuda"))
    variants = (("dense_uniform", {}, counters),
                ("dense_farthest", dict(kp_sampling_method="farthest"),
                 counters),
                # the int8 seg net's up convs are int8; the rotation
                # encoder has none in bf16
                ("dense_int8", dict(conv_impl="pallas-int8"),
                 [c for c in counters if c.name != "conv_up"]
                 + q8_counters))
    out = {}
    for name, kw, ctrs in variants:
        engine = InferenceEngine(bench_config(
            pts, caps, kp_backbone="pointnet2",
            num_of_dense_input_points=DENSE_POINTS, **kw), seed=0)
        dev = engine.device
        p, c, m = (torch.as_tensor(a, device=dev) for a in (pts, rgb, mask))
        if "conv_impl" in kw:
            engine.calibrate_q8(p, c, m)
        torch.cuda.reset_peak_memory_stats()
        engine.predict_batch_arrays(p, c, m)  # warm-up
        torch.cuda.synchronize()
        for ctr in ctrs:
            ctr.launches = 0
        with plain_calls() as plain:
            res = engine.predict_batch_arrays(p, c, m)
            torch.cuda.synchronize()
        launches = {ctr.name: ctr.launches for ctr in ctrs}
        if min(launches.values()) <= 0 or plain:
            raise AssertionError(f"{name}: a kernel never ran or a plain "
                                 f"twin did: {launches}, {plain}")
        report = _inference_report(engine, (p, c, m), res, iters)
        split = _dense_kp_split(engine, p, c, m, name)
        log(name, batch=int(pts.shape[0]), points=int(pts.shape[1]),
            dense_points=DENSE_POINTS, seg_caps=list(caps),
            launches=launches, kp_split_ms=split,
            kp_found=res["kp_found"].sum(dim=-1).tolist(), **report)
        out[name] = launches
        del engine
        torch.cuda.empty_cache()
    return out


def _dense_batch(n, num_points, sampling, seed=DENSE_SEED):
    """``n`` AliveV2DenseDataset items (keypoint labels, unit-scaled
    coordinates as features) of synthetic scenes ``seed``, ``seed + 1``,
    ..., collated."""
    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.data.dense import AliveV2DenseDataset
    from mrcc_tpu_torch.data.synthetic import generate_sample

    data = AliveV2DenseDataset(
        samples=[generate_sample(seed=seed + i) for i in range(n)],
        cfg=DataConfig(keypoints_enabled=True), num_points=num_points,
        sampling=sampling)
    items = [data[i] for i in range(n)]
    if any(it is None for it in items):
        raise AssertionError(f"a crop under {num_points} points")
    return data.collate(items)


@contextlib.contextmanager
def cpu_masks(*models):
    """Every dropout of ``models`` draws its mask on the CPU from a fresh
    generator seeded with its seed, then moves it to the features' device:
    one mask a shape on the card and on the CPU, call after call."""
    from mrcc_tpu_torch.sparse.nn import SparseDropout

    mods = [m for model in models for m in model.modules()
            if isinstance(m, SparseDropout)]

    def fixed(self, feats):
        if not self.training:
            return feats
        gen = torch.Generator().manual_seed(self.seed)
        keep = (torch.rand(feats.shape, generator=gen) < 1 - self.rate).to(
            feats.device)
        return torch.where(keep, feats / (1 - self.rate), 0.0)

    for m in mods:
        m.forward = fixed.__get__(m)
    try:
        yield
    finally:
        for m in mods:
            del m.forward


def _dense_cells():
    """Phase 15 (c) and (d): ``(name, model, step factory (model, device,
    capacity), full-width batch, reduced model, reduced batch, zero_grad)``;
    the reduced batches are B = 2 x 1024."""
    from mrcc_tpu_torch.models import PointNet, PointNet2SSG
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import (TrainConfig,
                                      make_dense_key_point_train_step,
                                      make_kp_to_pose_train_step)

    def kp_net(seed, dropout_seed=0):
        return init_parameters(PointNet2SSG(num_classes=6,
                                            dropout_seed=dropout_seed), seed)

    predictor = kp_net(0)
    with torch.no_grad():
        predictor.conv2.weight.mul_(KP_HEAD_SCALE)

    def make_kp(model, dev, _cap):
        return make_dense_key_point_train_step(model, TrainConfig(),
                                               device=dev)[0]

    def make_pose(model, dev, _cap):
        frozen = copy.deepcopy(predictor).to(next(model.parameters()).dtype)
        return make_kp_to_pose_train_step(model, frozen, TrainConfig(), True,
                                          device=dev)[0]

    def pose_net():
        return init_parameters(PointNet(out_channels=7, in_channels=4,
                                        dropout_seed=1), 1)

    return (("dense_key_points", kp_net(1, 1), make_kp,
             _dense_batch(DENSE_BATCH, DENSE_POINTS, "farthest"),
             kp_net(2, 1), _dense_batch(2, 1024, "farthest"), ("conv1.bias",)),
            ("kp_to_pose", pose_net(), make_pose,
             _dense_batch(DENSE_BATCH, KP_POSE_POINTS, "uniform"),
             pose_net(), _dense_batch(2, 1024, "uniform"), ()))


def _dense_card_vs_cpu(model, make, batch, zero_grad):
    """One dense step on the card against the CPU step from the same
    weights, batch and dropout masks.  Held in float64 at phase 5's gates
    (loss 1e-5, gradients 1e-4, update 1e-3 in relative norm, BN
    statistics 1e-5, the ``zero_grad`` tensors' |g| under 1e-4 of the
    gradients' rms).  In f32 the card is only reported, beside the CPU
    step's own spread over its features moved by +-ULP_MOVE relative: the
    dense nets' f32 gradients move by tens of per cent under such a move
    (ROADMAP C31), so f32 cannot hold them to 1e-4."""
    def cast(b, dtype):
        return dict(b, **{k: b[k].astype(dtype)
                          for k in ("points", "feats", "pose")})

    def pair(start, ref_batch, other_batch, dev):
        before = {n: p.detach().clone() for n, p in start.named_parameters()}
        a, b = copy.deepcopy(start), copy.deepcopy(start)
        with cpu_masks(a, b):
            la = float(make(a, "cpu", None)(ref_batch, 1e-4)["loss"])
            lb = float(make(b, dev, None)(other_batch, 1e-4)["loss"])
        errs = _train_pair_errors(a, b, before, zero_grad)
        errs.pop("worst_tensor")
        return dict(loss={"cpu": la,
                          "cpu_moved" if dev == "cpu" else dev: lb},
                    loss_rel_err=abs(lb - la) / max(abs(la), 1e-3), **errs)

    b64 = cast(batch, np.float64)
    f64 = pair(copy.deepcopy(model).double(), b64, b64, "cuda")
    if not (f64["loss_rel_err"] <= 1e-5 and f64["grad"] <= 1e-4
            and f64["update"] <= 1e-3 and f64["bn"] <= 1e-5
            and f64["zero_grad_max"] <= 1e-4):
        raise AssertionError(f"dense step card vs CPU (f64): {f64}")
    b32 = cast(batch, np.float32)
    moved = dict(b32, feats=(b32["feats"] * (1 + ULP_MOVE * np.random.
                 default_rng(0).standard_normal(b32["feats"].shape))).astype(
                     np.float32))
    return dict(f64=f64, f32=pair(model, b32, b32, "cuda"),
                f32_cpu_vs_moved_cpu=pair(model, b32, moved, "cpu"),
                tolerance_f64={"loss": 1e-5, "grad": 1e-4, "update": 1e-3,
                               "bn": 1e-5, "zero_grad_max": 1e-4})


def phase_dense_train(warmup=2, timed=6):
    """Phase 15 (c) dense keypoint training (PointNet2SSG, 6 classes, B =
    32 clouds of 2048 FPS samples, coordinates as features) and (d)
    keypoint-to-pose training (the frozen PointNet2SSG predictor, head
    scaled by KP_HEAD_SCALE, feeding PointNet(7) with kp_pose_match, B =
    32 clouds of 4096 uniform samples), f32 with TF32 off, AdamW lr 1e-4:
    each first one step card vs CPU at B = 2 x 1024
    (:func:`_dense_card_vs_cpu`), then timed as phase 7 on its fixed batch
    and run to LOSS_STEPS steps, whose loss must fall."""
    out = {}
    for name, model, make, batch, small, small_batch, zero_grad in \
            _dense_cells():
        torch.cuda.empty_cache()
        vs_cpu = _dense_card_vs_cpu(small, make, small_batch, zero_grad)
        step = make(model, "cuda", None)
        extra = {}
        if name == "kp_to_pose":
            extra["kp_found_share"] = float(
                step.prepare(batch)[2].float().mean())
        _, report = _train_run(step, batch, [], warmup, timed, falls=False)
        losses = report["losses"] + [
            float(step(batch, 1e-4)["loss"])
            for _ in range(LOSS_STEPS - len(report["losses"]))]
        if (not np.isfinite(losses).all()
                or np.mean(losses[-5:]) >= np.mean(losses[:5])):
            raise AssertionError(f"{name}: losses {losses}")
        report["losses"] = losses
        log(name, model=type(model).__name__, vs_cpu=vs_cpu, **extra,
            **report)
        out[name] = report["launches_per_step"]
    return out


def phase_dense_only(counters, q8_counters):
    """``--dense``: phase 15 alone."""
    phase_dense_card_vs_cpu()
    phase_dense(counters, q8_counters)
    phase_dense_train()


# ----------------------------------------------------------- phase 16: eval

EVAL_SAMPLES = 10     # write_sample_set: train 8 (positions p1-p3), val, test
APP_FRAMES = 12       # (c): frames through BenchmarkApp on the card
SEG_EVAL_AGREE = 0.995  # (a): point labels card vs CPU
SEG_EVAL_METRIC = 1e-3  # (a): accuracy / precision / recall, absolute
EVAL_DIST = 1e-4        # (b): pose and centre distances (m, relative above 1)
VOTE_LOGITS = 1e-4      # (b): vote logits card vs CPU where centres differ
APP_SEG_ACC = 0.01      # (c): bf16 seg accuracy card vs CPU
# (e): int8 seg logits card vs CPU, relative: the three engines read
# 4.4 %, 4.8 % and 6.9 % on an H100 80GB HBM3 at 700 W; each conv is held
# alone to its twin's bits and TOL_Q8 (_replay), ROADMAP C32
Q8R_LOGITS = 0.1


def _eval_config(root, split, exp="exp"):
    """The defaults with the sample set, the experiment directory
    (``{root}/{exp}``: the CPU references write into their own) and the
    test split overridden (and the padding cut to the 24096-point
    samples' 32768: the collated rows are the same)."""
    from mrcc_tpu_torch.config import Config

    return Config(overrides={
        "DATA": {"file_names": f"{root}/sample_splits.json",
                 "max_npoint": 32768},
        "TEST": {"split": split}}, exp_path=f"{root}/{exp}")


def _zero(counters):
    for ctr in counters:
        ctr.launches = 0


def _read(counters):
    torch.cuda.synchronize()
    return {ctr.name: ctr.launches for ctr in counters}


@contextlib.contextmanager
def _stage_clock(times):
    """Every InferenceEngine stage call synchronised and timed into
    ``times[stage]`` (ms)."""
    from mrcc_tpu_torch.app import InferenceEngine

    names = ("seg_stage", "pose_stage", "kp_stage", "icp_stage")
    saved = {n: getattr(InferenceEngine, n) for n in names}

    def timed(name, fn):
        def run(self, *args, **kw):
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *args, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            times.setdefault(name.removesuffix("_stage"), []).append(
                1e3 * (time.perf_counter() - t))
            return out
        return run

    for n, fn in saved.items():
        setattr(InferenceEngine, n, timed(n, fn))
    try:
        yield times
    finally:
        for n, fn in saved.items():
            setattr(InferenceEngine, n, fn)


@contextlib.contextmanager
def _point_logits_of(out):
    """Every ``eval.harness._point_logits`` result (the logits of one
    batch, on its device) appended to ``out`` with the batch's mask."""
    from mrcc_tpu_torch.eval import harness

    saved = harness._point_logits

    def kept(forward, batch):
        logits = saved(forward, batch)
        out.append((logits, torch.as_tensor(batch["mask"])))
        return logits

    harness._point_logits = kept
    try:
        yield out
    finally:
        harness._point_logits = saved


def _seg_eval(root, counters, refs):
    """(a) ``test_segmentation`` on the card (the default STRUCTURE
    backbone, 18D, 3 classes, capacity 8192, batch 4, f32 on tables) over
    the 8 train samples, against the CPU's run with the same weights
    (``refs``): every instance's accuracy / precision / recall within
    SEG_EVAL_METRIC, the point labels of every batch equal on
    SEG_EVAL_AGREE."""
    from mrcc_tpu_torch.cli import test_mains

    cfg = _eval_config(root, "train")
    test_mains.test_segmentation(cfg)          # warm-up (allocator)
    card_logits = []
    _zero(counters)
    with _point_logits_of(card_logits):
        t = time.perf_counter()
        res = test_mains.test_segmentation(cfg)
        wall = time.perf_counter() - t
    launches = _read(counters)
    if min(launches.values()) <= 0:
        raise AssertionError(f"seg eval: a kernel never ran: {launches}")
    busy = sum(profile_device_ms(
        lambda: test_mains.test_segmentation(cfg)).values())
    want, cpu_logits, cpu_s = (refs["seg"][k]
                               for k in ("want", "logits", "cpu_s"))
    got = res["instances"]
    same_items = ([g["file"] for g in got]
                  == [w["file"] for w in want["instances"]])
    metric_err = max(abs(g[k] - w[k]) for g, w in zip(got, want["instances"])
                     for k in ("accuracy", "precision", "recall"))
    agree = [float((g.argmax(-1).cpu() == w.argmax(-1))[m].float().mean())
             for (g, m), (w, _) in zip(card_logits, cpu_logits)]
    report = dict(instances=len(got), wall_s=wall,
                  instances_per_s=len(got) / wall, device_busy_ms=busy,
                  device_idle_share=1 - busy / (1e3 * wall),
                  launches=launches, cpu_instances=len(want["instances"]),
                  cpu_s=cpu_s,
                  metric_max_abs_diff=metric_err, label_agree=agree,
                  overall=res["overall"],
                  tolerance={"metric": SEG_EVAL_METRIC,
                             "label_agree": SEG_EVAL_AGREE})
    if (metric_err > SEG_EVAL_METRIC or min(agree) < SEG_EVAL_AGREE
            or not same_items or len(card_logits) < 2
            or len(agree) != len(card_logits)):
        raise AssertionError(f"seg eval card vs CPU: {report}")
    return report


def _close_dist(a, b):
    return a == b or abs(a - b) <= EVAL_DIST * max(1.0, abs(a), abs(b))


def _vote_near_tie(cfg, missed, top_k=8):
    """Why two voted centres differ: the vote logits card vs CPU (relative
    norm within VOTE_LOGITS) and, per item, the gap between the k-th and
    the (k+1)-th class-1 score against the largest score difference
    between the devices.  A near tie (a gap above 0 and under that
    difference) lets the devices rank different points k-th (the centre
    is the mean of the top k), which explains the miss of an item in
    ``missed``; an exact tie does not (both devices take the lower index
    first, as ``lax.top_k``), nor anything else."""
    from mrcc_tpu_torch.cli import test_mains
    from mrcc_tpu_torch.cli.common import make_datasets
    from mrcc_tpu_torch.eval.harness import Forward, _point_logits
    from mrcc_tpu_torch.models import RobotNetVote

    data_cfg = cfg.data_config()
    data_cfg.voting_enabled = True
    ds = make_datasets(cfg, data_cfg, splits=(cfg()["TEST"]["split"],))
    model = test_mains._load_variables(cfg, RobotNetVote(
        backbone=cfg()["STRUCTURE"].get("backbone", "minkunet"),
        in_channels=3, num_classes=2))
    batch = next(ds.batches(8, shuffle=False))
    card, cpu = (_point_logits(Forward(model, data_cfg, 4096, d), batch)
                 .cpu()[..., 1] for d in ("cuda", "cpu"))
    mask = torch.as_tensor(batch["mask"])
    rel = rel_err(card[mask], cpu[mask])
    items = []
    for g, w, m in zip(card, cpu, mask):
        top = torch.sort(w[m], descending=True).values
        items.append(dict(gap=float(top[top_k - 1] - top[top_k]),
                          max_diff=float((g[m] - w[m]).abs().max())))
    return dict(logits_rel_err=rel, items=items, missed=missed,
                explained=rel <= VOTE_LOGITS and all(
                    0 < items[i]["gap"] <= items[i]["max_diff"]
                    for i in missed))


OTHER_EVALS = (("test_pose", ("dist", "dist_position", "dist_orientation",
                               "angle_diff")),
               ("test_key_points", ("kp_error",)),
               ("test_vote", ("center_dist",)))


def _other_evals(root, refs):
    """(b) ``test_pose``, ``test_key_points`` and ``test_vote`` on the
    test split (one batch), card vs the CPU's runs (``refs``): distances
    within EVAL_DIST (m, relative above 1 m: a random RobotNet's
    eval-mode positions reach 1e8), the same keypoints found; a voted
    centre off by more only where ``_vote_near_tie`` finds a near tie."""
    from mrcc_tpu_torch.cli import test_mains

    cfg = _eval_config(root, "test")
    report = {}
    for name, keys in OTHER_EVALS:
        fn = getattr(test_mains, name)
        t = time.perf_counter()
        got = fn(cfg)
        card_s = time.perf_counter() - t
        want = refs["others"][name]
        ok = len(got["instances"]) == len(want["instances"]) > 0
        missed = []
        for i, (g, w) in enumerate(zip(got["instances"],
                                       want["instances"])):
            if not (all(_close_dist(g[k], w[k]) for k in keys)
                    and g.get("found") == w.get("found")):
                missed.append(i)
        ok &= not missed
        report[name] = dict(card_s=card_s, ok=ok, card=got["instances"],
                            cpu=want["instances"])
        if missed and name == "test_vote":
            report[name]["near_tie"] = _vote_near_tie(cfg, missed)
            ok = report[name]["near_tie"]["explained"]
        if not ok:
            raise AssertionError(f"{name} card vs CPU: {report[name]}")
    return report


def _first_frames(source):
    """The first of the APP_FRAMES frames of each position, as the card's
    cyclic engine meets them."""
    from mrcc_tpu_torch.app import PickleDataEngine

    first = {}
    for e in PickleDataEngine(source, split="train").entries[:APP_FRAMES]:
        first.setdefault(e["position"], e)
    return first


def _bench_app(root, counters, refs):
    """(c) ``test_app`` on the card over ``PickleDataEngine`` (APP_FRAMES
    frames of the train split), every stage timed; against the first
    frame of each position through a CPU engine of the same seeded
    weights (``refs``): bf16 seg accuracy within APP_SEG_ACC of the
    card's on that frame."""
    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.cli import test_mains
    from mrcc_tpu_torch.data.synthetic import gt_base2cam_pose

    cfg = _eval_config(root, "train")
    source = f"{root}/sample_splits.json"
    cfg()["INFERENCE"]["data_source"] = source
    test_mains.test_app(cfg, n_samples=1)       # warm-up (allocator)
    times = {}
    _zero(counters)
    with _stage_clock(times):
        t = time.perf_counter()
        res = test_mains.test_app(cfg, n_samples=APP_FRAMES)
        wall = time.perf_counter() - t
    launches = _read(counters)
    if min(launches.values()) <= 0:
        raise AssertionError(f"test_app: a kernel never ran: {launches}")
    profiled = 3
    busy = sum(profile_device_ms(lambda: test_mains.test_app(
        cfg, n_samples=profiled)).values()) / profiled
    cpu = InferenceEngine(cfg.inference_config(), device="cpu")
    card = InferenceEngine(cfg.inference_config())
    for stage, model in card.models().items():
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            model.state_dict().values(),
            cpu.models()[stage].state_dict().values()))
        if not same:
            raise AssertionError(f"test_app: {stage} weights differ")
    first = _first_frames(source)
    want, cpu_s = refs["app"]["want"], refs["app"]["cpu_s"]
    acc = {p: [res["positions"][p]["seg_accuracy"][0],
               want["positions"][p]["seg_accuracy"][0]] for p in first}
    acc_err = max(abs(a - b) for a, b in acc.values())
    gt = np.asarray(gt_base2cam_pose(), np.float32)
    calib = res["calibration"]
    report = dict(
        frames=APP_FRAMES, wall_s=wall, frames_per_s=APP_FRAMES / wall,
        device_busy_ms_a_frame=busy,
        device_idle_share=1 - busy * APP_FRAMES / (1e3 * wall),
        stage_ms={k: float(np.median(v)) for k, v in times.items()},
        stage_calls={k: len(v) for k, v in times.items()},
        launches=launches, report=res["report"],
        report_type=os.path.splitext(res["report"])[1],
        calibration_error=calib, gt_base2cam_pose=gt.tolist(),
        seg_accuracy_card_cpu=acc, seg_accuracy_max_diff=acc_err,
        cpu_s=cpu_s,
        metrics={k: float(np.mean(v)) for k, v in res["metrics"].items()},
        tolerance={"seg_accuracy": APP_SEG_ACC})
    if (acc_err > APP_SEG_ACC or len(first) < 2
            or not os.path.isfile(res["report"])):
        raise AssertionError(f"test_app card vs CPU: {report}")
    return report, card


def _sessions(root, engine):
    """(d) ``MainApp.run`` over ``SyntheticDataEngine`` (5 positions x 2
    frames) and ``calibrate_directory`` over two sample pickles and two
    ``_points.npy`` / ``_rgb.npy`` pairs, on the card."""
    import shutil

    from mrcc_tpu_torch.app import CalibrationResultDTO, SyntheticDataEngine
    from mrcc_tpu_torch.app.calibrate_pcd import calibrate_directory
    from mrcc_tpu_torch.app.main import MainApp
    from mrcc_tpu_torch.data.synthetic import generate_sample

    t = time.perf_counter()
    app = MainApp(SyntheticDataEngine(n_positions=5, frames_per_position=2,
                                      seed=400), engine=engine,
                  num_of_frames=2, min_num_of_positions=5)
    calib = app.run()
    main_s = time.perf_counter() - t
    frames = {k: len(v) for k, v in app.collected.items()}
    d = f"{root}/frames"
    os.makedirs(d)
    for i in (1, 2):
        shutil.copy(f"{root}/labeled/{i}.pickle", d)
    for i in (0, 1):
        s = generate_sample(seed=500 + i)
        np.save(f"{d}/n{i}_points.npy", s["points"])
        np.save(f"{d}/n{i}_rgb.npy", s["rgb"])
    t = time.perf_counter()
    dcalib = calibrate_directory(d, engine=engine, chunk=2)
    dir_s = time.perf_counter() - t
    ok = (isinstance(calib, CalibrationResultDTO)
          and isinstance(dcalib, CalibrationResultDTO)
          and frames == {f"p{i}": 2 for i in range(1, 6)})
    report = dict(main_app_s=main_s, main_app_frames=frames,
                  main_app_pose_camera_link=_listed(calib.pose_camera_link),
                  directory_s=dir_s,
                  directory_pose_camera_link=_listed(
                      dcalib.pose_camera_link))
    if not ok:
        raise AssertionError(f"sessions: {report}")
    return report


def _listed(pose):
    return None if pose is None else np.asarray(pose).tolist()


def _seg_levels(engine, pts, rgb, mask):
    """``seg_stage``'s voxels and hierarchy levels."""
    from mrcc_tpu_torch.geometry.preprocess import (center_at_origin,
                                                    normalize_colors)
    from mrcc_tpu_torch.sparse import voxelize

    cfg = engine.cfg
    with torch.no_grad():
        p, c, m = (engine._tensor(x, d) for x, d in (
            (pts, torch.float32), (rgb, torch.float32), (mask, torch.bool)))
        c = normalize_colors(c, mask=m)
        p = center_at_origin(p, mask=m)[0]
        vox, _ = voxelize(p, c, m, 1.0 / cfg.seg_scale,
                          cfg.seg_voxel_capacity)
        return vox, engine._hierarchy(vox, "seg")


@contextlib.contextmanager
def _outputs_of(module):
    """Every output of ``module``'s forward, appended to the list yielded."""
    out = []
    hook = module.register_forward_hook(lambda m, i, o: out.append(o))
    try:
        yield out
    finally:
        hook.remove()


def _conv_table():
    """The conv wrappers ``sparse.conv`` calls, by name: (the int8 twin,
    or None for a conv in the features' dtype; the unquantised plain
    conv)."""
    from mrcc_tpu_torch.ops import conv, conv_q8

    return {
        "gather_gemm_sk_q8": (conv_q8.gather_gemm_sk_q8_plain,
                              conv.gather_gemm_sk_plain),
        "gather_gemm_k3_map_q8": (conv_q8.gather_gemm_k3_map_q8_plain,
                                  conv.gather_gemm_k3_map_plain),
        "gather_gemm_down_q8": (conv_q8.gather_gemm_down_q8_plain,
                                conv.gather_gemm_down_plain),
        "gather_gemm_up_q8": (conv_q8.gather_gemm_up_q8_plain,
                              conv.gather_gemm_up_plain),
        "gather_gemm_sk": (None, conv.gather_gemm_sk_plain),
        "gather_gemm_k3_map": (None, conv.gather_gemm_k3_map_plain),
        "gather_gemm_down": (None, conv.gather_gemm_down_plain),
        "gather_gemm_up": (None, conv.gather_gemm_up_plain)}


@contextlib.contextmanager
def _conv_calls(calls):
    """Every call of a ``_conv_table`` wrapper through ``sparse.conv``
    appended to ``calls`` as ``(stage, name, args, out)``: the
    ``InferenceEngine`` stage it ran in ("seg", "rot", "kp", or None
    outside one), copies taken at the call (later in-place ops cannot move
    them)."""
    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.sparse import conv as sconv

    saved = {n: getattr(sconv, n) for n in _conv_table()}
    stages = {"seg_stage": "seg", "pose_stage": "rot", "kp_stage": "kp"}
    methods = {n: getattr(InferenceEngine, n) for n in stages}
    now = [None]

    def kept(name, fn):
        def run(*args):
            out = fn(*args)
            calls.append((now[0], name, tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), out.clone()))
            return out
        return run

    def tagged(method, fn):
        def run(*args, **kw):
            now[0] = stages[method]
            try:
                return fn(*args, **kw)
            finally:
                now[0] = None
        return run

    for n, fn in saved.items():
        setattr(sconv, n, kept(n, fn))
    for n, fn in methods.items():
        setattr(InferenceEngine, n, tagged(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(sconv, n, fn)
        for n, fn in methods.items():
            setattr(InferenceEngine, n, fn)


def _gate_says_int8(name, args):
    """The route ``hierarchy.q8_route`` gives a recorded conv's shapes (a
    self-keyed level runs int8 only)."""
    from mrcc_tpu_torch.sparse.hierarchy import q8_route

    f, maps = args[0], args[2:]
    size = f.element_size()
    if name.startswith("gather_gemm_sk"):
        return True
    if name.startswith("gather_gemm_k3_map"):
        return q8_route("k3", f.shape[1], f.shape[1], size)
    if name.startswith("gather_gemm_down"):
        return q8_route("down", f.shape[1], maps[0].shape[-1], size)
    return q8_route("up", maps[0].shape[-1], f.shape[1], size)


def _replay(calls, q8_stages):
    """Each recorded card conv on its own card inputs against its plain
    version: on the route the gate gives its shapes in a stage of
    ``q8_stages``, in the features' dtype in another; an int8 conv equal
    to its twin bit for bit (its distance from the unquantised f32 conv
    reported: the per-channel scales span every row of the input level,
    also rows the map never reads, as in the JAX wrappers, so a conv
    under a capacity-cut coarse level may quantise most of its inputs to
    0, ROADMAP C33); a conv in the features' dtype within TOL_F32 (f32)
    or TOL_BF16 (bf16) of the f32 plain conv.  Returns the calls by
    wrapper and feature dtype, with the largest relative error from the
    f32 conv and the int8 convs over TOL_Q8."""
    table = _conv_table()
    seen = {}
    for stage, name, args, got in calls:
        twin, unquantised = table[name]
        q8 = twin is not None
        f, w = args[:2]
        maps = args[2:-1] if q8 else args[2:]
        shape = (stage, name, tuple(f.shape), tuple(w.shape), str(f.dtype))
        if q8 != (stage in q8_stages and _gate_says_int8(name, args)):
            raise AssertionError(f"int8 routes: {shape} took the route the "
                                 "gate refuses")
        err = rel_err(got, unquantised(f.float(), w.float(), *maps))
        if q8 and not torch.equal(twin(*args), got):
            raise AssertionError(f"int8 routes: {shape} differs from its "
                                 f"twin (relative error from f32 {err})")
        tol = TOL_F32 if f.dtype == torch.float32 else TOL_BF16
        if not q8 and err > tol:
            raise AssertionError(f"int8 routes: {shape} relative error {err} "
                                 f"from the f32 plain conv (limit {tol})")
        key = f"{name}[{str(f.dtype).removeprefix('torch.')}]"
        row = seen.setdefault(key, {"calls": 0, "max_rel_err": 0.0})
        row["calls"] += 1
        row["max_rel_err"] = max(row["max_rel_err"], err)
        if q8 and err > TOL_Q8:
            row.setdefault("over_tol_q8", []).append(
                dict(stage=stage, rows=f.shape[1], cin=w.shape[1],
                     cout=w.shape[2], rel_err=err))
    return seen


def _input_drift(cpu_calls, card_calls):
    """Conv inputs, card against CPU, in call order: the relative error of
    the first, the index of the first over 1e-6, the largest."""
    drift = [rel_err(g[2][0].cpu(), w[2][0])
             for g, w in zip(card_calls, cpu_calls)]
    return {"convs": len(drift), "first": drift[0] if drift else None,
            "first_over_1e-6": next(
                (i for i, d in enumerate(drift) if d > 1e-6), None),
            "max": max(drift, default=None)}


# the int8 engines of (e): the configuration, and the conv wrappers (with
# the features' dtype) its batch must take: B7 on f32 features; int8
# beside the feature-dtype fallback where a level is not 128-aligned; B6
# and B7 on the bottleneck net
Q8R_ENGINES = (
    ("int8_f32", dict(compute_dtype="float32"),
     {"gather_gemm_k3_map_q8[float32]", "gather_gemm_down_q8[float32]",
      "gather_gemm_up_q8[float32]"}),
    ("int8_unaligned", dict(seg_hierarchy_caps=(512, 256, 128, 64),
                            kp_voxel_capacity=448),
     {"gather_gemm_sk_q8[bfloat16]", "gather_gemm_down_q8[bfloat16]",
      "gather_gemm_up_q8[bfloat16]", "gather_gemm_k3_map[bfloat16]",
      "gather_gemm_down[bfloat16]"}),
    ("int8_minkunet50", dict(seg_backbone="minkunet50",
                             kp_backbone="minkunet50"),
     {"gather_gemm_sk_q8[bfloat16]", "gather_gemm_down_q8[bfloat16]",
      "gather_gemm_up_q8[bfloat16]"}),
)


def _f32_q8_cases(engine, inputs, records):
    """B7's k3-table, down and up modes on f32 features at the int8_f32
    engine's seg levels (``q8_case`` records of path ``q8r``)."""
    from mrcc_tpu_torch.ops import conv, conv_q8

    _, feats, weights = case_inputs(17, torch.device("cuda"))
    levels = _seg_levels(engine, *inputs)[1]
    lv = levels[0]
    b, n = lv.key.shape
    q8_case(records, f"conv_k3map_q8[{b}x{n} 32->32 f32]", "conv_k3map_q8",
            MAP_Q8_TPU, "k3_table", conv_q8.gather_gemm_k3_map_q8,
            conv_q8.gather_gemm_k3_map_q8_plain, conv.gather_gemm_k3_map_plain,
            feats(lv, 32), weights(27, 32, 32), (lv.nbr_idx, lv.nbr_hit), n,
            _table_work(lv), path="q8r")
    fine, coarse = levels[0], levels[1]
    nf, nc = fine.key.shape[1], coarse.key.shape[1]
    q8_case(records, f"conv_down_q8[{b}x{nf}->{nc} 32->32 f32]",
            "conv_down_q8", MAP_Q8_TPU, "down", conv_q8.gather_gemm_down_q8,
            conv_q8.gather_gemm_down_q8_plain, conv.gather_gemm_down_plain,
            feats(fine, 32), weights(8, 32, 32),
            (coarse.child_idx, coarse.child_hit), nf, _down_work(coarse),
            path="q8r")
    fine, coarse = levels[-2], levels[-1]
    nf, nc = fine.key.shape[1], coarse.key.shape[1]
    q8_case(records, f"conv_up_q8[{b}x{nc}->{nf} 256->256 f32]",
            "conv_up_q8", MAP_Q8_TPU, "up", conv_q8.gather_gemm_up_q8,
            conv_q8.gather_gemm_up_q8_plain, conv.gather_gemm_up_plain,
            feats(coarse, 256), weights(8, 256, 256),
            (fine.parent_idx, fine.row_ok, fine.octant), nc, _up_work(fine),
            path="q8r")


def _q8_routes(counters, records, iters=5):
    """(e) the int8 engines whose configurations the port refused before
    the per-conv gate, at phase 4's small size, card vs CPU with the same
    weights and calibrated scales.  Every conv of the card's batch is
    replayed on its own card inputs (``_replay``: the gate's route, the
    twin's bits for int8, TOL_F32 / TOL_BF16 otherwise); the
    configuration's routes are checked (int8 and feature-dtype convs both
    where its levels call for both; the f32 engine's int8 convs on f32
    features); the seg logits are held to Q8R_LOGITS, and the seg labels'
    agreement and the seg convs' input drift card vs CPU reported (an int8
    engine amplifies the devices' rounding differences, ROADMAP C32).
    Then ``iters`` batches timed on the card, every launch count read over
    one of them; the f32 engine's B7 modes as ``q8_case`` records."""
    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.app.inference_engine import q8_stages
    from mrcc_tpu_torch.ops import conv, conv_q8

    report, total = {}, {ctr.name: 0 for ctr in counters}
    for name, kw, need in Q8R_ENGINES:
        inputs, cfg = _small_bf16_config(conv_impl="pallas-int8")
        pts, rgb, mask = inputs
        cfg = dataclasses.replace(cfg, **kw)
        cpu = InferenceEngine(cfg, device="cpu", seed=3).calibrate_q8(
            pts, rgb, mask)
        gpu = InferenceEngine(cfg, device="cuda", seed=5)
        for stage, model in gpu.models().items():
            model.load_state_dict(cpu.models()[stage].state_dict())
        t = time.perf_counter()
        cpu_calls, calls = [], []
        with _conv_calls(cpu_calls), _outputs_of(cpu.seg_model) as lw:
            want = cpu.predict_batch_arrays(pts, rgb, mask)
        cpu_s = time.perf_counter() - t
        t = time.perf_counter()
        with _conv_calls(calls), _outputs_of(gpu.seg_model) as lg:
            got = {k: v.cpu() for k, v in
                   gpu.predict_batch_arrays(pts, rgb, mask).items()}
        replayed = _replay(calls, q8_stages(cfg))
        drift = _input_drift(*([c for c in run if c[0] == "seg"]
                               for run in (cpu_calls, calls)))
        lw, lg = lw[0].float(), lg[0].float().cpu()
        check_s = time.perf_counter() - t
        del cpu_calls, calls
        m = torch.as_tensor(mask)
        agree = float((got["segmentation"] == want["segmentation"])[m]
                      .float().mean())
        logits_err = rel_err(lg, lw)
        p, c, mk = (torch.as_tensor(x, device="cuda")
                    for x in (pts, rgb, mask))
        _zero(counters)
        gpu.predict_batch_arrays(p, c, mk)
        launches = _read(counters)
        batch_s = []
        for _ in range(iters):
            t = time.perf_counter()
            gpu.predict_batch_arrays(p, c, mk)
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t)
        for k, v in launches.items():
            total[k] += v
        med = float(np.median(batch_s))
        busy = sum(profile_device_ms(
            lambda: gpu.predict_batch_arrays(p, c, mk)).values())
        q8 = sum(launches[ctr.name] for ctr in (
            conv_q8.SK_Q8, conv_q8.K3MAP_Q8, conv_q8.DOWN_Q8, conv_q8.UP_Q8))
        plain = sum(launches[ctr.name] for ctr in (
            conv.SK, conv.K3MAP, conv.DOWN, conv.UP))
        report[name] = dict(
            convs=replayed, routes_needed=sorted(need),
            seg_logits_rel_err=logits_err, seg_agree=agree,
            seg_input_drift=drift, cpu_s=cpu_s, check_s=check_s,
            ee_count=[want["ee_count"].tolist(), got["ee_count"].tolist()],
            k3_tables=gpu.k3_tables, launches=launches,
            batch_ms_median=1e3 * med, device_busy_ms=busy,
            device_idle_share=1 - busy / (1e3 * med),
            clouds_per_s_median=int(pts.shape[0]) / med,
            finite=all(bool(torch.isfinite(got[k]).all())
                       for k in ("ee_pose", "kp_pose")))
        missing = need - set(replayed)
        if (logits_err > Q8R_LOGITS or missing or not q8 or not plain
                or not report[name]["finite"]):
            raise AssertionError(f"int8 routes {name}: missing routes "
                                 f"{sorted(missing)}: {report[name]}")
        if name == "int8_f32":
            _f32_q8_cases(gpu, inputs, records)
    report["tolerance"] = {"seg_logits": Q8R_LOGITS, "int8_conv": {
        "ulps": 0, "rel_vs_f32": f"reported, over {TOL_Q8} listed"},
        "f32_conv": TOL_F32, "bf16_conv": TOL_BF16}
    return report, total


# phase 16's CPU references run in a child process on the last
# EVAL_CPU_CORES cores while the card phases run on the others
EVAL_CPU_CORES = 3


def eval_references(root):
    """Phase 16's CPU references, in a process without the card: (a)
    ``test_segmentation`` on the train split with each batch's point
    logits, (b) the three other test mains on the test split, (c) the
    first frame of each position through ``BenchmarkApp`` on a CPU engine
    of the default YAML (same seeded weights as the card's).  Written to
    ``{root}/cpu_refs.pt``."""
    from mrcc_tpu_torch.app import InferenceEngine, PickleDataEngine
    from mrcc_tpu_torch.cli import test_mains
    from mrcc_tpu_torch.data.synthetic import gt_base2cam_pose
    from mrcc_tpu_torch.eval import BenchmarkApp

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    refs = {"threads": torch.get_num_threads()}
    cfg = _eval_config(root, "train", exp="exp_cpu")
    logits = []
    t = time.perf_counter()
    with _point_logits_of(logits):
        want = test_mains.test_segmentation(cfg, device="cpu")
    refs["seg"] = dict(want=want, logits=logits,
                       cpu_s=time.perf_counter() - t)
    cfg = _eval_config(root, "test", exp="exp_cpu")
    refs["others"] = {name: getattr(test_mains, name)(cfg, device="cpu")
                      for name, _ in OTHER_EVALS}
    cfg = _eval_config(root, "train", exp="exp_cpu")
    source = f"{root}/sample_splits.json"
    cfg()["INFERENCE"]["data_source"] = source
    first = _first_frames(source)
    with open(f"{root}/first_frames.json", "w") as f:
        json.dump({"train": list(first.values())}, f)
    t = time.perf_counter()
    want = BenchmarkApp(
        InferenceEngine(cfg.inference_config(), device="cpu"),
        PickleDataEngine(f"{root}/first_frames.json", split="train",
                         cyclic=False),
        gt_base2cam_pose(), n_samples=len(first),
        ignore_unconfident=True).run()
    refs["app"] = dict(want=want, cpu_s=time.perf_counter() - t)
    torch.save(refs, f"{root}/cpu_refs.pt")


class EvalReferences:
    """Phase 16's sample set in a temporary directory and its CPU
    references (``eval_references``) computed by a child process of this
    script, started at once: on the last EVAL_CPU_CORES cores where the
    machine has twice as many (this process then keeps the others, with
    as many torch threads)."""

    def __init__(self):
        import tempfile

        from mrcc_tpu_torch.data.synthetic import write_sample_set

        self._dir = tempfile.TemporaryDirectory()
        self.root = self._dir.name
        t = time.perf_counter()
        write_sample_set(self.root, n=EVAL_SAMPLES)
        log("eval_data", samples=EVAL_SAMPLES,
            seconds=time.perf_counter() - t)
        cores = sorted(os.sched_getaffinity(0))
        child_cores = None
        if len(cores) >= 2 * EVAL_CPU_CORES:
            child_cores, keep = cores[-EVAL_CPU_CORES:], cores[:-EVAL_CPU_CORES]
            os.sched_setaffinity(0, keep)
            torch.set_num_threads(len(keep))
        self.cores = child_cores or cores
        self.t0 = time.perf_counter()
        self.child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--eval-references", self.root],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=(None if child_cores is None else
                        lambda: os.sched_setaffinity(0, child_cores)))

    def running(self) -> bool:
        return self.child.poll() is None

    def wait(self):
        """The references (waiting for the child if it is still busy)."""
        t = time.perf_counter()
        out, _ = self.child.communicate(timeout=900)
        if self.child.returncode != 0:
            raise AssertionError(f"phase 16 CPU references failed:\n"
                                 f"{out[-4000:]}")
        refs = torch.load(f"{self.root}/cpu_refs.pt", weights_only=False)
        log("eval_references", cores=self.cores, threads=refs["threads"],
            child_s=time.perf_counter() - self.t0,
            waited_s=time.perf_counter() - t,
            cpu_s={"seg": refs["seg"]["cpu_s"], "app": refs["app"]["cpu_s"]})
        return refs

    def close(self):
        if self.child.poll() is None:
            self.child.kill()
            self.child.communicate()
        self._dir.cleanup()


def phase_eval(references):
    """Phase 16: config, evaluation and the app's entry points on the card
    (a-e above) on the sample set of ``references`` (an
    ``EvalReferences``); returns the launches of paths ``ev``, ``app``,
    ``q8r`` and the ``q8_case`` records of (e)."""
    from mrcc_tpu_torch.ops import conv, conv_q8, rank, sort

    k3 = [sort.SORT, rank.RANK, conv.K3MAP, conv.DOWN, conv.UP,
          conv.K3_LISTS, conv.K3_SUM]
    app = [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
           conv.K3_SUM]
    q8 = k3 + [conv.SK, conv_q8.SK_Q8, conv_q8.K3MAP_Q8, conv_q8.DOWN_Q8,
               conv_q8.UP_Q8, conv_q8.Q8_QUANT, conv_q8.Q8_LISTS,
               conv_q8.Q8_SUM]
    root = references.root
    refs = references.wait()
    t = time.perf_counter()
    seg = _seg_eval(root, k3, refs)
    log("eval_segmentation", card=smi_line(),
        seconds=time.perf_counter() - t, **seg)
    t = time.perf_counter()
    log("eval_others", **_other_evals(root, refs),
        seconds=time.perf_counter() - t)
    t = time.perf_counter()
    bench, engine = _bench_app(root, app, refs)
    log("eval_app", card=smi_line(), seconds=time.perf_counter() - t,
        **bench)
    t = time.perf_counter()
    log("eval_sessions", **_sessions(root, engine),
        seconds=time.perf_counter() - t)
    records = []
    t = time.perf_counter()
    routes, q8_launches = _q8_routes(q8, records)
    log("eval_int8_routes", card=smi_line(), seconds=time.perf_counter() - t,
        **routes)
    log("eval_q8_kernels", card=smi_line(),
        cases=[{k: r.get(k) for k in CASE_KEYS} for r in records])
    return {"ev": seg["launches"], "app": bench["launches"],
            "q8r": q8_launches}, records


# ------------------------------------------------------ phase 17: parallel

DP_RANKS = 2     # (b): ranks sharing the one card over gloo
DP_STEPS = 3     # (b): data-parallel segmentation steps
DP_LOSS = 1e-4   # (b): their losses against the single-process step's, rel.
DP_LR = 1e-4     # phase 7's learning rate
DP_METRIC_LR = 1e-5      # (b), C35: at phase 7's 1e-4 no triplet of its
                         # 8 clouds is mined after the first step (loss 0)
# (b), C35: the metric-learning losses, absolute: the loss (~0.04) is a
# mean of hinges d_ap - d_an + margin over distances ~100x larger, so its
# relative error is the distances' rounding times ~100
DP_METRIC_LOSS = 1e-5
DP_METRIC_GRAD = 1e-4    # (b), C35: the first step's summed gradient norm,
                         # relative (later steps carry Adam's noise, C21)
DP_METRIC_PARAMS = 1e-4  # (b), C35: its parameters, relative norm
NATIVE_FPS = (16384, 1024)  # (c): FPS / ball query points and picks
NATIVE_BALL = (0.05, 32)    # (c): ball radius (m) and group size
ICP_POSE = 1e-4  # (d): ICP of the whole template from ~5 mm to its pose
# (d): the app's cropped ICP and its calibration, card vs CPU, are held to
# ICP_MARGIN x the CPU's own spread over ICP_DRAWS copies of each frame
# (points and seed) moved rigidly by up to ICP_SHIFT m on each axis: exact
# ICP moves with them, but every distance is rounded anew, as the card
# rounds them otherwise (ICP's distances are |s|^2 + |t|^2 - 2 s.t, so
# rounding at ~1 m moves them by ~1e-7 m^2 against neighbours ~1e-5 m^2
# apart); the same ICP cut to ICP_CONTROL_ITERS iterations must fall
# outside that limit on every frame
ICP_DRAWS = 32
ICP_SHIFT = 0.01
ICP_MARGIN = 2.0
ICP_CONTROL_ITERS = 7


def _equal_outputs(got, want):
    """The keys of two engine output dicts whose tensors differ."""
    return [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]


def _dp_mesh(engine, p, c, m, counters):
    """(a) ``engine`` on a 1-rank NCCL mesh against itself without one:
    the plain batch and ``fleet.globalize`` of it give outputs bit-equal
    to the engine's own, every kernel of its path launched (counts of
    the mesh call returned); the batch timed with and without the mesh
    in turns; the process group is torn down after."""
    import torch.distributed as dist

    from mrcc_tpu_torch.parallel import fleet, make_mesh

    want = engine.predict_batch_arrays(p, c, m)
    mesh = make_mesh(1, "cuda")
    backend = dist.get_backend()
    try:
        engine.mesh = mesh
        _zero(counters)
        with plain_calls() as plain:
            got = engine.predict_batch_arrays(p, c, m)
        launches = _read(counters)
        glob = engine.predict_batch_arrays(*fleet.globalize(mesh, p, c, m))
        local = {k: v.to_local() for k, v in glob.items()}
        # the batch with and without the mesh, in turns
        times = {True: [], False: []}
        for on in (False, True, True, False, False, True):
            engine.mesh = mesh if on else None
            t = time.perf_counter()
            engine.predict_batch_arrays(p, c, m)
            torch.cuda.synchronize()
            times[on].append(time.perf_counter() - t)
    finally:
        engine.mesh = None
        dist.destroy_process_group()
    differ = _equal_outputs(got, want) + _equal_outputs(local, want)
    report = dict(backend=backend, mesh_size=mesh.size(), launches=launches,
                  outputs_equal=not differ, batch_ms_median=1e3 * float(
                      np.median(times[True])),
                  no_mesh_batch_ms_median=1e3 * float(
                      np.median(times[False])))
    if differ or plain or min(launches.values()) <= 0:
        raise AssertionError(f"1-rank mesh: outputs {differ} differ, "
                             f"plain twins {plain}: {report}")
    return report, launches


def _dp_train_model():
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters

    return init_parameters(RobotNetSegmentation(backbone="minkunet"), 1)


def dp_rank(rank, world, port, out_dir):
    """One rank of (b), in its own process on the card: gloo, ``world``
    ranks, the bench engine on this rank's rows of phase 6's batch
    (``fleet.globalize``), then DP_STEPS phase-7 segmentation steps and
    DP_STEPS phase-12 c feature-extractor steps (C35) through
    ``Trainer(mesh=...).step`` on the full batch; writes its rows, losses,
    step times, launch counts and hashes of its parameters (the first
    rank also the feature extractor's parameters) to
    ``{out_dir}/rank{rank}.pt``."""
    import hashlib
    import tempfile

    import torch.distributed as dist

    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.data.synthetic import build_batch
    from mrcc_tpu_torch.parallel import fleet
    from mrcc_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    spec = torch.load(f"{out_dir}/spec.pt", weights_only=False)
    counters = _dp_counters()
    assert fleet.init_distributed(f"127.0.0.1:{port}", world, rank,
                                  device="cuda", timeout_s=300) is True
    # more ranks than cards on the host: gloo, each on card 0
    assert dist.get_backend() == "gloo"
    mesh = fleet.make_global_mesh("cuda")
    warm = torch.ones(1, device="cuda")
    dist.all_reduce(warm)       # the group's first collective, at once
    assert float(warm) == world
    out = {"rank": rank, "startup_s": time.perf_counter() - t0}

    pts, rgb, mask = build_batch(8, 16384, seed=0)
    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
    engine = InferenceEngine(bench_config(pts, spec["caps"]), seed=0,
                             mesh=mesh)
    local = fleet.globalize(mesh, pts[rows], rgb[rows], mask[rows])
    engine.predict_batch_arrays(*local)  # warm-up
    _zero(counters)
    res = engine.predict_batch_arrays(*local)
    out["engine_launches"] = _read(counters)
    out["rows"] = {k: v.to_local().cpu() for k, v in res.items()}
    del engine, res
    torch.cuda.empty_cache()

    model = _dp_train_model()
    step = _seg_step(model)
    with tempfile.TemporaryDirectory() as exp:
        trainer = Trainer(model, None, step, step.optimizer, spec["tc"],
                          exp_path=exp, mesh=mesh)
        batch = train_batch()
        losses, step_s = [], []
        _zero(counters)
        for _ in range(DP_STEPS):
            t = time.perf_counter()
            losses.append(float(trainer.step(batch, DP_LR)["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    out["train_launches"] = _read(counters)
    flat = torch.cat([q.detach().reshape(-1) for q in model.parameters()])
    bufs = torch.cat([b.reshape(-1) for b in model.buffers()])
    out.update(losses=losses, step_s=step_s,
               param_sha=hashlib.sha256(flat.cpu().numpy().tobytes())
               .hexdigest(),
               buffer_sha=hashlib.sha256(bufs.cpu().numpy().tobytes())
               .hexdigest())
    del model, step, trainer
    torch.cuda.empty_cache()

    # C35: the feature extractor's mined triplet loss over the global batch
    model, step = _dp_metric_step()
    with tempfile.TemporaryDirectory() as exp:
        trainer = Trainer(model, None, step, step.optimizer, spec["tc"],
                          exp_path=exp, mesh=mesh)
        _zero(counters)
        out["metric_losses"], out["metric_grad_norms"] = [], []
        for _ in range(DP_STEPS):
            out["metric_losses"].append(float(trainer.step(
                _dp_metric_batch(), DP_METRIC_LR)["loss"]))
            out["metric_grad_norms"].append(_grad_norm(model))
    out["metric_launches"] = _read(counters)
    flat = torch.cat([q.detach().reshape(-1) for q in model.parameters()])
    bufs = torch.cat([b.reshape(-1) for b in model.buffers()])
    out.update(metric_param_sha=hashlib.sha256(
                   flat.cpu().numpy().tobytes()).hexdigest(),
               metric_buffer_sha=hashlib.sha256(
                   bufs.cpu().numpy().tobytes()).hexdigest(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if rank == 0:
        out["metric_params"] = flat.cpu()
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


def _dp_counters():
    from mrcc_tpu_torch.ops import conv, rank, sort

    return [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
            conv.K3_SUM, conv.DW_SK, conv.DW_DOWN, conv.DW_UP, conv.DW_LISTS,
            rank.RANK, conv.K3MAP, conv.DW_K3MAP]


def _dp_metric_step():
    """(b)'s feature-extractor step: phase 12 c's FeatureNet (minkunet34A
    -> 16, seeded) and its metric-learning step on the card."""
    from mrcc_tpu_torch.cli.train_mains import FEATURE_CAPACITY
    from mrcc_tpu_torch.data.ycb import YCBDataset
    from mrcc_tpu_torch.models import FeatureNet
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import (TrainConfig,
                                      make_metric_learning_train_step)

    model = init_parameters(FeatureNet(backbone="minkunet34A"), 4)
    cfg = YCBDataset(num_classes=1, samples_per_class=1,
                     max_points=1024).cfg
    return model, make_metric_learning_train_step(
        model, cfg, TrainConfig(batch_size=8), FEATURE_CAPACITY)[0]


def _grad_norm(model):
    """The norm of the parameters' ``.grad`` (in float64)."""
    return float(torch.cat([p.grad.reshape(-1) for p in model.parameters()
                            if p.grad is not None]).double().norm())


def _dp_metric_batch():
    """Phase 12 c's 8 clouds, two of each of 4 classes in class order: each
    rank's 4 hold two classes the other's lack, so the global miner pairs
    other triplets than a miner per rank."""
    return _object_batch(8, 6, range(4))


def _dp_ranks(engine, p, c, m, caps):
    """(b) DP_RANKS processes on the one card (gloo: NCCL refuses two
    ranks on one device; gloo's collectives take card tensors), spawned
    after the kernels were built: each rank's engine rows bit-equal to
    this process's engine on that shard; DP_STEPS data-parallel phase-7
    steps whose losses are within DP_LOSS of the single-process step's
    on the same batch, both ranks' parameters and BN statistics
    bit-equal; then (ROADMAP C35) DP_STEPS data-parallel steps of phase 12
    c's feature extractor at DP_METRIC_LR, whose triplets are mined over
    both ranks' embeddings: losses within DP_METRIC_LOSS (absolute), the
    first step's summed gradient norm within DP_METRIC_GRAD (Adam's update
    does not see a gradient's scale) and parameters within
    DP_METRIC_PARAMS (relative norm) of the single-process steps on the
    same 8 clouds, both ranks bit-equal.  Steps/s of two ranks sharing one
    card measure no data-parallel speed."""
    import tempfile

    from mrcc_tpu_torch.parallel.mesh import free_port
    from mrcc_tpu_torch.train import TrainConfig

    tc = TrainConfig(batch_size=8)
    shards = []
    for r in range(DP_RANKS):
        rows = slice(r * 8 // DP_RANKS, (r + 1) * 8 // DP_RANKS)
        shards.append({k: v.cpu() for k, v in engine.predict_batch_arrays(
            p[rows], c[rows], m[rows]).items()})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.save({"caps": caps, "tc": tc}, f"{out_dir}/spec.pt")
        port = free_port()
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
             str(DP_RANKS), str(port), out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_RANKS)]
        # the single-process reference steps while the ranks start
        model = _dp_train_model()
        step = _seg_step(model)
        batch = train_batch()
        want = [float(step(batch, DP_LR)["loss"]) for _ in range(DP_STEPS)]
        torch.cuda.synchronize()
        del model, step
        torch.cuda.empty_cache()
        model, step = _dp_metric_step()
        metric_want, metric_grads = [], []
        for _ in range(DP_STEPS):
            metric_want.append(float(step(_dp_metric_batch(),
                                          DP_METRIC_LR)["loss"]))
            metric_grads.append(_grad_norm(model))
        metric_params = torch.cat([q.detach().reshape(-1)
                                   for q in model.parameters()])
        del model, step
        torch.cuda.empty_cache()
        logs = []
        try:
            for q in procs:
                logs.append(q.communicate(timeout=600)[0])
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.communicate()
        wall = time.perf_counter() - t
        for r, (q, text) in enumerate(zip(procs, logs)):
            if q.returncode != 0:
                raise AssertionError(f"rank {r} failed:\n{text[-4000:]}")
        ranks = [torch.load(f"{out_dir}/rank{r}.pt", weights_only=False)
                 for r in range(DP_RANKS)]
    differ = {r["rank"]: _equal_outputs(r["rows"], shards[r["rank"]])
              for r in ranks}
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], want))
    same = all(ranks[0][k] == r[k] for r in ranks
               for k in ("losses", "param_sha", "buffer_sha"))
    if min(metric_want) <= 0:
        raise AssertionError(f"C35: no triplet mined in a single-process "
                             f"step, nothing to compare: {metric_want}")
    metric_loss_err = max(abs(a - b) for r in ranks
                          for a, b in zip(r["metric_losses"], metric_want))
    metric_loss_rel = max(abs(a - b) / b for r in ranks
                          for a, b in zip(r["metric_losses"], metric_want))
    metric_grad_errs = [abs(a - b) / b for a, b in zip(
        ranks[0]["metric_grad_norms"], metric_grads)]
    metric_grad_err = metric_grad_errs[0]
    metric_param_err = rel_err(ranks[0]["metric_params"].cuda(),
                               metric_params)
    metric_same = all(ranks[0][k] == r[k] for r in ranks
                      for k in ("metric_losses", "metric_grad_norms",
                                "metric_param_sha", "metric_buffer_sha"))
    launches = {}
    for r in ranks:
        for part in ("engine_launches", "train_launches", "metric_launches"):
            for k, v in r[part].items():
                launches[k] = launches.get(k, 0) + v
    step_s = [float(np.median(r["step_s"])) for r in ranks]
    report = dict(
        ranks=DP_RANKS, backend="gloo", wall_s=wall,
        startup_s=[r["startup_s"] for r in ranks],
        rows_equal={k: not v for k, v in differ.items()},
        losses=[r["losses"] for r in ranks], single_process_losses=want,
        loss_max_rel_err=loss_err, ranks_bit_equal=same,
        engine_launches=[r["engine_launches"] for r in ranks],
        train_launches=[r["train_launches"] for r in ranks],
        metric_losses=[r["metric_losses"] for r in ranks],
        metric_single_process_losses=metric_want,
        metric_loss_max_abs_err=metric_loss_err,
        metric_loss_max_rel_err=metric_loss_rel,
        metric_grad_norms=[r["metric_grad_norms"] for r in ranks],
        metric_single_process_grad_norms=metric_grads,
        metric_grad_norm_rel_errs=metric_grad_errs,
        metric_param_rel_err=metric_param_err,
        metric_ranks_bit_equal=metric_same,
        metric_launches=[r["metric_launches"] for r in ranks],
        steps_per_s_median=[1 / x for x in step_s],
        steps_per_s_note="two ranks share one card: no measure of "
                         "data-parallel speed",
        peak_mem_gb=[r["peak_mem_gb"] for r in ranks],
        tolerance={"loss_rel": DP_LOSS, "rows": "bits", "ranks": "bits",
                   "metric_loss_abs": DP_METRIC_LOSS,
                   "metric_first_grad_norm_rel": DP_METRIC_GRAD,
                   "metric_params_rel": DP_METRIC_PARAMS},
        card=smi_line())
    if (any(differ.values()) or loss_err > DP_LOSS or not same
            or metric_loss_err > DP_METRIC_LOSS or not metric_same
            or metric_grad_err > DP_METRIC_GRAD
            or metric_param_err > DP_METRIC_PARAMS
            or min(launches.values()) <= 0):
        raise AssertionError(f"2 ranks on one card: {report}")
    return report, launches


def _dp_native(seed=60):
    """(c) the host runtime (``native``, built here with the host
    compiler) on one 640 x 480 frame against the card: its voxels against
    the card voxelizer's (every point in the same voxel but for points
    within 1e-4 of a voxel border, where ``x * (1 / q)`` and ``x / q``
    may round apart; feature means 1e-5 and labels equal in the voxels
    they do not touch), FPS against ``ops.points.farthest_point_sample``
    and the ball query against ``query_ball_point`` on the card, on
    NATIVE_FPS points of the frame centred (indices equal but past a near
    tie; ball rows equal but for a member within BALL_EDGE of the
    radius)."""
    from mrcc_tpu_torch import native
    from mrcc_tpu_torch.data.synthetic import build_batch
    from mrcc_tpu_torch.ops import points
    from mrcc_tpu_torch.sparse import voxelize

    t = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t
    pts, rgb, mask, labels = build_batch(1, FRAME_POINTS, seed=seed,
                                         with_labels=True)
    q = 1 / 200.0
    hp, hc, hl = pts[0][mask[0]], rgb[0][mask[0]], labels[0][mask[0]]
    t = time.perf_counter()
    coords, feats, vlab, pv, nv = native.voxelize_host(hp, hc, q, len(hp),
                                                       labels=hl)
    host_ms = {"voxelize": 1e3 * (time.perf_counter() - t)}
    dev = torch.device("cuda")
    p, c, l = (torch.as_tensor(x, device=dev) for x in (hp, hc, hl))
    torch.cuda.synchronize()
    t = time.perf_counter()
    vox, cpv, clab = voxelize(p[None], c[None], torch.ones_like(l[None],
                                                                dtype=bool),
                              q, len(hp), labels=l[None])
    torch.cuda.synchronize()
    card_ms = {"voxelize": 1e3 * (time.perf_counter() - t)}
    ccoords = vox.coords()[0].cpu().numpy()
    cfeats, clab = vox.feats[0].cpu().numpy(), clab[0].cpu().numpy()
    cpv = cpv[0].cpu().numpy()
    moved = np.flatnonzero((coords[pv] != ccoords[cpv]).any(-1))
    scaled = hp[moved].astype(np.float64) / q
    if (np.abs(scaled - np.round(scaled)) > 1e-4).all(-1).any():
        raise AssertionError("native voxelize: a point off a voxel border "
                             "lands in another voxel than the card's")
    touched = {tuple(x) for x in coords[pv[moved]]} | {
        tuple(x) for x in ccoords[cpv[moved]]}
    card = {tuple(k): i for i, k in enumerate(ccoords[:int(vox.count[0])])}
    compared, feat_err = 0, 0.0
    for i in range(nv):
        k = tuple(coords[i])
        if k in touched:
            continue
        j = card[k]
        feat_err = max(feat_err, float(np.abs(feats[i] - cfeats[j]).max()))
        if vlab[i] != clab[j]:
            raise AssertionError(f"native voxelize: label of voxel {k}")
        compared += 1
    if feat_err > 1e-5 or nv != int(vox.count[0]) and not len(moved):
        raise AssertionError(f"native voxelize: feats {feat_err}, voxels "
                             f"{nv} against {int(vox.count[0])}")

    n, k = NATIVE_FPS
    sub = (hp[:n] - hp[:n].mean(0)).astype(np.float32)
    t = time.perf_counter()
    hfps = native.fps_host(sub, k)
    host_ms["fps"] = 1e3 * (time.perf_counter() - t)
    xyz = torch.as_tensor(sub, device=dev)[None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    cfps = points.farthest_point_sample(xyz, k)[0].cpu()
    card_ms["fps"] = 1e3 * (time.perf_counter() - t)
    fps_report = {"picks": k, "equal": bool(np.array_equal(hfps, cfps))}
    if not fps_report["equal"]:
        div = _fps_divergence(torch.as_tensor(sub)[None], cfps[None],
                              torch.as_tensor(hfps)[None])
        fps_report["divergence"] = div
        if abs(div["card_d2_f64"] - div["cpu_d2_f64"]) > 1e-6 * max(
                div["card_d2_f64"], 1e-12):
            raise AssertionError(f"native FPS: not a near tie: {div}")
    radius, ns = NATIVE_BALL
    queries = sub[hfps]
    t = time.perf_counter()
    hball = native.ball_query_host(sub, queries, radius, ns)
    host_ms["ball_query"] = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cball = points.query_ball_point(radius, ns, xyz, torch.as_tensor(
        queries, device=dev)[None])[0].cpu().numpy()
    card_ms["ball_query"] = 1e3 * (time.perf_counter() - t)
    rows = np.flatnonzero((hball != cball).any(-1))
    x64 = sub.astype(np.float64)
    for r in rows:
        d2 = ((x64 - x64[hfps[r]]) ** 2).sum(-1)
        if not (np.abs(d2 - radius ** 2) < BALL_EDGE).any():
            raise AssertionError(f"native ball query: row {r} differs with "
                                 "no member at the edge")
    return dict(library=lib.name, build_s=build_s, frame_points=len(hp),
                voxels=nv, points_moved_at_border=len(moved),
                voxels_compared=compared, feats_max_abs_err=feat_err,
                fps=fps_report, ball_rows=len(hball),
                ball_rows_at_edge=len(rows), host_ms=host_ms,
                card_ms=card_ms)


def _pose_diff(a, b):
    """Largest coordinate difference of two 7-vector poses, the
    quaternions compared up to sign."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(max(np.abs(a[:3] - b[:3]).max(),
                     min(np.abs(a[3:] - b[3:]).max(),
                         np.abs(a[3:] + b[3:]).max())))


def _tag_frame(tilt, depth):
    """A synthetic tag (``utils.aruco``'s canonical corners) facing the
    camera, turned by ``tilt`` about the camera's y axis, ``depth`` m
    away: its pixel corners (the pinhole projection of its 3D corners)
    and a depth image of its plane (a 20 cm square of points), with its
    rotation and centre."""
    from mrcc_tpu_torch.utils import aruco

    k = aruco.CAMERA_MATRIX_DEFAULT
    ct, st = np.cos(tilt), np.sin(tilt)
    turn = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]])
    # tag x (its normal) towards the camera, y along the image's x
    rot = turn @ np.array([[0.0, 1, 0], [0, 0, -1], [-1, 0, 0]])
    t = np.array([0.05, -0.03, depth])
    half = 0.075 / 2
    ref = np.array([[0, half, -half], [0, -half, -half], [0, -half, half],
                    [0, half, half]])
    corners = ref @ rot.T + t
    px = np.stack([k[0, 0] * corners[:, 0] / corners[:, 2] + k[0, 2],
                   k[1, 1] * corners[:, 1] / corners[:, 2] + k[1, 2]], 1)
    g = np.linspace(-0.1, 0.1, 400)
    yy, zz = np.meshgrid(g, g)
    plane = np.stack([np.zeros(yy.size), yy.ravel(), zz.ravel()],
                     1) @ rot.T + t
    _, depth_img = aruco.project_to_rgbd(plane.astype(np.float32),
                                         np.ones_like(plane), k)
    return px.astype(np.float32), depth_img, rot, t


def _dp_aruco():
    """(d) the ArUco baseline without cv2, on four frames of two
    positions: the tag pose from synthetic corners
    (``tag_pose_from_corners``) on the card against the CPU (1e-5) and the
    tag's true pose (1 cm: corners are truncated to pixels); ICP
    (``icp_refine``, the plain nearest neighbour as the app runs it) of
    the engine's EE template placed at the tag pose, from a seed ~5 mm
    off, on the card and the CPU: both within ICP_POSE of the tag pose.
    Then the app's own ``refine`` (the points cropped to the EE box of the
    seed, which cuts ~20 % of the template: ICP slides ~5e-4 an iteration
    towards an optimum ~1 cm off, and the nearest neighbours at the cut
    flip when the distances round otherwise, ROADMAP C5) and
    ``calibrate`` of its results, card vs CPU, each within ICP_MARGIN x
    the CPU's own spread over ICP_DRAWS rigid moves of the frame (see
    ICP_DRAWS); the
    same with ICP_CONTROL_ITERS iterations on the CPU, the control, must
    exceed both limits, on every frame for ``refine``."""
    from mrcc_tpu_torch.app import (ArucoCalibrationApp, InferenceConfig,
                                    InferenceEngine, ResultDTO)
    from mrcc_tpu_torch.data.synthetic import quat_to_matrix_np
    from mrcc_tpu_torch.geometry.transform import base2cam_pose
    from mrcc_tpu_torch.solve import icp_refine
    from mrcc_tpu_torch.utils import aruco

    cfg = InferenceConfig(icp_iterations=15, icp_template_points=1024)
    apps = {d: ArucoCalibrationApp(None, engine=InferenceEngine(
        cfg, device=d, calibration_only=True)) for d in ("cuda", "cpu")}
    control = ArucoCalibrationApp(None, engine=InferenceEngine(
        InferenceConfig(icp_iterations=ICP_CONTROL_ITERS,
                        icp_template_points=1024), device="cpu",
        calibration_only=True))
    tmpl = apps["cpu"].engine.template.numpy().astype(np.float64)
    worst = dict(tag_card_cpu=0.0, tag_vs_truth_m=0.0, icp_to_tag=0.0,
                 icp_card_cpu=0.0, app_card_cpu=0.0, app_cpu_spread=0.0,
                 app_to_tag_m=0.0, app_control_min=np.inf)
    # the card, the CPU, the CPU's moved copies and the control
    runs = ("cuda", "cpu", *range(ICP_DRAWS), "control")
    results = {r: {} for r in runs}
    rng = np.random.default_rng(17)
    for f, (tilt, depth, pos) in enumerate(((0.1, 0.9, "p1"),
                                            (0.15, 0.95, "p1"),
                                            (-0.1, 1.1, "p2"),
                                            (-0.05, 1.0, "p2"))):
        px, depth_img, rot, tt = _tag_frame(tilt, depth)
        tag = {d: aruco.tag_pose_from_corners(px, depth_img, device=d)
               for d in apps}
        worst["tag_card_cpu"] = max(worst["tag_card_cpu"],
                                    _pose_diff(tag["cuda"], tag["cpu"]))
        truth = tt + rot @ np.array([-0.012, 0.0, -0.05])
        worst["tag_vs_truth_m"] = max(worst["tag_vs_truth_m"], float(
            np.abs(tag["cpu"][:3] - truth).max()))
        ee = (tmpl @ quat_to_matrix_np(tag["cpu"][3:]).T
              + tag["cpu"][:3]).astype(np.float32)
        seed = (tag["cpu"] + np.array([0.004, -0.003, 0.002, 0, 0, 0, 0])
                ).astype(np.float32)
        icp = {}
        for d, app in apps.items():
            e = app.engine
            icp[d] = icp_refine(
                e.template, torch.as_tensor(ee, device=d)[None],
                torch.ones((1, len(ee)), dtype=torch.bool, device=d),
                torch.as_tensor(seed, device=d)[None],
                iterations=cfg.icp_iterations)[0].cpu().numpy()
            worst["icp_to_tag"] = max(worst["icp_to_tag"],
                                      _pose_diff(icp[d], tag["cpu"]))
        worst["icp_card_cpu"] = max(worst["icp_card_cpu"],
                                    _pose_diff(icp["cuda"], icp["cpu"]))
        ee2base = np.array([0.4, 0.1 * f, 0.5, 0.96, 0.0, 0.28, 0.0])
        refined = {d: app.refine(ee, seed) for d, app in apps.items()}
        shifts = rng.uniform(-ICP_SHIFT, ICP_SHIFT, (ICP_DRAWS, 3))
        refined.update(enumerate(_icp_moved(apps["cpu"], ee, seed,
                                            shifts.astype(np.float32))))
        refined["control"] = control.refine(ee, seed)
        for r in runs:
            results[r].setdefault(pos, []).append(ResultDTO(
                segmentation=None, ee_pose=refined[r], is_confident=True,
                base_pose=apps["cpu"].engine._pose_np(
                    base2cam_pose, refined[r], ee2base)))
        worst["app_cpu_spread"] = max(worst["app_cpu_spread"], *(
            _pose_diff(refined[k], refined["cpu"])
            for k in range(ICP_DRAWS)))
        worst["app_control_min"] = min(worst["app_control_min"], _pose_diff(
            refined["control"], refined["cpu"]))
        worst["app_card_cpu"] = max(worst["app_card_cpu"], _pose_diff(
            refined["cuda"], refined["cpu"]))
        worst["app_to_tag_m"] = max(worst["app_to_tag_m"], float(
            np.abs(refined["cuda"][:3] - tag["cpu"][:3]).max()))
    calib = {r: apps["cuda" if r == "cuda" else "cpu"].engine.calibrate(
        results[r]).pose_camera_link for r in runs}
    calib_err = _pose_diff(calib["cuda"], calib["cpu"])
    calib_spread = max(_pose_diff(calib[k], calib["cpu"])
                       for k in range(ICP_DRAWS))
    calib_control = _pose_diff(calib["control"], calib["cpu"])
    app_limit = ICP_MARGIN * worst["app_cpu_spread"]
    calib_limit = ICP_MARGIN * calib_spread
    report = dict(frames=4, draws=ICP_DRAWS,
                  calibration=np.asarray(calib["cuda"]).tolist(),
                  calibration_card_cpu=calib_err,
                  calibration_cpu_spread=calib_spread,
                  calibration_control=calib_control, **worst,
                  app_card_cpu_over_spread=_ratio(
                      worst["app_card_cpu"], worst["app_cpu_spread"]),
                  calibration_card_cpu_over_spread=_ratio(
                      calib_err, calib_spread),
                  control_iterations=ICP_CONTROL_ITERS,
                  tolerance={"tag_card_cpu": 1e-5, "tag_vs_truth_m": 0.01,
                             "icp_to_tag": ICP_POSE,
                             "app_card_cpu": app_limit,
                             "calibration_card_cpu": calib_limit,
                             "app_control_min": f"> {app_limit}",
                             "calibration_control": f"> {calib_limit}"})
    if (worst["tag_card_cpu"] > 1e-5 or worst["tag_vs_truth_m"] > 0.01
            or worst["icp_to_tag"] > ICP_POSE
            or worst["app_card_cpu"] > app_limit or calib_err > calib_limit
            or worst["app_control_min"] <= app_limit
            or calib_control <= calib_limit
            or not np.isfinite(calib["cuda"]).all()):
        raise AssertionError(f"aruco: {report}")
    return report


def _icp_moved(app, ee, seed, shifts):
    """The app's ICP (``refine``: the crop to the seed's EE box, then
    ``icp_refine``) of ``ee`` from ``seed`` on the CPU, on a copy of the
    frame moved by each of ``shifts`` [K, 3] (one batched call), moved
    back: [K, 7]."""
    from mrcc_tpu_torch.data.labels import get_ee_idx
    from mrcc_tpu_torch.solve import icp_refine

    crops, seeds = [], []
    for d in shifts:
        pts, s = (ee + d).astype(np.float32), seed.copy()
        s[:3] += d
        crops.append(pts[get_ee_idx(pts, s)])
        seeds.append(s)
    n = max(len(c) for c in crops)
    assert min(len(c) for c in crops) > 64, "refine would skip ICP"
    pts = np.zeros((len(crops), n, 3), np.float32)
    mask = np.zeros((len(crops), n), bool)
    for i, c in enumerate(crops):
        pts[i, :len(c)], mask[i, :len(c)] = c, True
    out = icp_refine(app.engine.template, torch.from_numpy(pts),
                     torch.from_numpy(mask), torch.from_numpy(np.stack(seeds)),
                     iterations=app.engine.cfg.icp_iterations)
    out = out.numpy().astype(np.float64)
    out[:, :3] -= shifts
    return out


def _ratio(err, spread):
    """``err`` over ``spread`` (inf where the spread is 0)."""
    return err / spread if spread > 0 else float("inf")


def _dp_viewer(pts, out, root):
    """(e) ``write_html_viewer`` of item 0 of the engine's output: the
    embedded buffer decodes back to its points."""
    import base64

    from mrcc_tpu_torch.viz import write_html_viewer

    path = write_html_viewer(f"{root}/viewer.html", pts[0], None,
                             out["segmentation"][0], use_seg=True)
    with open(path) as f:
        html = f.read()
    back = np.frombuffer(base64.b64decode(html.split('atob("')[1].split(
        '")')[0]), np.float32).reshape(-1, 3)
    if not np.array_equal(back, np.asarray(pts[0], np.float32)):
        raise AssertionError("html viewer: the embedded points differ")
    return dict(bytes=len(html), points=len(back))


def phase_parallel(inputs, caps, counters):
    """Phase 17 (a-e above); returns the launches of path ``dp`` (the
    1-rank mesh engine call and both ranks' engine calls and steps)."""
    import importlib.util
    import tempfile

    from mrcc_tpu_torch.app import InferenceEngine

    log("optional_modules", **{m: importlib.util.find_spec(m) is not None
                               for m in ("matplotlib", "cv2", "yaml")})
    pts, rgb, mask = inputs
    engine = InferenceEngine(bench_config(pts, caps), seed=0)
    p, c, m = (torch.as_tensor(x, device="cuda") for x in inputs)
    engine.predict_batch_arrays(p, c, m)  # warm-up
    t = time.perf_counter()
    mesh, launches = _dp_mesh(engine, p, c, m, counters)
    log("dp_mesh", card=smi_line(), seconds=time.perf_counter() - t, **mesh)
    t = time.perf_counter()
    ranks, rank_launches = _dp_ranks(engine, p, c, m, caps)
    log("dp_ranks", seconds=time.perf_counter() - t, **ranks)
    for k, v in rank_launches.items():
        launches[k] = launches.get(k, 0) + v
    for name, fn in (("dp_native", _dp_native), ("dp_aruco", _dp_aruco)):
        t = time.perf_counter()
        report = fn()
        log(name, card=smi_line(), seconds=time.perf_counter() - t, **report)
    out = engine.predict_batch_arrays(p, c, m)
    with tempfile.TemporaryDirectory() as root:
        log("dp_viewer", **_dp_viewer(pts, out, root))
    return {"dp": launches}


# ------------------------------------------------------ phase 18: demo

# (short, the default run) the r2 recipe's 32 scenes for 6 epochs (24
# steps at batch 8), 256 EE crops for 2 epochs, 5 held-out frames
DEMO_SHORT = ["--samples", "32", "--epochs", "6", "--ee-mult", "8",
              "--pose-epochs", "2", "--bench-samples", "5"]
# (--demo) the r2 recipe of RESULTS.md, as the JAX r2 table has it
DEMO_FULL = ["--samples", "32", "--epochs", "40", "--ee-mult", "64",
             "--pose-epochs", "24", "--bench-samples", "20"]
DEMO_SEG_LOSS = 0.2    # epoch-6 train loss at most (JAX 14A: 0.041)
DEMO_SEG_ACC = 0.95    # epoch-6 train accuracy at least (JAX 14A: 0.988)
DEMO_CPU_AGREE = 0.99  # trained seg labels card vs CPU, share of points
DEMO_CPU_FRAMES = 2    # frames of that check (4 in --demo)


def demo_counters():
    from mrcc_tpu_torch.ops import conv, rank, sort

    return [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
            conv.K3_SUM, conv.DW_SK, conv.DW_DOWN, conv.DW_UP, conv.DW_LISTS,
            rank.RANK, conv.K3MAP, conv.DW_K3MAP]


def _demo_main(flags, root, counters=None):
    """``demo_checkpoints.main`` on the card with ``flags`` into ``root``:
    ``(result, launches, plain twin calls, seconds)``."""
    from mrcc_tpu_torch.cli import demo_checkpoints as demo

    if counters:
        _zero(counters)
    t = time.perf_counter()
    with plain_calls() as plain:
        res = demo.main(flags + ["--out", root])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return res, (_read(counters) if counters else {}), dict(plain), seconds


def _demo_frames(n):
    """The first ``n`` held-out frames of the demo's bench source, each
    padded as ``predict`` pads it: ``[n, P, 3]`` points and colours and
    the ``[n, P]`` mask (numpy)."""
    from mrcc_tpu_torch.cli.demo_checkpoints import Recipe, bench_source

    recipe, source = Recipe(), bench_source(Recipe())
    pts = np.zeros((n, recipe.point_capacity, 3), np.float32)
    rgb = np.zeros_like(pts)
    mask = np.zeros((n, recipe.point_capacity), bool)
    for i in range(n):
        f = source.get()
        k = min(len(f.points), recipe.point_capacity)
        pts[i, :k], rgb[i, :k], mask[i, :k] = f.points[:k], f.rgb[:k], True
    return pts, rgb, mask


def _seg_labels(engine, pts, rgb, mask):
    """The engine's point labels of a batch (its segmentation stage)."""
    out = engine.seg_stage(*(torch.as_tensor(x, device=engine.device)
                             for x in (pts, rgb, mask)))
    return out[0].cpu()


def _label_agreement(a, b, mask):
    m = torch.as_tensor(mask)
    return float((a[m] == b[m]).float().mean())


def _history_report(res):
    """Per net: epochs, steps, training seconds, first and last epoch's
    metrics and the share of ``data_time`` in ``iter_time`` (the host's
    item pipeline: items are built in epoch 1 and cached)."""
    out = {}
    for stage, hist in res["history"].items():
        if not hist:
            out[stage] = None
            continue
        steps = sum(h["batches"] for h in hist)
        data = sum(h["data_time"] * h["batches"] for h in hist)
        it = sum(h["iter_time"] * h["batches"] for h in hist)
        out[stage] = dict(
            epochs=len(hist), steps=steps, train_s=res["train_s"][stage],
            steps_per_s=steps / res["train_s"][stage],
            data_share=data / it, data_share_epoch1=(
                hist[0]["data_time"] / hist[0]["iter_time"]),
            first={k: v for k, v in hist[0].items()
                   if k not in ("iter_time", "data_time")},
            last={k: v for k, v in hist[-1].items()
                  if k not in ("iter_time", "data_time")})
    return out


def _cpu_engine(engine):
    """An engine of the same configuration and weights on the CPU."""
    from mrcc_tpu_torch.app import InferenceEngine

    return InferenceEngine(
        copy.deepcopy(engine.cfg), device="cpu",
        params={stage: {k: v.cpu() for k, v in m.state_dict().items()}
                for stage, m in engine.models().items()})


def phase_demo(counters):
    """Phase 18: ``demo_checkpoints.main`` at DEMO_SHORT on the card, the
    gates of the module docstring; returns the launches of path ``dm``."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        res, launches, plain, seconds = _demo_main(DEMO_SHORT, root,
                                                   counters)
        hist = _history_report(res)
        seg = res["history"]["segmentation"][-1]
        pose_losses = [h["loss"] for st in ("rotation", "key_points")
                       for h in res["history"][st]]
        kp = res["history"]["key_points"]
        log("demo_train", card=smi_line(), seconds=seconds, nets=hist,
            k3_tables=res["k3_tables"], launches=launches, plain=plain)
        log("demo_bench", card=smi_line(),
            frames=res["table"]["seg_accuracy"]["N"],
            table={k: v["Avg"] for k, v in res["table"].items()},
            calibration=res["calibration"])
        ckpts = {st: sorted(f for f in os.listdir(os.path.join(root, st))
                            if f.endswith(".ckpt"))
                 for st in res["history"]}
        # the checkpoints alone give the same engine
        t = time.perf_counter()
        again, _, again_plain, _ = _demo_main(DEMO_SHORT + ["--bench-only"],
                                              root)
        restore_s = time.perf_counter() - t
    pts, rgb, mask = _demo_frames(DEMO_CPU_FRAMES)
    p, c, m = (torch.as_tensor(x, device="cuda") for x in (pts, rgb, mask))
    differ = _equal_outputs(again["engine"].predict_batch_arrays(p, c, m),
                            res["engine"].predict_batch_arrays(p, c, m))
    t = time.perf_counter()
    card = _seg_labels(res["engine"], pts, rgb, mask)
    cpu = _seg_labels(_cpu_engine(res["engine"]), pts, rgb, mask)
    agree = _label_agreement(card, cpu, mask)
    report = dict(
        seg_epoch6={"loss": seg["loss"], "accuracy": seg["accuracy"]},
        pose_losses_finite=bool(np.isfinite(pose_losses).all()),
        kp_loss_first_last=(kp[0]["loss"], kp[-1]["loss"]),
        checkpoints=ckpts, restored_outputs_equal=not differ,
        restored_table_equal=again["table"] == res["table"],
        restore_s=restore_s, seg_labels_card_vs_cpu=agree,
        cpu_check_s=time.perf_counter() - t, frames=DEMO_CPU_FRAMES,
        tolerance={"seg_loss": DEMO_SEG_LOSS, "seg_accuracy": DEMO_SEG_ACC,
                   "card_vs_cpu": DEMO_CPU_AGREE}, card=smi_line())
    log("demo", **report)
    rows = ("argsort", "conv_sk", "conv_down", "conv_up", "dw_sk", "dw_down",
            "dw_up")
    if (seg["loss"] > DEMO_SEG_LOSS or seg["accuracy"] < DEMO_SEG_ACC
            or not report["pose_losses_finite"]
            or kp[-1]["loss"] >= kp[0]["loss"]
            or not all(ckpts.values()) or differ
            or not report["restored_table_equal"] or agree < DEMO_CPU_AGREE
            or plain or again_plain
            or min(launches.get(r, 0) for r in rows) <= 0):
        raise AssertionError(f"phase 18 demo: {report}, launches "
                             f"{launches}, plain twins {plain} / "
                             f"{again_plain}")
    return {"dm": launches}


DEMO_FULL_CPU_FRAMES = 4  # (--demo) card-vs-CPU seg labels
DEMO_Q8_CHUNK = 4         # (--demo) frames a batch of the int8 label check


@contextlib.contextmanager
def _q8_clipping(engine):
    """Per int8 conv of the engine (``"{stage}.{conv}"``): the input
    elements seen and those past the calibrated per-channel absmax, which
    the quantisation clips (ROADMAP C33)."""
    from mrcc_tpu_torch.sparse.nn import q8_convs

    stats, hooks = {}, []
    for stage, model in engine.models().items():
        for name, conv in q8_convs(model):
            if not conv.q8 or conv.act_absmax is None:
                continue

            def count(mod, args, _key=f"{stage}.{name}"):
                x = args[0].float()
                s = stats.setdefault(_key, [0, 0])
                s[0] += int((x != 0).sum())
                s[1] += int((x.abs() > mod.act_absmax).sum())

            hooks.append(conv.register_forward_pre_hook(count))
    try:
        yield stats
    finally:
        for h in hooks:
            h.remove()


def demo_cpu_reference(root):
    """(--demo) the CPU side, in a child process: the trained engine of
    ``{root}/cpu_in.pt`` on the CPU, its seg labels on the saved frames and
    ``BenchmarkApp``'s table over the same held-out frames as the card's."""
    from mrcc_tpu_torch.app import InferenceEngine
    from mrcc_tpu_torch.cli.demo_checkpoints import bench_source, stats_table
    from mrcc_tpu_torch.data.synthetic import gt_base2cam_pose
    from mrcc_tpu_torch.eval.benchmark import BenchmarkApp

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    spec = torch.load(f"{root}/cpu_in.pt", weights_only=False)
    engine = InferenceEngine(spec["cfg"], device="cpu",
                             params=spec["params"])
    t = time.perf_counter()
    labels = _seg_labels(engine, *spec["frames"])
    labels_s = time.perf_counter() - t
    t = time.perf_counter()
    res = BenchmarkApp(engine, bench_source(spec["recipe"]),
                       gt_base2cam_pose(),
                       n_samples=spec["bench_samples"],
                       ignore_unconfident=False).run()
    torch.save({"labels": labels, "labels_s": labels_s,
                "table": stats_table(res["metrics"]),
                "calibration": res["calibration"],
                "bench_s": time.perf_counter() - t,
                "threads": torch.get_num_threads()}, f"{root}/cpu_out.pt")


def _demo_cpu_child(root, engine, frames, bench_samples):
    """Start :func:`demo_cpu_reference` on the last EVAL_CPU_CORES cores
    (this process keeps the others) with the engine's configuration,
    weights and ``frames``."""
    from mrcc_tpu_torch.cli.demo_checkpoints import Recipe

    torch.save({"cfg": engine.cfg, "frames": frames, "recipe": Recipe(),
                "bench_samples": bench_samples,
                "params": {st: {k: v.cpu() for k, v in m.state_dict().items()}
                           for st, m in engine.models().items()}},
               f"{root}/cpu_in.pt")
    cores = sorted(os.sched_getaffinity(0))
    child = None
    if len(cores) >= 2 * EVAL_CPU_CORES:
        child, keep = cores[-EVAL_CPU_CORES:], cores[:-EVAL_CPU_CORES]
        os.sched_setaffinity(0, keep)
        torch.set_num_threads(len(keep))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--demo-cpu", root],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=(None if child is None else
                    lambda: os.sched_setaffinity(0, child)))


def phase_demo_full(record=None):
    """``--demo [RECORD]``: the r2 recipe (DEMO_FULL) on the card, then the int8
    engine on the same checkpoints (``--bench-only --conv-impl
    pallas-int8``: ROADMAP C32 on trained nets, with C33's clipping), the
    seg labels int8 against bf16 on the 20 held-out frames, and the
    trained engine card against CPU (a child process: seg labels on
    DEMO_FULL_CPU_FRAMES frames, the CPU's own table over the 20); the
    whole record is written to the JSON file ``record`` where given."""
    import tempfile

    from mrcc_tpu_torch.ops import conv_q8

    counters = demo_counters()
    q8_counters = counters + [conv_q8.SK_Q8, conv_q8.DOWN_Q8, conv_q8.UP_Q8,
                              conv_q8.Q8_QUANT, conv_q8.Q8_LISTS,
                              conv_q8.Q8_SUM]
    report = {"card": smi_line(), "flags": DEMO_FULL}
    with tempfile.TemporaryDirectory() as root:
        res, launches, plain, seconds = _demo_main(DEMO_FULL, root,
                                                   counters)
        report.update(seconds=seconds, nets=_history_report(res),
                      k3_tables=res["k3_tables"], launches=launches,
                      plain=plain, bf16_table=res["table"],
                      bf16_calibration=res["calibration"])
        log("demo_full_train", card=smi_line(), seconds=seconds,
            nets=report["nets"], launches=launches, plain=plain)
        log("demo_full_bf16", card=smi_line(),
            table={k: v["Avg"] for k, v in res["table"].items()},
            calibration=res["calibration"])
        small = _demo_frames(DEMO_FULL_CPU_FRAMES)
        child = _demo_cpu_child(root, res["engine"], small, 20)
        try:
            q8, q8_launches, q8_plain, q8_s = _demo_main(
                DEMO_FULL + ["--bench-only", "--conv-impl", "pallas-int8"],
                root, q8_counters)
            report.update(int8_table=q8["table"],
                          int8_calibration=q8["calibration"],
                          int8_launches=q8_launches, int8_plain=q8_plain,
                          int8_bench_s=q8_s)
            log("demo_full_int8", card=smi_line(),
                table={k: v["Avg"] for k, v in q8["table"].items()},
                calibration=q8["calibration"])
            pts, rgb, mask = _demo_frames(20)
            agree = []
            with _q8_clipping(q8["engine"]) as clip:
                for s in range(0, 20, DEMO_Q8_CHUNK):
                    rows = slice(s, s + DEMO_Q8_CHUNK)
                    agree.append(_label_agreement(
                        _seg_labels(q8["engine"], pts[rows], rgb[rows],
                                    mask[rows]),
                        _seg_labels(res["engine"], pts[rows], rgb[rows],
                                    mask[rows]), mask[rows]))
            shares = {k: over / max(seen, 1) for k, (seen, over)
                      in clip.items()}
            report.update(
                int8_vs_bf16_seg_labels=float(np.mean(agree)),
                int8_vs_bf16_seg_labels_min=min(agree),
                c33_clipped_share_max=max(shares.values()),
                c33_convs_clipping=sum(v > 0 for v in shares.values()),
                c33_convs=len(shares),
                c33_clipped_share_by_conv=shares)
            card = _seg_labels(res["engine"], *small)
            out, _ = child.communicate(timeout=1800)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        if child.returncode != 0:
            raise AssertionError(f"--demo CPU reference failed:\n"
                                 f"{out[-4000:]}")
        cpu = torch.load(f"{root}/cpu_out.pt", weights_only=False)
    report.update(
        seg_labels_card_vs_cpu=_label_agreement(card, cpu["labels"],
                                                small[2]),
        cpu_table=cpu["table"], cpu_calibration=cpu["calibration"],
        cpu_bench_s=cpu["bench_s"], cpu_threads=cpu["threads"])
    log("demo_full", **{
        k: v for k, v in report.items()
        if not k.endswith("_table") and k not in (
            "nets", "c33_clipped_share_by_conv")},
        cpu_table={k: v["Avg"] for k, v in cpu["table"].items()})
    if record:
        os.makedirs(os.path.dirname(record) or ".", exist_ok=True)
        with open(record, "w") as f:
            json.dump(report, f, indent=1, default=str)
    seg = res["history"]["segmentation"][-1]
    if (plain or q8_plain or not np.isfinite(seg["loss"])
            or report["seg_labels_card_vs_cpu"] < DEMO_CPU_AGREE):
        raise AssertionError(f"--demo: {report}")
    return report


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--eval-references":
        eval_references(sys.argv[2])   # the CPU process of phase 16
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--demo-cpu":
        demo_cpu_reference(sys.argv[2])  # the CPU process of --demo
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)

    from mrcc_tpu_torch.ops import conv, conv_q8, nn, rank, sort

    if len(sys.argv) == 6 and sys.argv[1] == "--dp-rank":
        dp_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])  # phase 17 b
        return 0
    modes = {"--pose-k2": phase_pose_k2,
             "--rank-nn": phase_rank_nn,
             "--icp": phase_icp,
             "--dw": lambda: phase_step_breakdown(DW_WRAPPERS, "dw"),
             "--k3": lambda: phase_step_breakdown(K3_WRAPPERS, "k3"),
             "--q8": phase_q8_only,
             "--train-more": lambda: phase_train_more(
                 [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
                  conv.K3_SUM, conv.DW_SK, conv.DW_DOWN, conv.DW_UP,
                  conv.DW_LISTS, rank.RANK, conv.K3MAP, conv.DW_K3MAP]),
             "--int8": phase_int8_paths,
             "--resnet": lambda: phase_resnet_only(
                 resnet_counters(), bottleneck_counters()),
             "--inference": lambda: phase_main_path(
                 *bench_levels(torch.device("cuda"))[:2],
                 [sort.SORT, conv.SK, conv.DOWN, conv.UP]),
             "--calibrate": lambda: phase_calibrate(
                 bench_levels(torch.device("cuda"))[0],
                 [sort.SORT, conv.SK, conv.DOWN, conv.UP]),
             "--eval": lambda: _with_references(phase_eval),
             "--parallel": lambda: phase_parallel(
                 *bench_levels(torch.device("cuda"))[:2],
                 [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
                  conv.K3_SUM]),
             "--demo-short": lambda: phase_demo(demo_counters()),
             "--dense": lambda: phase_dense_only(
                 [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
                  conv.K3_SUM],
                 [conv_q8.SK_Q8, conv_q8.DOWN_Q8, conv_q8.UP_Q8,
                  conv_q8.Q8_QUANT, conv_q8.Q8_LISTS, conv_q8.Q8_SUM])}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        phase_build()
        modes[sys.argv[1]]()
        return 0
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--demo":
        phase_build()
        phase_demo_full(sys.argv[2] if len(sys.argv) == 3 else None)
        return 0

    references = None

    def phase(name, fn, *args):
        # whether phase 16's CPU child ran at the phase's start and end:
        # host-bound times beside it do not compare with times without
        child = [references is not None and references.running()]
        t0 = time.perf_counter()
        out = fn(*args)
        child.append(references is not None and references.running())
        log("wall", of=name, seconds=time.perf_counter() - t0,
            beside_child=child)
        return out

    phase("build", phase_build)
    references = EvalReferences()   # phase 16's CPU side, from now on
    try:
        return _main_phases(phase, card, references)
    finally:
        references.close()


def _with_references(fn):
    references = EvalReferences()
    try:
        return fn(references)
    finally:
        references.close()


def _main_phases(phase, card, references):
    from mrcc_tpu_torch.ops import conv, conv_q8, nn, rank, sort

    dev = torch.device("cuda")
    inputs, caps, levels = bench_levels(dev)
    pinputs, pcaps, plevels = bench_levels(dev, batch=2, points=PROD_POINTS,
                                           tables=True)
    tlevels = train_levels(train_batch(), dev)
    slevels = train_levels(scene_batch(), dev, capacity=SCENE_CAPACITY)
    records = phase("kernels", phase_kernels, levels, tlevels, plevels,
                    slevels, dev)
    phase("backward", phase_backward, tlevels, dev)
    del tlevels, plevels, slevels
    frame = phase("frame", phase_frame, [sort.SORT, conv.SK, rank.RANK])
    phase("card_vs_cpu", phase_card_vs_cpu)
    phase("int8_card_vs_cpu", phase_int8_card_vs_cpu)
    phase("int8_tables_card_vs_cpu", phase_int8_card_vs_cpu, False)
    phase("bf16_tables_vs_self_keyed", phase_bf16_routes_on_card)
    phase("train_card_vs_cpu", phase_train_card_vs_cpu)
    phase("train_tables_card_vs_cpu", phase_train_card_vs_cpu, False)
    phase("pose_card_vs_cpu", phase_pose_card_vs_cpu)
    counters = [sort.SORT, conv.SK, conv.DOWN, conv.UP, conv.K3_LISTS,
                conv.K3_SUM]
    launches, bf16_seg = phase("main_path", phase_main_path, inputs, caps,
                               counters)
    launches = {"inference": launches, "frame": frame}
    torch.cuda.empty_cache()
    launches["predict"] = phase("calibrate", phase_calibrate, inputs,
                                counters)
    torch.cuda.empty_cache()
    train_counters = counters + [conv.DW_SK, conv.DW_DOWN, conv.DW_UP,
                                 conv.DW_LISTS]
    launches["training"] = phase("train", phase_train, train_counters)
    torch.cuda.empty_cache()
    q8_counters = [conv_q8.SK_Q8, conv_q8.DOWN_Q8, conv_q8.UP_Q8,
                   conv_q8.Q8_QUANT, conv_q8.Q8_LISTS, conv_q8.Q8_SUM]
    launches["int8"] = phase(
        "int8_main_path", phase_int8_main_path, inputs, caps,
        counters + q8_counters, bf16_seg)
    torch.cuda.empty_cache()
    launches.update(phase(
        "production", phase_production, pinputs, pcaps, counters
        + q8_counters + [rank.RANK, conv.K3MAP, conv_q8.K3MAP_Q8, nn.NN],
        ("production", "production_int8")))
    torch.cuda.empty_cache()
    table_counters = train_counters + [rank.RANK, conv.K3MAP, conv.DW_K3MAP]
    launches["training_tables"] = phase("train_tables", phase_train_tables,
                                        table_counters)
    torch.cuda.empty_cache()
    launches["training_scene"] = phase("train_scene", phase_train_scene,
                                       table_counters)
    torch.cuda.empty_cache()
    launches.update(phase("pose_train", phase_pose_train, table_counters))
    torch.cuda.empty_cache()
    launches.update(phase("train_more", phase_train_more, table_counters))
    torch.cuda.empty_cache()
    records += phase("resnet_kernels", resnet_kernel_cases, dev)
    phase("resnet_card_vs_cpu", phase_resnet_card_vs_cpu)
    launches.update(phase("resnet", phase_resnet, resnet_counters()))
    torch.cuda.empty_cache()
    launches.update(phase("bottleneck", phase_bottleneck,
                          bottleneck_counters()))
    torch.cuda.empty_cache()
    phase("dense_card_vs_cpu", phase_dense_card_vs_cpu)
    launches.update(phase("dense", phase_dense, counters, q8_counters))
    launches.update(phase("dense_train", phase_dense_train))
    torch.cuda.empty_cache()
    eval_launches, eval_records = phase("eval", phase_eval, references)
    launches.update(eval_launches)
    records += eval_records
    torch.cuda.empty_cache()
    launches.update(phase("parallel", phase_parallel, inputs, caps,
                          counters))
    torch.cuda.empty_cache()
    launches.update(phase("demo", phase_demo, demo_counters()))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    for r in records:
        r["launches_by_path"] = {path: n.get(r["kernel"])
                                 for path, n in launches.items()}
        r["launches"] = launches[r["path"]][r["kernel"]]
        if not r["launches"]:
            raise AssertionError(f"{r['kernel']} never ran on its path "
                                 f"{r['path']}: {r['launches_by_path']}")
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
