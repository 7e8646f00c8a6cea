"""On-card smoke test of the PyTorch + CUDA port (``mrcc_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Two main paths run: inference (``InferenceEngine.predict_batch_arrays``)
and segmentation training (``make_segmentation_train_step``).  Phases,
each printing one line (any failure exits non-zero before the last line):

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: compile the kernels of ``mrcc_tpu_torch/csrc`` (one nvcc per
   source, all started together), with ptxas register / smem lines;
3. kernels vs their plain PyTorch twins at the main paths' shapes (exact
   for the sort; relative norm 2e-2 for bf16 against the f32 twin, 1e-5 for
   f32), timed with CUDA events: the forward kernels at the inference
   shapes in bf16, the dW kernels at the training shapes in f32; then the
   backward of each autograd conv Function on the card against autograd
   through the plain twins on the card (f32, 1e-5);
4. the inference slice on the card vs on the CPU: one engine pair with the
   same weights, f32, small size (integer outputs exact, poses 1e-3);
5. one train step on the card vs on the CPU: minkunet14A, B=2, f32, same
   weights and batch (loss 1e-5, gradients 1e-4 and the update 1e-3 in
   relative norm, BN statistics 1e-5);
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
   sanity checks (finite losses; the loss on the fixed batch falls).

f32 phases run with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).  The last lines are the card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and op/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
TOL_BF16, TOL_F32 = 2e-2, 1e-5
TRAIN_CAPACITY = 16384  # voxel capacity of the full-width train step

# each kernel's source, and the TPU kernel (file:line) each record replaces
SOURCES = {
    "argsort": "mrcc_tpu_torch/csrc/sort.cu",
    "conv_sk": "mrcc_tpu_torch/csrc/conv_sk.cu",
    "conv_down": "mrcc_tpu_torch/csrc/conv_map.cu",
    "conv_up": "mrcc_tpu_torch/csrc/conv_map.cu",
    "dw_sk": "mrcc_tpu_torch/csrc/conv_dw_sk.cu",
    "dw_down": "mrcc_tpu_torch/csrc/conv_dw_map.cu",
    "dw_up": "mrcc_tpu_torch/csrc/conv_dw_map.cu",
}
K2_TPU = "mrcc_tpu/ops/conv_pallas.py:767"    # _gather_gemm_call_sk
K3_TPU = "mrcc_tpu/ops/conv_pallas.py:120"    # _gather_gemm_call
HBM_TPU = "mrcc_tpu/ops/conv_pallas.py:1495"  # _gather_gemm_call_hbm
DW_TPU = {"dw_sk": "mrcc_tpu/ops/conv_pallas.py:1076",   # _dw_call_sk
          "dw_down": "mrcc_tpu/ops/conv_pallas.py:1691",  # _dw_call
          "dw_up": "mrcc_tpu/ops/conv_pallas.py:1691"}


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


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- phases

def phase_build():
    from mrcc_tpu_torch.ops import conv, sort
    from mrcc_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    infos = build_all([sort.LIB, *conv.LIBRARIES])
    log("build", seconds=round(time.perf_counter() - t0, 3),
        sources={i.name: {"seconds": round(i.seconds, 3),
                          "ptxas": i.resource_lines()} for i in infos})


def bench_levels(device, batch=8, points=16384, seed=0):
    """Inputs and the seg hierarchy of the main path (bench capacities)."""
    from mrcc_tpu_torch.app import measure_seg_caps
    from mrcc_tpu_torch.data.synthetic import build_batch
    from mrcc_tpu_torch.geometry import center_at_origin
    from mrcc_tpu_torch.sparse import build_hierarchy, voxelize

    pts, rgb, mask = build_batch(batch, points, seed=seed)
    caps = measure_seg_caps(pts, rgb, mask, device=device)
    p = torch.as_tensor(pts, device=device)
    m = torch.as_tensor(mask, device=device)
    c, _ = center_at_origin(p, mask=m)
    vox, _ = voxelize(c, torch.as_tensor(rgb, device=device), m, 1 / 200.0,
                      caps[0])
    levels = build_hierarchy(vox, 4, capacities=caps[1:])
    return (pts, rgb, mask), caps, levels


def train_batch(batch=8, seed=0):
    """The full-width training batch: ``batch`` synthetic scenes of 24096
    points, centred, padded to 65536 rows (``DataConfig`` defaults)."""
    from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset

    data = SceneDataset(DataConfig(), batch, seed=seed)
    return data.collate(data.items)


def train_levels(batch, device):
    """The hierarchy the train step builds for ``batch`` (0.01 m voxels,
    capacities (16384, 16384, 8192, 4096, 2048))."""
    from mrcc_tpu_torch.sparse import build_hierarchy, hierarchy_caps, voxelize

    vox, _ = voxelize(*(torch.as_tensor(batch[k], device=device)
                        for k in ("points", "feats", "mask")), 0.01,
                      TRAIN_CAPACITY)
    return build_hierarchy(vox, 4, capacities=hierarchy_caps(TRAIN_CAPACITY))


def phase_kernels(levels, tlevels, device):
    """Each kernel vs its plain twin at the main paths' shapes: ``levels``
    of the inference path, ``tlevels`` of the training path."""
    from mrcc_tpu_torch.ops import conv, sort

    gen = torch.Generator(device="cpu").manual_seed(7)
    records = []

    def feats(level, c):
        x = torch.randn(level.key.shape + (c,), generator=gen).to(device)
        return torch.where(level.valid[..., None], x, 0.0)

    def weights(k, cin, cout):
        return (torch.randn((k, cin, cout), generator=gen)
                / np.sqrt(k * cin)).to(device)

    # K1: duplicate-heavy [8, 16384] (many points per voxel) and [8, 12544]
    # on the inference path; the train step's [8, 65536] point keys (global
    # merge passes beyond one block's 2^14 rows)
    for b, n, hi, path in ((8, 16384, 3000, "inference"),
                           (8, 12544, 1 << 30, "inference"),
                           (8, 65536, 16000, "training")):
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
        records.append(dict(
            name=f"argsort[{b}x{n}]", kernel="argsort", path=path,
            route="cuda", source=SOURCES["argsort"],
            replaces="mrcc_tpu/ops/sort_pallas.py:107", max_abs_err=0.0,
            tolerance="exact", ms=ms,
            plain_ms=cuda_ms(lambda: sort.argsort_plain(key)),
            library_ms=cuda_ms(lambda: torch.argsort(key, dim=-1,
                                                     stable=True)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b * n * 12, b * _ce_count(n), "f32")))))

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
        kind, args, got = (("f32", args32, got32) if path == "training"
                           else ("bf16", args16, got16))
        cin, cout = args32[1].shape[1:]
        # the rows the hits gather, the weights, the whole output (padding
        # rows are written as zeros) and the map entries of valid rows
        nbytes = ((4 if kind == "f32" else 2)
                  * (work["read"] * cin + k * cin * cout + want.numel())
                  + work["map_bytes"])
        bms, by = bound_ms(nbytes, 2 * work["hits"] * cin * cout, kind)
        records.append(dict(
            name=name, kernel=kernel, path=path, route="cuda",
            source=SOURCES[kernel], replaces=replaces,
            max_abs_err=float((got.float() - want).abs().max()),
            rel_err=errs, tolerance={"f32": TOL_F32, "bf16": TOL_BF16},
            dtype=kind, work=work, ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: plain(*args)), library_ms=None,
            bound_ms=bms, bound_by=by))

    for li, cin, cout in ((0, 3, 32), (0, 128, 96), (3, 384, 256)):
        lv = levels[li]
        b, n = lv.key.shape
        conv_case(f"conv_sk[{b}x{n} {cin}->{cout}]", "conv_sk", K2_TPU,
                  conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
                  [feats(lv, cin), weights(27, cin, cout), lv.key, lv.kbits],
                  _sk_work(lv), 27)
    lv = tlevels[0]  # the training step's widest k3 conv (decoder, level 0)
    b, n = lv.key.shape
    conv_case(f"conv_sk[{b}x{n} 384->384 f32]", "conv_sk", K2_TPU,
              conv.gather_gemm_sk, conv.gather_gemm_sk_plain,
              [feats(lv, 384), weights(27, 384, 384), lv.key, lv.kbits],
              _sk_work(lv), 27, path="training")
    # K3 down at the inference path's first down conv; at the training
    # step's level 0 -> 1, where the JAX step streams the over-budget f32
    # table (_gather_gemm_call_hbm): the stem's down conv (32 -> 32) and the
    # data cotangent of the up conv 1 -> 0 (384 -> 384)
    for lvs, cin, cout, path, replaces in (
            (levels, 32, 32, "inference", K3_TPU),
            (tlevels, 32, 32, "training", HBM_TPU),
            (tlevels, 384, 384, "training", HBM_TPU)):
        fine, coarse = lvs[0], lvs[1]
        b, nf = fine.key.shape
        nc = coarse.key.shape[1]
        conv_case(f"conv_down[{b}x{nf}->{nc} {cin}->{cout}"
                  + (" f32]" if path == "training" else "]"), "conv_down",
                  replaces, conv.gather_gemm_down,
                  conv.gather_gemm_down_plain,
                  [feats(fine, cin), weights(8, cin, cout), coarse.child_idx,
                   coarse.child_hit], _down_work(coarse), 8, path=path)
    fine, coarse = levels[3], levels[4]
    b, nf = fine.key.shape
    nc = coarse.key.shape[1]
    conv_case(f"conv_up[{b}x{nc}->{nf} 256->256]", "conv_up", K3_TPU,
              conv.gather_gemm_up, conv.gather_gemm_up_plain,
              [feats(coarse, 256), weights(8, 256, 256), fine.parent_idx,
               fine.row_ok, fine.octant], _up_work(fine), 8)

    def dw_case(name, kernel, fn, plain, f, g, maps, work):
        want = plain(f, g, *maps)
        got32 = fn(f, g, *maps)
        got16 = fn(f.bfloat16(), g.bfloat16(), *maps)
        errs = {"f32": rel_err(got32, want), "bf16": rel_err(got16, want)}
        if errs["f32"] > TOL_F32 or errs["bf16"] > TOL_BF16:
            raise AssertionError(f"{name}: relative error {errs} over "
                                 f"(f32 {TOL_F32}, bf16 {TOL_BF16})")
        k, cin, cout = want.shape
        # the feature rows the hits gather, the g rows of outputs with a
        # hit, dW once, and the map entries of valid rows
        nbytes = (4 * (work["read"] * cin + work["written"] * cout
                       + want.numel()) + work["map_bytes"])
        bms, by = bound_ms(nbytes, 2 * work["hits"] * cin * cout, "f32")
        records.append(dict(
            name=name, kernel=kernel, path="training", route="cuda",
            source=SOURCES[kernel], replaces=DW_TPU[kernel],
            max_abs_err=float((got32 - want).abs().max()), rel_err=errs,
            tolerance={"f32": TOL_F32, "bf16": TOL_BF16}, dtype="f32",
            work=work, ms=cuda_ms(lambda: fn(f, g, *maps)),
            plain_ms=cuda_ms(lambda: plain(f, g, *maps)), library_ms=None,
            bound_ms=bms, bound_by=by))

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
    log("kernels", cases=[{k: r.get(k) for k in (
        "name", "path", "replaces", "ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "work", "max_abs_err", "rel_err",
        "tolerance")}
        for r in records])
    return records


def phase_backward(tlevels, device):
    """Backward of each autograd conv Function at a training level (kernels)
    against autograd through the plain forward twins, both on the card."""
    from mrcc_tpu_torch.ops import conv
    from mrcc_tpu_torch.sparse import conv as C

    gen = torch.Generator(device="cpu").manual_seed(9)

    def feats(level, c):
        x = torch.randn(level.key.shape + (c,), generator=gen).to(device)
        return torch.where(level.valid[..., None], x, 0.0)

    l0, l1, l2, l3, l4 = tlevels
    cases = {
        "k3[level 2 128x128]": (
            27, 128, 128, l2, l2, lambda f, w: C.conv_k3(f, w, l2),
            lambda f, w: conv.gather_gemm_sk_plain(f, w, l2.key, l2.kbits)),
        "down[level 0->1 32x32]": (
            8, 32, 32, l0, l1, lambda f, w: C.conv_down(f, w, l0, l1),
            lambda f, w: conv.gather_gemm_down_plain(f, w, l1.child_idx,
                                                     l1.child_hit)),
        "up[level 4->3 256x384]": (
            8, 256, 384, l4, l3,
            lambda f, w: C.conv_transpose_up(f, w, l4, l3),
            lambda f, w: conv.gather_gemm_up_plain(
                f, w, l3.parent_idx, l3.row_ok, l3.octant)),
    }
    errs = {}
    for name, (taps, cin, cout, src, dst, fn, plain) in cases.items():
        f0 = feats(src, cin)
        w0 = (torch.randn((taps, cin, cout), generator=gen) / 8).to(device)
        ct = feats(dst, cout)
        grads = []
        for run in (fn, plain):
            f = f0.clone().requires_grad_()
            w = w0.clone().requires_grad_()
            (run(f, w) * ct).sum().backward()
            grads.append((f.grad, w.grad))
        errs[name] = {"dfeats": rel_err(grads[0][0], grads[1][0]),
                      "dW": rel_err(grads[0][1], grads[1][1])}
        if max(errs[name].values()) > TOL_F32:
            raise AssertionError(f"backward {name}: {errs[name]} over "
                                 f"{TOL_F32}")
    log("backward", tolerance=TOL_F32, rel_err=errs)


def _ce_count(n):
    """Compare-exchanges of one bitonic row padded to a power of two, two
    operations each (compare, select)."""
    n2, lg = 2, 1
    while n2 < n:
        n2, lg = n2 * 2, lg + 1
    return n2 * lg * (lg + 1) // 4 * 2


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


def phase_card_vs_cpu():
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
        icp_template_points=512, seg_backbone="minkunet18",
        rot_backbone="minkunet18", kp_backbone="minkunet18",
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
    log("card_vs_cpu", ee_count=want["ee_count"].tolist(), max_err=report)


def phase_main_path(inputs, caps, counters, iters=12):
    """The bench configuration at full width; returns per-kernel launches."""
    from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine

    pts, rgb, mask = inputs
    cfg = InferenceConfig(
        point_capacity=pts.shape[1], seg_voxel_capacity=caps[0],
        seg_hierarchy_caps=caps[1:], ee_point_capacity=2048,
        ee_voxel_capacity=2048, kp_voxel_capacity=1024,
        ee_hierarchy_caps=(1024, 384, 128, 128),
        kp_hierarchy_caps=(768, 640, 384, 128), icp_iterations=15,
        icp_template_points=1024, seg_backbone="minkunet18",
        rot_backbone="minkunet", kp_backbone="minkunet18",
        compute_dtype="bfloat16")
    engine = InferenceEngine(cfg, seed=0)
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

    device_ms = profile_device_ms(lambda: engine.predict_batch_arrays(p, c,
                                                                      m))
    busy = sum(device_ms.values())
    batch_ms = 1e3 * med
    top = dict(sorted(device_ms.items(), key=lambda kv: -kv[1])[:12])
    ported = {k: sum(v for n, v in device_ms.items() if k in n)
              for k in ("sort_chunk", "sort_global_stage", "conv_sk_kernel",
                        "conv_down_kernel", "conv_up_kernel")}

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
    log("main_path", batch=int(pts.shape[0]), points=int(pts.shape[1]),
        seg_caps=list(caps), batches=iters,
        clouds_per_s_median=pts.shape[0] / med,
        clouds_per_s_q1_q3=[pts.shape[0] / q3, pts.shape[0] / q1],
        card=smi_line(), batch_ms_median=batch_ms,
        batch_ms_all=[1e3 * s for s in batch_s],
        stage_ms={k: 1e3 * v for k, v in stages.items()},
        device_busy_ms=busy, device_idle_share=1 - busy / batch_ms,
        ported_kernel_device_ms=ported, top_device_ms=top, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **checks)
    return launches


def profile_device_ms(fn):
    """Device time (ms) by kernel over one profiled call of ``fn``:
    device-side events only (an operator's own row repeats its kernels'
    time)."""
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
    return out


def _train_pair_errors(cpu, gpu, before):
    """Gradient, update and BN-statistic errors of a card model against a
    CPU model after one step from the same weights ``before``.  The update
    is compared where the CPU gradient is 0 or above 1 % of its tensor's
    rms: Adam's first step is lr * g / (|g| + eps), noise where |g| is."""
    gd = gn = ud = un = 0.0
    worst = {"grad": 0.0, "update": 0.0, "bn": 0.0}
    gparams = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        q = gparams[name]
        g, gq = p.grad, q.grad.cpu()
        gd += float((gq - g).norm() ** 2)
        gn += float(g.norm() ** 2)
        worst["grad"] = max(worst["grad"], rel_err(gq, g))
        keep = (g == 0) | (g.abs() > 1e-2 * g.pow(2).mean().sqrt())
        u = (p.detach() - before[name])[keep]
        uq = (q.detach().cpu() - before[name])[keep]
        ud += float((uq - u).norm() ** 2)
        un += float(u.norm() ** 2)
        worst["update"] = max(worst["update"], rel_err(uq, u))
    gbufs = dict(gpu.named_buffers())
    for name, buf in cpu.named_buffers():
        worst["bn"] = max(worst["bn"], rel_err(gbufs[name].cpu(), buf))
    return {"grad": (gd / gn) ** 0.5, "update": (ud / un) ** 0.5,
            "bn": worst["bn"], "worst_tensor": worst}


def phase_train_card_vs_cpu():
    """One train step from the same weights and batch on the card and on
    the CPU: minkunet14A, B=2, f32, capacity 4096."""
    from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step

    cfg = DataConfig(max_points=4096)
    data = SceneDataset(cfg, 2, seed=21, n_ee=512, n_arm=1024, n_bg=2048)
    batch = data.collate(data.items)
    cpu = init_parameters(RobotNetSegmentation(backbone="minkunet14A"), 5)
    gpu = copy.deepcopy(cpu)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        step, _ = make_segmentation_train_step(model, cfg, TrainConfig(), 4096,
                                               device=dev)
        out[dev] = {k: float(v) for k, v in step(batch, 1e-4).items()}
    loss_err = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(
        out["cpu"]["loss"])
    errs = _train_pair_errors(cpu, gpu, before)
    report = dict(loss=out, loss_rel_err=loss_err, **errs,
                  tolerance={"loss": 1e-5, "grad": 1e-4, "update": 1e-3,
                             "bn": 1e-5})
    if (loss_err > 1e-5 or errs["grad"] > 1e-4 or errs["update"] > 1e-3
            or errs["bn"] > 1e-5):
        raise AssertionError(f"train step, card vs CPU: {report}")
    log("train_card_vs_cpu", **report)


def phase_train(counters, warmup=2, timed=6, lr=1e-4):
    """Segmentation training at full width on one fixed batch; returns the
    launches of one step (the first timed one) of every kernel."""
    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.sparse.nn import init_parameters
    from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step

    batch = train_batch()
    model = init_parameters(RobotNetSegmentation(backbone="minkunet"), 1)
    step, _ = make_segmentation_train_step(model, DataConfig(),
                                           TrainConfig(batch_size=8),
                                           TRAIN_CAPACITY)
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
    step_s = [run()]  # the counted run: one train step
    launches = {ctr.name: ctr.launches for ctr in counters}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran in training: {launches}")
    step_s += [run() for _ in range(timed - 1)]
    total = {ctr.name: ctr.launches for ctr in counters}
    if total != {k: timed * v for k, v in launches.items()}:
        raise AssertionError(f"launches differ between steps: {total}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    q1, med, q3 = np.percentile(step_s, [25, 50, 75])

    # one step synchronised at each stage boundary
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
              for k in ("sort_chunk", "sort_global_stage", "conv_sk_kernel",
                        "conv_down_kernel", "conv_up_kernel", "SkSource",
                        "DownSource", "UpSource", "dw_reduce")}
    checks = {"finite_losses": bool(np.isfinite(losses).all()),
              "loss_first": losses[0], "loss_last": losses[-1]}
    if not (checks["finite_losses"] and losses[-1] < losses[0]):
        raise AssertionError(f"training sanity failed: {losses}")
    log("train", batch=b, points=int(batch["points"].shape[1]),
        voxel_capacity=TRAIN_CAPACITY, backbone="minkunet (18D)",
        warmup_steps=warmup, steps=timed, card=smi_line(),
        steps_per_s_median=1 / med, steps_per_s_q1_q3=[1 / q3, 1 / q1],
        clouds_per_s_median=b / med, clouds_per_s_q1_q3=[b / q3, b / q1],
        step_ms_median=step_ms, step_ms_all=[1e3 * x for x in step_s],
        stage_ms={k: 1e3 * v for k, v in stages.items()},
        device_busy_ms=busy, device_idle_share=1 - busy / step_ms,
        ported_kernel_device_ms=ported, top_device_ms=top,
        launches_per_step=launches, peak_mem_gb=peak_gb, losses=losses,
        **checks)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)

    from mrcc_tpu_torch.ops import conv, sort

    phase_build()
    dev = torch.device("cuda")
    inputs, caps, levels = bench_levels(dev)
    tlevels = train_levels(train_batch(), dev)
    records = phase_kernels(levels, tlevels, dev)
    phase_backward(tlevels, dev)
    del tlevels
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    counters = [sort.SORT, conv.SK, conv.DOWN, conv.UP]
    launches = {"inference": phase_main_path(inputs, caps, counters)}
    torch.cuda.empty_cache()
    launches["training"] = phase_train(
        counters + [conv.DW_SK, conv.DW_DOWN, conv.DW_UP])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    for r in records:
        r["launches_by_path"] = {path: n.get(r["kernel"])
                                 for path, n in launches.items()}
        r["launches"] = launches[r["path"]][r["kernel"]]
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
