"""On-card smoke test of the PyTorch + CUDA port (``mrcc_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero before the last
line):

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: compile the kernels of ``mrcc_tpu_torch/csrc`` (one nvcc per
   source, all started together), with ptxas register / smem lines;
3. kernels vs their plain PyTorch twins at the main path's shapes (exact
   for the sort; relative norm 2e-2 for bf16 against the f32 twin, 1e-5 for
   f32), timed with CUDA events;
4. the slice on the card vs the slice on the CPU: one engine pair with the
   same weights, f32, small size (integer outputs exact, poses 1e-3);
5. the main path at full width (B=8, P=16384, minkunet18 seg/kp, the 18D
   encoder for rotation, bf16, capacities from the occupancy probe): one
   run with every launch count set to 0 before and read after, then 12
   batches timed one by one -> clouds/s (median, quartiles), one batch
   synchronised at each stage boundary, one batch under torch.profiler
   (device time by kernel, device idle share), and sanity checks.

f32 phases run with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).  The last lines are the card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""

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
    infos = build_all([sort.LIB, conv.SK_LIB, conv.MAP_LIB])
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


def phase_kernels(levels, device):
    """Each kernel vs its plain twin at the main path's shapes."""
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
    for b, n, hi in ((8, 16384, 3000), (8, 12544, 1 << 30)):
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
            name=f"argsort[{b}x{n}]", kernel="argsort", route="cuda",
            source="mrcc_tpu_torch/csrc/sort.cu",
            replaces="mrcc_tpu/ops/sort_pallas.py:107", max_abs_err=0.0,
            tolerance="exact", ms=ms,
            plain_ms=cuda_ms(lambda: sort.argsort_plain(key)),
            library_ms=cuda_ms(lambda: torch.argsort(key, dim=-1,
                                                     stable=True)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b * n * 12, b * _ce_count(n), "f32")))))

    def conv_case(name, kernel, source, fn, plain, args32, hits, cin, cout,
                  map_bytes, nrows_in, nrows_out, k):
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
        b = args32[0].shape[0]
        nbytes = 2 * (b * nrows_in * cin + k * cin * cout
                      + b * nrows_out * cout) + map_bytes
        bms, by = bound_ms(nbytes, 2 * hits * cin * cout, "bf16")
        records.append(dict(
            name=name, kernel=kernel, route="cuda", source=source,
            replaces="mrcc_tpu/ops/conv_pallas.py:"
                     + ("767" if kernel == "conv_sk" else "120"),
            max_abs_err=float((got16.float() - want).abs().max()),
            rel_err=errs, tolerance={"f32": TOL_F32, "bf16": TOL_BF16},
            ms=cuda_ms(lambda: fn(*args16)),
            plain_ms=cuda_ms(lambda: plain(*args16)), library_ms=None,
            bound_ms=bms, bound_by=by))

    from mrcc_tpu_torch.ops.conv import _K3_DELTAS

    for li, cin, cout in ((0, 3, 32), (0, 128, 96), (3, 384, 256)):
        lv = levels[li]
        b, n = lv.key.shape
        hits = _sk_hits(lv, _K3_DELTAS)
        conv_case(f"conv_sk[{b}x{n} {cin}->{cout}]", "conv_sk",
                  "mrcc_tpu_torch/csrc/conv_sk.cu", conv.gather_gemm_sk,
                  conv.gather_gemm_sk_plain,
                  [feats(lv, cin), weights(27, cin, cout), lv.key, lv.kbits],
                  hits, cin, cout, b * n * 8, n, n, 27)
    fine, coarse = levels[0], levels[1]
    b, nf = fine.key.shape
    nc = coarse.key.shape[1]
    conv_case(f"conv_down[{b}x{nf}->{nc} 32->32]", "conv_down",
              "mrcc_tpu_torch/csrc/conv_map.cu", conv.gather_gemm_down,
              conv.gather_gemm_down_plain,
              [feats(fine, 32), weights(8, 32, 32), coarse.child_idx,
               coarse.child_hit], int(coarse.child_hit.sum()), 32, 32,
              8 * b * nc * 5, nf, nc, 8)
    fine, coarse = levels[3], levels[4]
    b, nf = fine.key.shape
    nc = coarse.key.shape[1]
    row_ok = fine.valid & fine.parent_ok
    conv_case(f"conv_up[{b}x{nc}->{nf} 256->256]", "conv_up",
              "mrcc_tpu_torch/csrc/conv_map.cu", conv.gather_gemm_up,
              conv.gather_gemm_up_plain,
              [feats(coarse, 256), weights(8, 256, 256), fine.parent_idx,
               row_ok, fine.octant], int(row_ok.sum()), 256, 256,
              b * nf * 9, nc, nf, 8)
    log("kernels", cases=[{k: r.get(k) for k in (
        "name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err", "rel_err", "tolerance")} for r in records])
    return records


def _ce_count(n):
    """Compare-exchanges of one bitonic row padded to a power of two, two
    operations each (compare, select)."""
    n2, lg = 2, 1
    while n2 < n:
        n2, lg = n2 * 2, lg + 1
    return n2 * lg * (lg + 1) // 4 * 2


def _sk_hits(level, deltas):
    """(row, offset) pairs with a real neighbour: the K2 work this data
    needs."""
    key = level.key
    n = key.shape[1]
    total = 0
    for k, d in enumerate(deltas):
        q = key + d
        idx = torch.searchsorted(key, q).clamp_max(n - 1)
        hit = (((level.kbits >> k) & 1) != 0) & (key.gather(1, idx) == q)
        total += int(hit.sum())
    return total


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

    device_ms = profile_device_ms(engine, p, c, m)
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


def profile_device_ms(engine, p, c, m):
    """Device time (ms) by kernel over one profiled batch: device-side
    events only (an operator's own row repeats its kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.predict_batch_arrays(p, c, m)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ")[:120]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


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
    records = phase_kernels(levels, dev)
    phase_card_vs_cpu()
    launches = phase_main_path(inputs, caps,
                               [sort.SORT, conv.SK, conv.DOWN, conv.UP])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in records:
        r["launches"] = launches[r["kernel"]]
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
