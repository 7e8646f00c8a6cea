"""The pose training cell (``train.pose18-b8``): its files load by name, its
five readers read a hand-built trace, its reference and traffic kind import
neither JAX nor the port, its work plan is the pose net's, and at a CPU
size its faults make ``correct`` false under the cell's own limits while a
sound run stays correct."""

import dataclasses
import subprocess
import sys

import pytest
import torch

from mrccbench.harness import core, profiling, registry
from mrccbench.reference import minkunet, robotnet, train as ref_train
from mrccbench.work import counts, peaks

CELL = "train.pose18-b8"
READERS = ("prepare_idle_ms.pose", "forward_idle_ms.pose",
           "head_idle_ms.pose", "conv_roofline.pose", "mfu.pose")
BENCH = registry.benchmark()


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_cell_configuration_mix_kind_and_readers_load_by_name():
    cell = registry.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pose18-train", "crops4k-b8", 1)
    config = registry.config(cell["config"])
    assert (config["model"], config["backbone"], config["out_channels"],
            config["loss"], config["tf32"]) == (
        "RobotNet", "minkunet18D", 7, "cos2", False)
    mix = registry.traffic(cell["traffic"])
    assert (mix["kind"], mix["batch"], mix["voxel_capacity"]) == (
        "pose_steps", 8, 4096)
    assert callable(registry.kind(mix["kind"]).run)
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "train_steps_per_s"
        assert registry.metric(name).read({}) is None
    assert [w["name"] for w in BENCH["workloads"]].count(CELL) == 1


def _trace():
    ev = [("user_annotation", profiling.WINDOW, 0, 100, 1),
          ("user_annotation", "mrcc.train.step", 0, 90, 1),
          ("user_annotation", "mrcc.train.prepare", 0, 30, 1),
          ("user_annotation", "mrcc.train.forward", 30, 60, 1),
          ("user_annotation", "mrcc.models.pose_head", 40, 50, 1),
          ("user_annotation", "mrcc.train.criterion", 48, 56, 1),
          ("user_annotation", "mrcc.train.backward", 60, 80, 1),
          ("kernel", "void mrcc::tc::gather_mma_kernel<float>", 5, 25, 7),
          ("kernel", "k_head", 35, 42, 7),
          ("kernel", "void mrcc::dw::dw_mma_kernel<float, 4>", 54, 70, 7)]
    return profiling.parse({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a, "tid": t}
        for c, n, a, b, t in ev]})


def test_readers_read_a_hand_built_trace():
    # idle: [0, 5] and [25, 35] (prepare to 30, forward from 30), [42, 54]
    # (forward; the head and criterion's union [40, 56] holds it whole),
    # [70, 100] (backward to 80); ms per step, one step
    ctx = {"trace": dict(_trace(), conv_least_s=9e-6), "dtype": "float32",
           "window": {"model_ops": 495e12 * 2.0 * 0.01, "seconds": 2.0}}
    got = {n: registry.metric(n).read(ctx) for n in READERS}
    assert got["prepare_idle_ms.pose"] == pytest.approx(0.010)
    assert got["forward_idle_ms.pose"] == pytest.approx(0.017)
    assert got["head_idle_ms.pose"] == pytest.approx(0.012)
    # the two conv kernels ran 36 us for 9 us of least time
    assert got["conv_roofline.pose"] == pytest.approx(25.0)
    assert got["mfu.pose"] == pytest.approx(1.0)


def test_head_idle_reads_no_number_without_the_head_spans():
    t = _trace()
    t["host"] = [h for h in t["host"] if h[0] not in (
        "mrcc.models.pose_head", "mrcc.train.criterion")]
    assert registry.metric("head_idle_ms.pose").read({"trace": t}) is None


def test_reference_crops_and_kind_import_neither_jax_nor_the_port():
    code = ("import sys; from mrccbench.harness import registry; "
            "import mrccbench.reference.robotnet, mrccbench.data.crops; "
            "import mrccbench.calibrate_pose; "
            "registry.kind('pose_steps'); "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mrcc_tpu', 'mrcc_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=registry.ROOT, check=True)
    assert out.stdout.strip() == "[]", out.stderr


def test_the_pose_plan_has_no_final_conv_and_counts_the_head():
    cfg = registry.config("pose18-train")
    plan = robotnet.layer_plan(cfg)
    names = [p[0] for p in plan]
    assert "final" not in names
    assert not any(n.startswith("regression") for n in names)
    assert plan[-2:] == [
        ("pose_regression.0", "dense", robotnet.ITEMS, 384, 2048),
        ("pose_regression.2", "dense", robotnet.ITEMS, 2048, 7)]
    seg = minkunet.layer_plan(dict(cfg, unet_out_channels=256,
                                   num_classes=3))
    assert plan[:-2] == seg[:-3]
    spec = robotnet.parameter_spec(cfg)
    assert sum(torch.Size(s).numel() for _, s, _ in spec) == 80_660_967
    st = counts.LevelStats(rows=[100, 50, 20, 10, 5], k3_hits=[900, 400,
                                                               150, 60, 20],
                           links=[90, 45, 18, 9])
    with_items = dataclasses.replace(st, rows=st.rows + [8],
                                     k3_hits=st.k3_hits + [0])
    got = counts.step_work(plan, with_items, "float32", training=True)
    backbone = counts.step_work(plan[:-2], st, "float32", training=True)
    head = 3 * 2 * 8 * (384 * 2048 + 2048 * 7)
    assert got["model_ops"] == backbone["model_ops"] + head
    assert got["conv_least_s"] == pytest.approx(backbone["conv_least_s"])
    assert peaks.FLOPS[cfg["dtype"]] == 495e12


def test_reference_item_max_takes_each_items_rows():
    level = robotnet.sparse.Level(
        key=torch.arange(5), off=torch.zeros((5, 3), dtype=torch.long),
        item=torch.tensor([0, 0, 0, 2, 2]), count=torch.tensor([3, 0, 2]))
    x = torch.tensor([[1.0, 5.0], [3.0, -1.0], [2.0, 0.0], [-4.0, 7.0],
                      [-2.0, 6.0]], requires_grad=True)
    m = robotnet.item_max(x, level)
    assert m.tolist() == [[3.0, 5.0], [0.0, 0.0], [-2.0, 7.0]]
    m.sum().backward()
    assert x.grad.tolist() == [[0, 1], [1, 0], [0, 0], [0, 1], [1, 0]]


def _run(seed, fault=None):
    cell = registry.workload(CELL)
    config = dict(registry.config(cell["config"]), backbone="minkunet14A")
    mix = dict(registry.traffic(cell["traffic"]), batch=2,
               scene={"n_ee": 1500, "n_arm": 600, "n_bg": 1000},
               max_points=2048, voxel_capacity=512)
    return core.make_run(CELL, seed, 0.2, 0, torch.device("cpu"),
                         fault=fault, cell=cell, config=config, mix=mix)


def _line(r):
    return core.result_line(r, core.execute(r), BENCH)


def test_sound_run_is_correct():
    line = _line(_run(2 ** 31 + 101))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault",
                         ["half_batch", "frozen", "unit_quaternion"])
def test_faults_are_not_correct(fault):
    line = _line(_run(2 ** 31 + 102, fault))
    assert not line["correct"], line["checks"]
    if fault == "frozen":  # a state left unchanged reads 1
        assert line["checks"]["change"]["value"] == pytest.approx(1.0)


def test_tf32_control_is_not_correct():
    r = _run(2 ** 31 + 103)
    kind = registry.kind(r.mix["kind"])
    s = kind.Setup(r)
    s.free()
    want = kind.reference_readings(s)
    got = kind.reference_readings(s, precision="tf32")
    gaps = ref_train.compare(got, want)
    limits = r.cell["limits"]
    assert any(gaps[k][0] > limits[k] for k in limits), gaps
