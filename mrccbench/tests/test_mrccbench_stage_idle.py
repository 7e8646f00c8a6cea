"""The card's idle time by the program's stage spans
(``harness/stage_idle.py`` and the four ``*_idle_ms.train`` readers) on a
hand-built trace, and the five metrics that read the program's spans and
counters on a traced run on the CPU."""

import pytest
import torch

from mrccbench.harness import core, profiling, registry, stage_idle

IDLE = {"prepare": "prepare_idle_ms.train", "forward": "forward_idle_ms.train",
        "backward": "backward_idle_ms.train",
        "update": "update_idle_ms.train"}


def _trace(with_step=True):
    ev = [("user_annotation", profiling.WINDOW, 0, 100, 1),
          ("user_annotation", "mrcc.train.prepare", 0, 30, 1),
          ("cpu_op", "aten::copy_", 2, 8, 1),
          ("user_annotation", "mrcc.train.forward", 30, 50, 1),
          ("user_annotation", "mrcc.train.backward", 50, 80, 1),
          ("user_annotation", "mrcc.train.update", 80, 88, 1),
          # autograd's thread: the parse drops it
          ("user_annotation", "mrcc.train.backward", 0, 100, 2),
          ("kernel", "k_a", 5, 25, 7), ("kernel", "k_b", 35, 60, 7),
          ("kernel", "k_c", 70, 78, 7), ("kernel", "k_d", 95, 110, 7)]
    if with_step:
        ev.append(("user_annotation", "mrcc.train.step", 0, 90, 1))
    return profiling.parse({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a, "tid": t}
        for c, n, a, b, t in ev]})


# idle: [0, 5] in prepare; [25, 35] straddles prepare and forward;
# [60, 70] in backward; [78, 95]: backward to 80, update to 88, then inside
# no stage; ms per step, one step
EXPECTED = {"prepare": 0.010, "forward": 0.005, "backward": 0.012,
            "update": 0.008}


def test_idle_intervals_are_the_window_less_the_device():
    assert stage_idle.idle_intervals(_trace()) == [
        (0, 5), (25, 35), (60, 70), (78, 95)]
    assert stage_idle.steps(_trace()) == 1


@pytest.mark.parametrize("stage", sorted(EXPECTED))
def test_stage_idle_of_a_hand_built_trace(stage):
    value = registry.metric(IDLE[stage]).read({"trace": _trace()})
    assert value == pytest.approx(EXPECTED[stage])


def test_idle_outside_every_stage_is_left_out():
    t = _trace()
    total = sum(b - a for a, b in stage_idle.idle_intervals(t)) * 1e-3
    assert sum(EXPECTED.values()) == pytest.approx(total - 0.007)


@pytest.mark.parametrize("stage", sorted(EXPECTED))
def test_a_trace_without_a_step_span_reads_no_number(stage):
    assert registry.metric(IDLE[stage]).read(
        {"trace": _trace(with_step=False)}) is None


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_traced_run_on_the_cpu_reads_the_program_spans(two_threads):
    steps = 2
    cell = registry.workload("train.seg18-b8")
    config = dict(registry.config(cell["config"]), backbone="minkunet14A")
    mix = dict(registry.traffic(cell["traffic"]), batch=2,
               scene={"n_ee": 300, "n_arm": 500, "n_bg": 800},
               max_points=1600, voxel_capacity=1024, traced_steps=steps,
               span_steps=1)
    r = core.make_run("train.seg18-b8", 2 ** 31 + 7, 0.1, 1,
                      torch.device("cpu"), cell=cell, config=config, mix=mix)
    line = core.result_line(r, core.execute(r), registry.benchmark())
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(IDLE.values()) | {"kernel_launches.train"} <= set(m)
    idle = [m[k] for k in IDLE.values()]
    assert all(v >= 0 for v in idle)
    per_step = (m["device_idle.train"] / 100 * line["device"]["window_s"]
                / steps * 1e3)
    assert sum(idle) <= per_step * (1 + 1e-9)
    # the CPU path launches no hand-written kernel
    assert m["kernel_launches.train"] == 0
