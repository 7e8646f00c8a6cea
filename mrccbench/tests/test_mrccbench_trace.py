"""The reduction from a profiler trace to the device metrics: busy time as
the union of device intervals inside the window, the top operations, idle
gaps named by the innermost host operation running when each began; and
a traced run on the CPU giving every reader something or nothing."""

import pytest
import torch

from mrccbench.harness import core, profiling, registry


def _trace():
    ev = [("user_annotation", profiling.WINDOW, 0, 100, 1),
          ("cpu_op", "aten::step", 0, 90, 1),
          ("cpu_op", "aten::copy_", 10, 20, 1),
          ("cpu_op", "aten::other_thread", 30, 60, 2),
          ("kernel", "k_a", 5, 15, 7), ("kernel", "k_b", 12, 25, 7),
          ("kernel", "k_a", 40, 50, 7), ("gpu_memcpy", "copy", 95, 110, 7),
          ("kernel", "outside", 120, 130, 7)]
    return {"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a, "tid": t}
        for c, n, a, b, t in ev] + [{"ph": "i", "name": "marker"}]}


def test_busy_top_and_gaps_of_a_hand_built_trace():
    t = profiling.parse(_trace())
    assert profiling.window_seconds(t) == pytest.approx(100e-6)
    # union inside [0, 100]: [5, 25] + [40, 50] + [95, 100]
    assert profiling.busy_seconds(t) == pytest.approx(35e-6)
    top = dict(profiling.top_device_ops(t))
    assert top["k_a"] == pytest.approx(20e-6)
    assert "outside" not in top
    assert profiling.device_seconds(t, ("k_",)) == pytest.approx(33e-6)
    gaps = dict(profiling.idle_gaps(t))
    # gaps [0, 5] and [25, 40], [50, 95]: all inside aten::step, the
    # innermost open at their start (copy_ ended at 20; the other thread's
    # operation does not count)
    assert gaps == {"aten::step": pytest.approx(65e-6)}


def test_a_trace_without_the_window_is_refused():
    trace = _trace()
    trace["traceEvents"] = trace["traceEvents"][1:]
    with pytest.raises(RuntimeError):
        profiling.parse(trace)


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_traced_run_on_the_cpu_reads_the_spans(two_threads):
    cell = registry.workload("train.seg18-b8")
    config = dict(registry.config(cell["config"]), backbone="minkunet14A")
    mix = dict(registry.traffic(cell["traffic"]), batch=2,
               scene={"n_ee": 300, "n_arm": 500, "n_bg": 800},
               max_points=1600, voxel_capacity=1024, traced_steps=1,
               span_steps=1)
    r = core.make_run("train.seg18-b8", 2 ** 31 + 7, 0.1, 1,
                      torch.device("cpu"), cell=cell, config=config, mix=mix)
    line = core.result_line(r, core.execute(r), registry.benchmark())
    assert line["correct"], line["checks"]
    assert {"prepare_ms.train", "backward_ms.train"} <= set(line["metrics"])
    # no conv kernel ran on a card: the roofline reads no number
    assert "conv_roofline.train" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
