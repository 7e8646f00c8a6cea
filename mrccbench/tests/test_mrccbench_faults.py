"""A whole run on the CPU at a size a test run can hold (the card's check
skipped, the port's plain PyTorch path underneath), with the timed path
broken: each fault a training cell can have makes ``correct`` false under
the cell's own limits, and so does the control, the reference in TF32 put
in the program's place; a sound run stays correct.  (A cell on one chip
has no exchange between chips to leave out.)"""

import pytest
import torch

from mrccbench.harness import core, registry
from mrccbench.reference import train as ref_train

CELL = "train.seg18-b8"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run(seed, fault=None):
    cell = registry.workload(CELL)
    config = dict(registry.config(cell["config"]), backbone="minkunet14A")
    mix = dict(registry.traffic(cell["traffic"]), batch=2,
               scene={"n_ee": 400, "n_arm": 600, "n_bg": 1000},
               max_points=2048, voxel_capacity=1024)
    return core.make_run(CELL, seed, 0.2, 0, torch.device("cpu"),
                         fault=fault, cell=cell, config=config, mix=mix)


def _line(r):
    return core.result_line(r, core.execute(r), registry.benchmark())


def test_sound_run_is_correct():
    line = _line(_run(2 ** 31 + 101))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
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
    assert any(v > limits[k] for k, (v, _) in gaps.items()), gaps
