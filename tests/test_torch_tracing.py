"""The port's spans and counters (``mrcc_tpu_torch/tracing.py``) on the CPU.

A segmentation train step and a pose train step (``RobotNet`` with the
cos2 criterion on end-effector crops) at minkunet14A, B = 2, 1600 points,
capacity 1024:

- with no profiler recording, a step never enters ``record_function``
  or the fast record function;
- under ``torch.profiler`` each call leaves one ``mrcc.train.step`` span
  holding ``prepare`` (itself holding ``mrcc.sparse.voxelize`` and
  ``mrcc.sparse.build_hierarchy``), ``forward``, ``backward`` and
  ``update``, in that order; the pose step's ``forward`` holds its
  ``mrcc.models.pose_head`` and, after it, its ``mrcc.train.criterion``;
- a kernel library's call leaves ``mrcc.kernel.<library>.<function>``;
- every ``LaunchCounter`` of ``ops/`` is registered under a unique name;
- ``train_batches`` goes up by one for each ``prepare``.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mrcc_tpu_torch import tracing
from mrcc_tpu_torch.data.dataset import DataConfig, PoseDataset
from mrcc_tpu_torch.data.synthetic import generate_sample
from mrcc_tpu_torch.models import RobotNet, RobotNetSegmentation
from mrcc_tpu_torch.ops import (build, conv, conv_q8, hit_lists, k3_order, nn,
                                norm, rank, sort)
from mrcc_tpu_torch.sparse.nn import init_parameters
from mrcc_tpu_torch.train import (LossConfig, TrainConfig,
                                  make_pose_train_step,
                                  make_segmentation_train_step)
from mrcc_tpu_torch.train.trainer import TRAIN_BATCHES, PoseTrainStep

B, P, CAP = 2, 1600, 1024
STAGES = ("prepare", "forward", "backward", "update")
OPS = (conv, conv_q8, hit_lists, k3_order, nn, norm, rank, sort)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step():
    model = init_parameters(RobotNetSegmentation(backbone="minkunet14A"), 0)
    s, _ = make_segmentation_train_step(
        model, DataConfig(data_type=None, max_points=P, scale=100.0),
        TrainConfig(batch_size=B), CAP, device="cpu")
    return s


@pytest.fixture(scope="module")
def pose_step():
    model = init_parameters(RobotNet(backbone="minkunet14A"), 0)
    s, _ = make_pose_train_step(
        model, DataConfig(max_points=P), LossConfig(loss_type="cos2"),
        TrainConfig(batch_size=B), CAP, device="cpu")
    return s


@pytest.fixture(scope="module")
def pose_batch():
    """Two end-effector crops of synthetic scenes, collated."""
    data = PoseDataset(DataConfig(max_points=P), B, seed=11, n_ee=1200,
                       n_arm=300, n_bg=300)
    return data.collate(data.items)


@pytest.fixture(params=["segmentation", "pose"])
def stepped(request):
    """``(train step, batch)`` of each kind of sparse train step."""
    if request.param == "pose":
        return (request.getfixturevalue("pose_step"),
                request.getfixturevalue("pose_batch"))
    return request.getfixturevalue("step"), request.getfixturevalue("batch")


@pytest.fixture(scope="module")
def batch():
    points = np.zeros((B, P, 3), np.float32)
    feats = np.zeros((B, P, 3), np.float32)
    labels = np.full((B, P), -100, np.int32)
    for i in range(B):
        s = generate_sample(seed=11 + i, n_ee=300, n_arm=500, n_bg=800)
        p = s["points"]
        points[i] = p - (p.max(0) + p.min(0)) / 2
        feats[i] = s["rgb"] - 0.5
        labels[i] = s["labels"]
    return {"points": points, "feats": feats, "labels": labels,
            "mask": np.ones((B, P), bool)}


def _spans(prof):
    """``[(name, start, end)]`` of the ``mrcc.`` spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(tracing.PREFIX)),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_step_without_a_profiler_never_enters_record_function(
        stepped, monkeypatch):
    step, batch = stepped

    def refuse(name):
        raise AssertionError(f"a span {name!r} entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    out = step(batch, 1e-4)
    assert torch.isfinite(out["loss"])


@pytest.mark.parametrize("calls", [1, 2])
def test_each_call_leaves_one_step_span_with_its_stages_in_order(
        stepped, calls):
    step, batch = stepped
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            step(batch, 1e-4)
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "mrcc.train.step"]
    assert len(steps) == calls
    names = [f"mrcc.train.{k}" for k in STAGES]
    for outer in steps:
        inner = [s for s in spans if s is not outer and _inside(s, outer)]
        stages = [s for s in inner if s[0] in names]
        assert [s[0] for s in stages] == names
        assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
        prepare, forward = stages[:2]
        for name in ("mrcc.sparse.voxelize", "mrcc.sparse.build_hierarchy"):
            found = [s for s in inner if s[0] == name]
            assert len(found) == 1 and _inside(found[0], prepare), name
        head = [s for s in inner if s[0] in (
            "mrcc.models.pose_head", "mrcc.train.criterion")]
        if isinstance(step, PoseTrainStep):
            assert [s[0] for s in head] == ["mrcc.models.pose_head",
                                            "mrcc.train.criterion"]
            assert all(_inside(s, forward) for s in head)
            assert head[0][2] <= head[1][1]
        else:
            assert not head


@pytest.mark.parametrize("kind", ["span", "launch_span"])
@pytest.mark.parametrize("form", ["with", "decorator"])
def test_span_names_its_block_or_function(form, kind):
    def work():
        return torch.ones(4).sum()

    make = getattr(tracing, kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if form == "with":
            with make("test.block"):
                work()
        else:
            make("test.block")(work)()
    assert [s[0] for s in _spans(prof)] == ["mrcc.test.block"]


def test_a_kernel_call_leaves_its_library_and_function_span(monkeypatch):
    lib = build.KernelLibrary("fake_lib", {"fake_fn": ()})
    lib._lib = types.SimpleNamespace(fake_fn=lambda *args: 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lib.call("fake_fn")
    assert [s[0] for s in _spans(prof)] == ["mrcc.kernel.fake_lib.fake_fn"]


def test_every_launch_counter_of_ops_is_registered_once():
    found = [v for m in OPS for v in vars(m).values()
             if isinstance(v, tracing.LaunchCounter)]
    names = [c.name for c in found]
    assert len(found) == 26 and len(set(names)) == len(names)
    launches = tracing.counts(tracing.LaunchCounter)
    assert set(names) == set(launches)
    assert all(tracing._COUNTERS[c.name] is c for c in found)
    assert "train_batches" in tracing.counts()
    assert "train_batches" not in launches
    with pytest.raises(ValueError):
        tracing.LaunchCounter(names[0])


def test_launches_and_count_are_one_number():
    c = conv.SK
    before = c.launches
    c.launches += 2
    assert c.count == before + 2 == tracing.counts()[c.name]
    c.launches = before


@pytest.mark.parametrize("how", ["prepare", "step"])
def test_train_batches_goes_up_by_one_a_prepare(step, batch, how):
    before = TRAIN_BATCHES.count
    for _ in range(2):
        if how == "prepare":
            step.prepare(batch)
        else:
            step(batch, 1e-4)
    assert TRAIN_BATCHES.count == before + 2
