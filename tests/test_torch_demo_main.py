"""``python -m mrcc_tpu_torch.cli.demo_checkpoints`` end to end on the CPU
at a tiny size (``test_torch_demo.TINY``): 2 scenes and 4 EE crops, 6
epochs of each net, 2 held-out frames.

- ``--json-out`` has the JAX script's layout: ``table`` (``Avg`` / ``Min`` /
  ``Max`` / ``Med`` / ``Std`` / ``N`` of metrics the JAX r2 table names,
  ``exp/trained_benchmark.json``), ``calibration`` and ``config``, whose
  keys are the ones ``scripts/train_demo_checkpoints.py`` writes (read
  from its source);
- the checkpoints follow the reference's naming (``{name}-%09d.ckpt``) and
  retention: epochs 1, 2, 3, 4 and 6 of 6 at ``save_freq`` 3;
- ``--bench-only`` restores the three checkpoints and reproduces the table
  exactly;
- training in two chunks (``--epochs 5 --skip-bench``, then ``--epochs
  6``, resuming from the latest checkpoints) ends at the uninterrupted
  run's weights: the same table, and the retention of a resumed run
  (epoch 5, saved as the first chunk's last, is pruned by epoch 6);
- ``--mesh 2`` on two gloo ranks trains as one process does, and only the
  first rank benchmarks;
- the card by default: without one, ``main`` raises unless the CPU is
  asked for; ``--mesh 2`` without a process group of two ranks raises.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mrcc_tpu_torch.cli import demo_checkpoints as demo
from test_torch_demo import TINY
from test_torch_demo import _one_thread  # noqa: F401 (one intra-op thread)
from torch_dp_worker import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--samples", "2", "--ee-mult", "2", "--batch", "2",
         "--bench-samples", "2"]
NAMES = {"segmentation": "seg", "rotation": "rot", "key_points": "kp"}


def jax_config_keys():
    """The keys of the ``config`` section the JAX script writes."""
    path = os.path.join(ROOT, "scripts", "train_demo_checkpoints.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "config" in keys:
                return {k.value for k in
                        node.values[keys.index("config")].keys}
    raise AssertionError("no config section in the JAX script")


def run(out, *flags, epochs=6):
    return demo.main(FLAGS + ["--epochs", str(epochs), "--out", str(out),
                              *flags], device="cpu", recipe=TINY)


def epochs_on_disk(out):
    got = {}
    for stage, name in NAMES.items():
        files = sorted(os.listdir(os.path.join(out, stage)))
        ckpts = [f for f in files if f.endswith(".ckpt")]
        assert all(f.startswith(f"{name}-") and len(f) == len(name) + 15
                   for f in ckpts), ckpts
        got[stage] = [int(f[len(name) + 1:-5]) for f in ckpts]
    return got


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    out = tmp_path_factory.mktemp("whole")
    res = run(out, "--json-out", str(out / "bench.json"))
    return out, res


def test_json_out_has_the_jax_layout(whole):
    out, res = whole
    with open(out / "bench.json") as f:
        written = json.load(f)
    assert set(written) == {"table", "calibration", "config"}
    assert set(written["config"]) == jax_config_keys()
    with open(os.path.join(ROOT, "exp", "trained_benchmark.json")) as f:
        jax_metrics = set(json.load(f)["table"])
    assert "seg_accuracy" in written["table"]
    assert set(written["table"]) <= jax_metrics
    for row in written["table"].values():
        assert set(row) == {"Avg", "Min", "Max", "Med", "Std", "N"}
        assert row["N"] == 2
    assert written["table"] == res["table"]
    assert written["config"]["epochs"] == 6
    assert written["config"]["backbone"] == "minkunet14A"


def test_training_ran_and_saved_with_the_reference_retention(whole):
    out, res = whole
    for stage in NAMES:
        hist = res["history"][stage]
        assert len(hist) == 6 and hist[-1]["loss"] < hist[0]["loss"]
        assert res["train_s"][stage] > 0
    assert epochs_on_disk(out) == {s: [1, 2, 3, 4, 6] for s in NAMES}


def test_bench_only_restores_the_table_exactly(whole):
    out, res = whole
    again = run(out, "--bench-only")
    assert again["history"] == {s: None for s in NAMES}
    assert again["table"] == res["table"]
    assert again["calibration"] == res["calibration"]
    for stage, trainer in again["trainers"].items():
        want = res["trainers"][stage].model.state_dict()
        got = trainer.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), stage


def test_chunked_training_resumes_to_the_same_weights(whole,
                                                      tmp_path_factory):
    _, res = whole
    out = tmp_path_factory.mktemp("chunks")
    first = run(out, "--skip-bench", epochs=5)
    assert "table" not in first
    assert epochs_on_disk(out) == {s: [1, 2, 4, 5] for s in NAMES}
    second = run(out)
    assert all(len(h) == 1 for h in second["history"].values())
    assert epochs_on_disk(out) == {s: [1, 2, 4, 6] for s in NAMES}
    assert second["table"] == res["table"]


def test_mesh_of_two_ranks_trains_as_one_process(tmp_path):
    """``--mesh 2`` on two gloo ranks against one process: 4 scenes and 4
    crops at batch 2 (no padding), every epoch loss within
    ``test_torch_parallel_train.py``'s ``rtol=1e-4, atol=1e-5``, the ranks
    equal, and only the first rank benchmarks."""
    flags = ["--samples", "4", "--ee-mult", "1", "--batch", "2",
             "--epochs", "2", "--bench-samples", "1"]
    one = demo.main(flags + ["--out", str(tmp_path / "one")], device="cpu",
                    recipe=TINY)
    spec = {"flags": flags, "recipe": dataclasses.asdict(TINY),
            "exp": str(tmp_path)}
    r0, r1 = run_ranks("demo", spec, tmp_path, timeout_s=300)
    assert r0["losses"] == r1["losses"]
    for stage, hist in one["history"].items():
        np.testing.assert_allclose(r0["losses"][stage],
                                   [h["loss"] for h in hist],
                                   rtol=1e-4, atol=1e-5, err_msg=stage)
    assert r0["table"] is not None and r1["table"] is None


def test_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(FLAGS + ["--out", str(tmp_path)], recipe=TINY)
    with pytest.raises(ValueError, match="make_mesh"):
        run(tmp_path, "--mesh", "2")
