"""The port's playground tools (``mrcc_tpu_torch.tools.play_*``) against
the JAX package's ``playground/play_*.py`` (CPU, ``--device cpu``).

Each JAX script is loaded by path (unchanged) and its ``main`` driven
with ``sys.argv`` patched; its printed table is read back and held
against the rows the port's ``main(argv)`` returns:

- ``play_icp``: the 12 trials (noise x initial rotation).  ICP starts
  from perturbed ground truth; where the start is near the optimum
  (noise <= 0.002, initial rotation <= 0.3 rad: ``play_icp.CONVERGED``,
  ROADMAP C5) the final errors agree within 5e-4 rad and 5e-4 m and meet
  the tool's own thresholds; further out ICP may settle in another
  minimum under other rounding, and only finiteness is held;
- ``play_ee_icp``: the 10 trials' initial errors to the printed precision;
  where the start is within 20 degrees the recovered errors agree within
  1 degree and 2 mm (the crop carries 3 mm of noise; the end pose of
  such an ICP spreads by ~0.3 degree under re-rounding, C5);
- ``play_keypoints``: the found keypoints' indices exactly, Kabsch's
  verdict, the round-trip errors to the printed precision, and the
  arrays handed to ``save_cloud_png`` bit for bit;
- ``play_segmentation``: the port's tool with ``--checkpoint`` (a JAX
  msgpack checkpoint of the JAX engine's seg net) on a recorded pickle,
  its point labels and EE count equal to the JAX engine's
  ``predict_batch_arrays`` on the same padded cloud, f32 at a small
  configuration (both packages' ``InferenceConfig`` patched to it).

The JAX ``play_ee_icp`` / ``play_keypoints`` read the sample's XYZW
``pose`` as WXYZ and ``play_segmentation`` unpacks three of ``_pad``'s
five values (ROADMAP C37): the first two are driven with
``generate_sample`` patched to give WXYZ, which is what they mean, and
the third is held to its ``ValueError``; the port's tools do what the
scripts mean.
"""

import dataclasses
import functools
import importlib.util
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.data import synthetic as jsynthetic
from mrcc_tpu.utils import visualization as jvis
from mrcc_tpu_torch.app import InferenceConfig
from mrcc_tpu_torch.tools import (play_ee_icp, play_icp, play_keypoints,
                                  play_segmentation)
from mrcc_tpu_torch.utils import visualization as vis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"-?\d+\.\d+"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script(name):
    """The JAX package's ``playground/name.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_playground_{name}", os.path.join(ROOT, "playground",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(mod, argv, monkeypatch, capsys):
    """``mod.main()`` under ``argv``; its printed lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__file__] + [str(a) for a in argv])
    mod.main()
    return capsys.readouterr().out.splitlines()


def _table(lines, width):
    return [[float(v) for v in re.findall(NUM, line)] for line in lines
            if len(re.findall(NUM, line)) == width
            and not re.search("[a-zA-Z]", line)]


def _wxyz_samples(monkeypatch, mod):
    """Patch ``mod.generate_sample`` to give the pose as WXYZ."""
    def wxyz(*a, **kw):
        s = jsynthetic.generate_sample(*a, **kw)
        p = s["pose"]
        s["pose"] = np.concatenate([p[:3], p[6:7], p[3:6]]).astype(p.dtype)
        return s

    monkeypatch.setattr(mod, "generate_sample", wxyz)


# ------------------------------------------------------------- play_icp

def test_play_icp(monkeypatch, capsys):
    want = _table(run_script(script("play_icp"), [], monkeypatch, capsys), 4)
    rows = play_icp.main(["--device", "cpu"])
    assert len(rows) == len(want) == 12
    near = 0
    for row, (noise, angle, rot, trans) in zip(rows, want):
        assert (row["noise"], row["angle"]) == (noise, angle)
        assert np.isfinite([row["rot_err"], row["trans_err"]]).all()
        if (noise <= play_icp.CONVERGED["noise"]
                and angle <= play_icp.CONVERGED["angle"]):
            near += 1
            assert abs(row["rot_err"] - rot) <= 5e-4, (row, rot)
            assert abs(row["trans_err"] - trans) <= 5e-4, (row, trans)
        assert play_icp.converged(row), row
    assert near == 4


# ---------------------------------------------------------- play_ee_icp

def test_play_ee_icp(monkeypatch, capsys):
    mod = script("play_ee_icp")
    _wxyz_samples(monkeypatch, mod)
    want = _table(run_script(mod, [], monkeypatch, capsys), 4)
    rows = play_ee_icp.main(["--device", "cpu"])
    assert len(rows) == len(want) == 10
    for row, (init_rot, init_t, rot, t) in zip(rows, want):
        assert abs(row["init_rot"] - init_rot) <= 0.005 + 1e-4
        assert abs(row["init_t"] - init_t) <= 5e-5 + 1e-6
        assert np.isfinite([row["rot_err"], row["t_err"]]).all()
        if init_rot <= 20:
            assert abs(row["rot_err"] - rot) <= 1.0, (row, rot)
            assert abs(row["t_err"] - t) <= 2e-3, (row, t)
            assert row["rot_err"] <= 10 and row["t_err"] <= 0.01, row


# -------------------------------------------------------- play_keypoints

@pytest.mark.parametrize("seed", [5, 8])
def test_play_keypoints(tmp_path, monkeypatch, capsys, seed):
    mod = script("play_keypoints")
    _wxyz_samples(monkeypatch, mod)
    want_png, got_png = [], []
    for store, module in ((want_png, jvis), (got_png, vis)):
        monkeypatch.setattr(
            module, "save_cloud_png",
            lambda p, c, path, _s=store, **kw: _s.append(
                (np.array(p), np.array(c), kw)) or path)
    lines = run_script(mod, ["--seed", seed, "--snapshot",
                             tmp_path / "j.png"], monkeypatch, capsys)
    got = play_keypoints.main(["--seed", str(seed), "--snapshot",
                               str(tmp_path / "p.png"), "--device", "cpu"])
    text = "\n".join(lines)
    idx = [int(v) for v in re.search(r"indices: \[([^\]]*)\]",
                                     text).group(1).split(",")]
    assert got["kp_idx"].tolist() == idx and got["found"].sum() >= 4
    assert f"Kabsch ok: {got['ok']}" in text
    cm, deg = (float(v) for v in re.search(
        rf"translation ({NUM}) cm, rotation ({NUM}) deg", text).groups())
    assert abs(got["t_err"] * 100 - cm) <= 0.005 + 1e-4
    assert abs(np.degrees(got["r_err"]) - deg) <= 0.005 + 1e-3
    assert len(got_png) == len(want_png) == 1
    for g, w in zip(got_png[0][:2], want_png[0][:2]):
        np.testing.assert_array_equal(g, w)
    assert got_png[0][2] == want_png[0][2] == {"s": 3.0}


# ----------------------------------------------------- play_segmentation

SMALL = dict(seg_voxel_capacity=1024, ee_point_capacity=512,
             ee_voxel_capacity=512, kp_voxel_capacity=512,
             seg_hierarchy_caps=(512, 256, 128, 64),
             ee_hierarchy_caps=(256, 128, 64, 64),
             kp_hierarchy_caps=(256, 128, 64, 64),
             seg_backbone="minkunet14A", rot_backbone="minkunet14A",
             kp_backbone="minkunet14A", icp_iterations=5,
             icp_template_points=256, compute_dtype="float32")


@pytest.fixture(scope="module")
def seg_case(tmp_path_factory):
    """A recorded scene of 1700 points, the JAX engine at ``SMALL`` with its
    seg net written as a msgpack checkpoint, and its point labels and EE
    count on the scene."""
    import flax.serialization

    root = tmp_path_factory.mktemp("seg")
    jsynthetic.write_sample_set(root, n=1, seed0=3, n_ee=500, n_arm=500,
                                n_bg=700)
    path = str(root / "labeled" / "1.pickle")
    sample = jsynthetic.generate_sample(seed=3, n_ee=500, n_arm=500,
                                        n_bg=700)
    n = len(sample["points"])
    cfg = JaxConfig(point_capacity=1 << int(np.ceil(np.log2(n))),
                    k3_self_keyed=False, **SMALL)
    engine = JaxEngine(cfg, seed=0)
    seg = jax.device_get(engine.params["segmentation"])
    ckpt = root / "seg.msgpack"
    ckpt.write_bytes(flax.serialization.msgpack_serialize(
        {"params": seg["params"], "batch_stats": seg["batch_stats"]}))
    pts, cols, mask, _, _ = engine._pad(sample["points"], sample["rgb"])
    out = engine.predict_batch_arrays(pts, cols, mask)
    return dict(path=path, ckpt=str(ckpt), n=n,
                labels=np.asarray(out["segmentation"][0])[:n],
                ee_count=int(out["ee_count"][0]), cfg=cfg)


def test_play_segmentation_jax_script_stops_at_pad(seg_case, monkeypatch):
    """C37: the JAX script unpacks three of ``_pad``'s five values."""
    mod = script("play_segmentation")
    monkeypatch.setattr(mod, "InferenceConfig",
                        functools.partial(JaxConfig, k3_self_keyed=False,
                                          **SMALL))
    monkeypatch.setattr(sys, "argv", [mod.__file__, seg_case["path"]])
    with pytest.raises(ValueError, match="too many values to unpack"):
        mod.main()


def test_play_segmentation(seg_case, tmp_path, monkeypatch):
    monkeypatch.setattr(play_segmentation, "InferenceConfig",
                        functools.partial(InferenceConfig, **SMALL))
    pictures = []
    monkeypatch.setattr(vis, "save_cloud_png",
                        lambda p, c, path: pictures.append((p, c, path)))
    got = play_segmentation.main([seg_case["path"], "--checkpoint",
                                  seg_case["ckpt"], "--snapshot",
                                  str(tmp_path / "s.png"), "--device",
                                  "cpu"])
    engine = got["engine"]
    assert engine.cfg.point_capacity == seg_case["cfg"].point_capacity
    assert dataclasses.asdict(engine.cfg)["seg_checkpoint"] == \
        seg_case["ckpt"]
    labels = got["segmentation"]
    assert labels.shape == (seg_case["n"],)
    np.testing.assert_array_equal(labels, seg_case["labels"])
    assert int(got["out"]["ee_count"][0]) == seg_case["ee_count"]
    assert len(np.unique(labels)) >= 2
    (p, c, path), = pictures
    assert path == str(tmp_path / "s.png") and len(p) == seg_case["n"]
    np.testing.assert_array_equal(
        c, play_segmentation.CLASS_COLORS[np.clip(labels, 0, 2)])
