"""Package rules of mrcc_tpu_torch: no JAX, its own data, card by default.

- Importing the package, every submodule (the training data, models and
  criteria among them) and building a CPU engine leaves
  ``jax``, ``flax``, ``optax`` and ``mrcc_tpu`` (as a whole module name, not
  the ``mrcc_tpu_torch`` prefix) out of ``sys.modules``; no source of the
  package or ``chip_smoke.py`` imports them.
- The port's copy of the scene generator and ICP template give the JAX
  package's numbers for a seed.
- ``InferenceEngine(cfg)`` without a device means the card, and raises
  where there is none.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrcc_tpu.data.synthetic import generate_sample as jax_generate_sample
from mrcc_tpu.solve.icp import default_template as jax_default_template
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.data.synthetic import build_batch, generate_sample
from mrcc_tpu_torch.solve import default_template


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: under the suite's
    parallel workers torch's default of a thread a core oversubscribes the
    CPU (one small engine call took 185 s at six-way contention on an
    8-core CPU, 1.8 s at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mrcc_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


_PROBE = r"""
import importlib, json, pkgutil, sys
import mrcc_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mrcc_tpu_torch.__path__,
                                              "mrcc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.data.synthetic import build_batch
cfg = InferenceConfig(point_capacity=256, seg_voxel_capacity=256,
                      ee_point_capacity=128, ee_voxel_capacity=128,
                      kp_voxel_capacity=128, seg_backbone="minkunet14A",
                      rot_backbone="minkunet14A", kp_backbone="minkunet14A",
                      icp_iterations=2, icp_template_points=64,
                      compute_dtype="float32")
eng = InferenceEngine(cfg, device="cpu")
out = eng.predict_batch_arrays(*build_batch(1, 256))
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "keys": sorted(out)}))
"""


def test_no_jax_in_the_port_process():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(info["modules"]) >= 20
    for name in ("data.augmentation", "data.dataset", "data.labels",
                 "data.ycb", "models.featurenet", "solve.vote",
                 "train.metric_learning", "models.resnet_sparse",
                 "models.aliveunet", "ops.points", "ops.prng",
                 "models.pointnet2", "data.dense", "config.config",
                 "config.default", "cli.common", "cli.test_mains",
                 "eval.harness", "eval.benchmark", "eval.report",
                 "app.main", "app.calibrate_pcd", "data.alivev1",
                 "data.rgbd", "utils.logger"):
        assert f"mrcc_tpu_torch.{name}" in info["modules"], name
    assert "ee_pose" in info["keys"]
    leaked = [m for m in info["loaded"] if _forbidden(m)]
    assert not leaked, leaked


def test_no_jax_imports_in_the_sources():
    files = sorted((ROOT / "mrcc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, (path, bad)


@pytest.mark.parametrize("seed", [0, 13])
def test_generator_matches_jax_package(seed):
    kw = dict(n_ee=300, n_arm=400, n_bg=500)
    a = jax_generate_sample(seed=seed, **kw)
    b = generate_sample(seed=seed, **kw)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_build_batch_pads_scenes():
    pts, rgb, mask = build_batch(2, 4096, seed=1)
    assert pts.shape == (2, 4096, 3) and mask.shape == (2, 4096)
    n = mask.sum(axis=1)
    assert (n > 3000).all()
    assert not pts[0, n[0]:].any()


def test_build_batch_labels():
    pts, rgb, mask, labels = build_batch(2, 4096, seed=1, with_labels=True)
    assert labels.shape == (2, 4096) and labels.dtype == np.int32
    assert set(np.unique(labels[mask])) == {0, 1, 2}
    assert (labels[~mask] == -100).all()
    n = int(mask[0].sum())
    want = jax_generate_sample(seed=1, n_ee=512, n_arm=1024, n_bg=2048)
    np.testing.assert_array_equal(labels[0, :n], want["labels"][:n])
    np.testing.assert_array_equal(pts, build_batch(2, 4096, seed=1)[0])


@pytest.mark.parametrize("n", [256, 1024])
def test_icp_template_matches_jax_package(n):
    np.testing.assert_array_equal(default_template(n),
                                  jax_default_template(n))


def test_engine_defaults_to_the_card():
    cfg = InferenceConfig(point_capacity=256, seg_voxel_capacity=256,
                          seg_backbone="minkunet14A",
                          rot_backbone="minkunet14A",
                          kp_backbone="minkunet14A")
    if torch.cuda.is_available():
        assert InferenceEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(cfg)


def test_later_slices_raise():
    # the dense keypoint backend configures since the PointNet2 slice
    cfg = InferenceConfig(kp_backbone="pointnet2")
    assert cfg.num_of_dense_input_points == 2048
    assert cfg.kp_sampling_method == "uniform"
    assert not cfg.kp_use_coordinates_as_features
    with pytest.raises(ValueError):
        InferenceConfig(kp_backbone="pointnet2", kp_sampling_method="random")


def test_opt_in_heads_configure():
    cfg = InferenceConfig(rot_6d=True, compute_confidence=True,
                          rot_flip_disambiguation=True,
                          translation_z_percentile=2.0)
    assert cfg.rot_6d and cfg.compute_confidence
    assert cfg.rot_flip_disambiguation
    assert cfg.translation_z_percentile == 2.0
