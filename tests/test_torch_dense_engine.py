"""The engine's dense keypoint stage (``kp_backbone="pointnet2"``) vs the
JAX engine (CPU, f32).

- ``kp_stage`` against the JAX engine's ``_kp_jit`` with the same
  PointNet2SSG weights, on crops of 1024 rows (one item with 700 valid)
  and 512 dense inputs, for uniform and farthest sampling and with the
  coordinates as features: ``kp_found``, ``kp_ok`` and ``kp_coords``
  exactly, ``kp_pose`` to 1e-5, ``kp_conf`` to 1e-6.  The confidence gate
  is lowered to 0 so that a random net finds every class and Kabsch has a
  well-posed problem (with fewer than three classes found the pose is
  gated off by ``kp_ok`` and its rotation is not determined: both sides
  return some rotation).
- The ``enough`` gate: with fewer valid rows than dense inputs nothing is
  found on either side (JAX ``tests/test_app.py:166-180``), though the
  same net finds every class on a full crop.
- ``predict`` on a frame of the JAX ``tests/test_app.py`` dense
  configuration (minkunet14A seg / rot, 128 dense inputs) in f32, the port
  given the JAX engine's ``params`` through ``load_jax_params``: labels
  exact, keypoint classes and coordinates exact, poses 1e-3 (after ICP),
  ``is_confident`` equal; the flip is off (ROADMAP C1).
- An int8 engine with a dense keypoint stage configures (the stage has no
  sparse conv: only segmentation runs int8), calibrates and predicts.
- ``kp_checkpoint`` loads a dense net from a JAX msgpack ``TrainState``
  and from the port's ``.ckpt``; a reference PointNet2 ``.pth`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.app import PointCloudDTO as JaxCloud
from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from mrcc_tpu.train.checkpoint import checkpoint_save as jax_checkpoint_save
from mrcc_tpu.train.trainer import TrainState
from mrcc_tpu_torch.app import (InferenceConfig, InferenceEngine,
                                PointCloudDTO)
from mrcc_tpu_torch.app.inference_engine import q8_stages
from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.train import checkpoint_save

# tests/test_app.py::TestDenseKeypointPath's engine, in f32
APP_CFG = dict(point_capacity=4096, seg_voxel_capacity=2048,
               ee_point_capacity=1024, ee_voxel_capacity=1024,
               kp_voxel_capacity=512, seg_backbone="minkunet14A",
               rot_backbone="minkunet14A", kp_backbone="pointnet2",
               num_of_dense_input_points=128, icp_iterations=5,
               icp_template_points=256, ee_point_counts_threshold=64,
               sanity_min_num_of_ee_points=128, compute_dtype="float32")
E, ND = 1024, 512
KP_CFG = dict(point_capacity=2048, seg_voxel_capacity=1024,
              ee_point_capacity=E, ee_voxel_capacity=512,
              seg_backbone="minkunet14A", rot_backbone="minkunet14A",
              kp_backbone="pointnet2", num_of_dense_input_points=ND,
              kp_conf_threshold=0.0, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs files in
    parallel workers; torch's default of a thread a core oversubscribes
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssg_variables(seed=0):
    """Random PointNet2SSG(6) variables (LeCun-scaled kernels, random norm
    affines and statistics) from ``jax.eval_shape``."""
    model = JaxSSG(num_classes=6, in_channels=3)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 6), jnp.float32)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            out = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        elif name == "scale":
            out = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            out = 0.1 * rng.normal(size=s.shape)
        return out.astype(np.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(leaf, shapes))


def _crop(valid_rows=(E, 700), seed=3):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(2, E, 3)) * 0.05).astype(np.float32)
    rgb = rng.uniform(-0.5, 0.5, size=(2, E, 3)).astype(np.float32)
    valid = np.zeros((2, E), bool)
    for b, n in enumerate(valid_rows):
        valid[b, :n] = True
    return pts, rgb, valid


@pytest.fixture(scope="module")
def kp_weights():
    return _ssg_variables()


def _kp_pair(weights, **kw):
    jeng = JaxEngine(JaxConfig(**KP_CFG, **kw), params={
        "key_points": weights, "segmentation": None, "rotation": None})
    peng = InferenceEngine(InferenceConfig(**KP_CFG, **kw), device="cpu")
    load_jax_variables(peng.kp_model, weights)
    return jeng, peng


def _kp_both(jeng, peng, pts, rgb, valid):
    want = [np.asarray(a) for a in jeng._kp_jit(
        jeng.params["key_points"], jnp.asarray(pts), jnp.asarray(rgb),
        jnp.asarray(valid))]
    got = [a.numpy() for a in peng.kp_stage(_t(pts), _t(rgb), _t(valid))]
    return got, want


def _quat_close(a, b, atol):
    d = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))
    assert d.max() <= atol, d


@pytest.mark.parametrize("kw", [
    dict(kp_sampling_method="uniform"),
    dict(kp_sampling_method="farthest"),
    dict(kp_sampling_method="uniform", kp_use_coordinates_as_features=True),
], ids=["uniform", "farthest", "coords"])
def test_kp_stage_matches_jax(kp_weights, kw):
    jeng, peng = _kp_pair(kp_weights, **kw)
    got, want = _kp_both(jeng, peng, *_crop())
    pose, ok, coords, found, conf = got
    assert found.all() and ok.all(), "the open gate finds every class"
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(pose[:, :3], want[0][:, :3], atol=1e-5)
    _quat_close(pose[:, 3:], want[0][:, 3:], 1e-5)
    np.testing.assert_allclose(conf, want[4], atol=1e-6)


def test_enough_gate(kp_weights):
    """Fewer valid rows than dense inputs: nothing found, on both sides
    (the same net finds keypoints in a full crop, above)."""
    jeng, peng = _kp_pair(kp_weights)
    got, want = _kp_both(jeng, peng, *_crop(valid_rows=(ND - 1, 64)))
    assert not got[3].any() and not want[3].any()
    assert not got[1].any()
    np.testing.assert_allclose(got[4], want[4], atol=1e-6)


@pytest.fixture(scope="module")
def app_engines():
    jeng = JaxEngine(JaxConfig(k3_self_keyed=False, **APP_CFG), seed=0)
    peng = InferenceEngine(InferenceConfig(**APP_CFG), device="cpu")
    peng.load_jax_params(jax.device_get(jeng.params))
    return jeng, peng


def test_predict_matches_jax(app_engines):
    jeng, peng = app_engines
    s = generate_sample(seed=3, n_ee=700, n_arm=900, n_bg=1200)
    kw = dict(points=s["points"], rgb=s["rgb"],
              ee2base_pose=s["ee2base_pose"])
    want = jeng.predict(JaxCloud(**kw))
    got = peng.predict(PointCloudDTO(**kw))
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert (got.ee_pose is None) == (want.ee_pose is None)
    assert [k for k, _ in got.key_points] == [k for k, _ in want.key_points]
    for (_, g), (_, w) in zip(got.key_points, want.key_points):
        np.testing.assert_array_equal(g, w)
    for name in ("ee_pose", "key_points_pose", "base_pose"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g[:3], w[:3], atol=1e-3)
            _quat_close(np.asarray(g[3:]), np.asarray(w[3:]), 1e-3)
    assert got.is_confident == want.is_confident
    assert got.ee_pose is not None, "the frame's EE crop was not reached"


def test_int8_engine_with_dense_keypoints():
    cfg = InferenceConfig(
        point_capacity=2048, seg_voxel_capacity=1024,
        seg_hierarchy_caps=(512, 256, 128, 128), ee_point_capacity=1024,
        ee_voxel_capacity=512, seg_backbone="minkunet14A",
        rot_backbone="minkunet14A", kp_backbone="pointnet2",
        conv_impl="pallas-int8", num_of_dense_input_points=256,
        icp_iterations=2, icp_template_points=128)
    assert q8_stages(cfg) == ("seg",)
    eng = InferenceEngine(cfg, device="cpu")
    batch = build_batch(2, 2048, seed=11)
    eng.calibrate_q8(*batch)
    assert all(conv.act_absmax is not None
               for conv in eng.seg_model.modules()
               if hasattr(conv, "act_absmax") and hasattr(conv, "q8"))
    out = eng.predict_batch_arrays(*batch)
    assert out["kp_found"].shape == (2, 6)
    assert torch.isfinite(out["kp_pose"]).all()
    assert torch.isfinite(out["ee_pose"]).all()


def test_kp_checkpoint_formats(kp_weights, tmp_path):
    state = TrainState(params=kp_weights["params"],
                       batch_stats=kp_weights["batch_stats"],
                       opt_state=optax.adamw(1e-3).init(kp_weights["params"]))
    msgpack = jax_checkpoint_save(state, str(tmp_path / "jax"), "kp", 3)
    want = load_jax_variables(
        InferenceEngine(InferenceConfig(**KP_CFG), device="cpu").kp_model,
        kp_weights).state_dict()
    eng = InferenceEngine(InferenceConfig(**KP_CFG, kp_checkpoint=msgpack),
                          device="cpu")
    got = eng.kp_model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = eng.kp_model
    ckpt = checkpoint_save(model, torch.optim.AdamW(model.parameters()),
                           str(tmp_path / "port"), "kp", 2)
    eng2 = InferenceEngine(InferenceConfig(**KP_CFG, kp_checkpoint=ckpt),
                           device="cpu", seed=9)
    assert all(torch.equal(eng2.kp_model.state_dict()[k], want[k])
               for k in want)
    pth = tmp_path / "pointnet2.pth"
    torch.save({"model_state_dict": {
        "sa1.mlp_convs.0.weight": torch.zeros(32, 9, 1, 1)}}, pth)
    with pytest.raises(KeyError):
        InferenceEngine(InferenceConfig(**KP_CFG, kp_checkpoint=str(pth)),
                        device="cpu")
