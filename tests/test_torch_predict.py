"""The port's host entry points and opt-in heads vs the JAX engine (CPU,
f32, minkunet14A, the ``CFG`` of ``tests/test_torch_engine.py``).

One JAX engine with the 6D rotation head, the confidence heads, the 2nd
percentile translation and flip disambiguation, and one port engine given
its weights through ``load_jax_params``:

- (a) ``predict`` on frames of 1700 points, over the point capacity of
  1024, so that ``_pad`` subsamples and the labels are scattered back:
  labels exact, keypoint classes exact and coordinates 1e-6, ``ee_pose``,
  ``key_points_pose`` and ``base_pose`` 1e-3 (after 15 ICP iterations),
  ``is_confident`` equal.  The JAX engine's ``predict`` runs its CPU-staged
  branch, whose flip inputs differ from the fused program's (ROADMAP C1),
  so both engines predict here with the flip off.  The sanity thresholds
  are lowered so that ``check_sanity`` reaches ``get_6_key_points``.
- (b) ``check_sanity``, ``calibrate`` and ``_calibrate_individual`` on
  hand-built results, with and without ``camera_link_transformation_pose``
  and weights: poses 1e-4, None where the JAX engine gives None.
- (c) ``pose_stage`` against ``_pose_jit`` on a ground-truth EE crop: poses
  1e-4, confidences 1e-5.
- (d) ``predict_batch_arrays`` with the flip on and ICP off against the JAX
  engine's fused program ``_full_jit`` itself (it compiles in ~10 s on the
  CPU at this size): poses 1e-4, integer outputs exact; the weights flip
  one of the two items.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.app import PointCloudDTO as JaxCloud
from mrcc_tpu.app import ResultDTO as JaxResult
from mrcc_tpu.data.labels import get_6_key_points as jax_6_key_points
from mrcc_tpu.data.synthetic import generate_sample, gt_base2cam_pose
from mrcc_tpu.geometry.preprocess import normalize_colors as jax_normalize
from mrcc_tpu_torch.app import (InferenceConfig, InferenceEngine,
                                PointCloudDTO, ResultDTO)
from mrcc_tpu_torch.app import inference_engine as engine_module


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


P, E = 1024, 512
CFG = dict(point_capacity=P, seg_voxel_capacity=768, ee_point_capacity=E,
           ee_voxel_capacity=512, kp_voxel_capacity=512,
           seg_hierarchy_caps=(512, 256, 128, 64),
           ee_hierarchy_caps=(256, 128, 64, 64),
           kp_hierarchy_caps=(384, 256, 128, 64),
           seg_backbone="minkunet14A", rot_backbone="minkunet14A",
           kp_backbone="minkunet14A", icp_iterations=15,
           icp_template_points=256, compute_dtype="float32")
HEADS = dict(rot_6d=True, compute_confidence=True,
             translation_z_percentile=2.0, rot_flip_disambiguation=True,
             ee_point_counts_threshold=32, sanity_min_num_of_ee_points=32)


def _n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _quat_close(a, b, atol):
    a, b = _n(a), _n(b)
    d = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))
    assert d.max() <= atol, d


def _pose_close(a, b, atol):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    np.testing.assert_allclose(_n(a)[..., :3], _n(b)[..., :3], atol=atol)
    _quat_close(_n(a)[..., 3:], _n(b)[..., 3:], atol)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxConfig(k3_self_keyed=False, **CFG, **HEADS), seed=0)
    peng = InferenceEngine(InferenceConfig(**CFG, **HEADS), device="cpu")
    peng.load_jax_params(jax.device_get(jeng.params))
    return jeng, peng


def _frame(seed):
    s = generate_sample(seed=seed, n_ee=500, n_arm=500, n_bg=700)
    return s, dict(points=s["points"], rgb=s["rgb"],
                   ee2base_pose=s["ee2base_pose"])


# ------------------------------------------------------------ (a) predict


@pytest.mark.parametrize("seed", [7, 8])
def test_predict_subsampled_frame(engines, seed, monkeypatch):
    jeng, peng = engines
    s, kw = _frame(seed)
    assert len(s["points"]) > P
    calls, labeller = [], engine_module.get_6_key_points
    monkeypatch.setattr(engine_module, "get_6_key_points",
                        lambda *a, **k: calls.append(1) or labeller(*a, **k))
    try:
        jeng.cfg.rot_flip_disambiguation = False
        peng.cfg.rot_flip_disambiguation = False
        want = jeng.predict(JaxCloud(**kw))
        got = peng.predict(PointCloudDTO(**kw))
    finally:
        jeng.cfg.rot_flip_disambiguation = True
        peng.cfg.rot_flip_disambiguation = True
    assert got.segmentation.shape == (len(s["points"]),)
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert got.ee_pose is not None and calls, "check_sanity was not reached"
    assert [k for k, _ in got.key_points] == [k for k, _ in want.key_points]
    for (_, g), (_, w) in zip(got.key_points, want.key_points):
        np.testing.assert_allclose(g, w, atol=1e-6)
    for k in ("ee_pose", "key_points_pose", "base_pose",
              "key_points_base_pose"):
        _pose_close(getattr(got, k), getattr(want, k), 1e-3)
    assert got.is_confident == want.is_confident
    np.testing.assert_allclose(got.confidence, want.confidence, atol=1e-5)


def test_predict_without_networks():
    eng = InferenceEngine(InferenceConfig(), device="cpu",
                          calibration_only=True)
    s, kw = _frame(3)
    result = eng.predict(PointCloudDTO(**kw))
    assert (result.segmentation == 0).all()
    assert result.segmentation.shape == (len(s["points"]),)
    assert result.ee_pose is None


# ------------------------------------------------- (b) sanity, calibrate


def _sanity_case(case):
    """A frame with ground-truth labels and pose, and keypoints from the
    pose: ``ok`` passes, the others fail one gate each."""
    s = generate_sample(seed=12, n_ee=900, n_arm=300, n_bg=300)
    seg = s["labels"].astype(np.int32)
    q = s["pose"][3:]
    pose = np.concatenate([s["pose"][:3], q[3:], q[:3]]).astype(np.float32)
    coords, idx = jax_6_key_points(s["points"][seg == 2], pose,
                                   euclidean_threshold=0.04)
    kps = [(k, coords[k].astype(np.float32)) for k in range(6) if idx[k] >= 0]
    assert len(kps) > 3
    if case == "kp_error":
        kps = [(k, c + 0.08) for k, c in kps]
    elif case == "three_kps":
        kps = [(k, c + 0.08) for k, c in kps[:3]]
    elif case == "no_pose":
        pose = None
    elif case == "wrong_pose":                  # the face is not in view
        pose = pose.copy()
        pose[:3] += 1.0
    cloud = dict(points=s["points"], rgb=s["rgb"])
    res = dict(segmentation=seg, ee_pose=pose, key_points=kps)
    return cloud, res


@pytest.mark.parametrize("case", ["ok", "kp_error", "three_kps", "no_pose",
                                  "wrong_pose", "few_ee"])
def test_check_sanity(case):
    min_ee = 10 ** 6 if case == "few_ee" else 256
    jeng = JaxEngine(JaxConfig(sanity_min_num_of_ee_points=min_ee),
                     calibration_only=True)
    peng = InferenceEngine(InferenceConfig(sanity_min_num_of_ee_points=min_ee),
                           device="cpu", calibration_only=True)
    cloud, res = _sanity_case(case)
    want = jeng.check_sanity(JaxCloud(**cloud), JaxResult(**res))
    got = peng.check_sanity(PointCloudDTO(**cloud), ResultDTO(**res))
    assert got == want
    assert got == (case in ("ok", "three_kps"))


def _results(result_cls, seed=0):
    """3 positions x 4 frames around the true extrinsic, some frames not
    confident or without a keypoint pose (``tests/test_app.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    want = gt_base2cam_pose().astype(np.float32)
    want_q = want[3:] / np.linalg.norm(want[3:])
    data = {}
    for pos in ("p1", "p2", "p3"):
        results = []
        for i in range(4):
            r = result_cls(segmentation=None, is_confident=i != 3)
            noise = np.concatenate([rng.normal(size=3) * 0.003,
                                    rng.normal(size=4) * 0.002])
            r.ee_pose = (np.concatenate([rng.normal(size=3) * 0.1, want_q])
                         + noise).astype(np.float32)
            r.base_pose = (np.concatenate([want[:3], want_q])
                           + noise).astype(np.float32)
            if i != 1:
                r.key_points_pose = r.ee_pose + 0.001
                r.key_points_base_pose = np.concatenate(  # q = -q
                    [r.base_pose[:3] + 0.001, -r.base_pose[3:]])
            results.append(r)
        data[pos] = results
    return data, np.concatenate([want[:3], want_q])


CLT = np.array([0.01, -0.02, 0.03, 0.5, 0.5, -0.5, 0.5], np.float32)


@pytest.mark.parametrize("camera_link", [False, True])
def test_calibrate(camera_link):
    kw = dict(camera_link_transformation_pose=CLT if camera_link else None)
    jeng = JaxEngine(JaxConfig(**kw), calibration_only=True)
    peng = InferenceEngine(InferenceConfig(**kw), device="cpu",
                           calibration_only=True)
    jdata, truth = _results(JaxResult)
    pdata, _ = _results(ResultDTO)
    want = jeng.calibrate(jdata)
    got = peng.calibrate(pdata)
    for k in ("pose_camera_link", "ee_pose", "base_pose", "key_points_pose",
              "key_points_base_pose", "base_pose_camera_link",
              "key_points_base_pose_camera_link"):
        _pose_close(getattr(got, k), getattr(want, k), 1e-4)
    assert (got.base_pose_camera_link is not None) == camera_link
    np.testing.assert_allclose(got.pose_camera_link[:3], truth[:3],
                               atol=0.01)
    _quat_close(got.pose_camera_link[3:], truth[3:], 0.01)
    one = {"p1": pdata["p1"]}
    _pose_close(peng.calibrate(one).pose_camera_link,
                jeng.calibrate({"p1": jdata["p1"]}).pose_camera_link, 1e-4)


@pytest.mark.parametrize("case", ["weights", "bad_weights", "count",
                                  "too_few", "unconfident"])
def test_calibrate_individual(case):
    jeng = JaxEngine(JaxConfig(camera_link_transformation_pose=CLT),
                     calibration_only=True)
    peng = InferenceEngine(InferenceConfig(camera_link_transformation_pose=CLT),
                           device="cpu", calibration_only=True)
    jdata, _ = _results(JaxResult, seed=1)
    pdata, _ = _results(ResultDTO, seed=1)
    jrows = jdata["p1"] + jdata["p2"]
    prows = pdata["p1"] + pdata["p2"]
    weights = {"weights": np.linspace(0.5, 1.5, 6),
               "bad_weights": np.ones(3)}.get(case)
    kw = dict(weights=weights,
              confident_count={"count": 6, "too_few": 7}.get(case))
    if case == "unconfident":
        for r in jrows + prows:
            r.is_confident = False
    want = jeng._calibrate_individual(jrows, **kw)
    got = peng._calibrate_individual(prows, **kw)
    if want is None:
        assert got is None
        return
    for k in ("ee_pose", "base_pose", "key_points_pose",
              "key_points_base_pose", "base_pose_camera_link",
              "key_points_base_pose_camera_link"):
        _pose_close(getattr(got, k), getattr(want, k), 1e-4)
    assert got.is_confident


def test_calibrate_unconfident_gives_no_pose():
    peng = InferenceEngine(InferenceConfig(), device="cpu",
                           calibration_only=True)
    r = ResultDTO(segmentation=None, is_confident=False)
    assert peng.calibrate({"p1": [r, r]}).pose_camera_link is None
    assert peng.calibrate({"p1": [r], "p2": [r]}).pose_camera_link is None


# ------------------------------------------------ (c) 6D and confidence


@pytest.fixture(scope="module")
def scenes():
    """B = 2 scenes padded to P, and the ground-truth EE crops."""
    pts = np.zeros((2, P, 3), np.float32)
    rgb = np.zeros((2, P, 3), np.float32)
    mask = np.zeros((2, P), bool)
    labels = np.zeros((2, P), np.int32)
    for i in range(2):
        s = generate_sample(seed=20 + i, n_ee=300, n_arm=300, n_bg=380)
        n = len(s["points"])
        pts[i, :n], rgb[i, :n], mask[i, :n] = s["points"], s["rgb"], True
        labels[i, :n] = s["labels"]
    nrgb = np.asarray(jax_normalize(jnp.asarray(rgb), mask=jnp.asarray(mask)))
    order = np.argsort(~((labels == 2) & mask), axis=1, kind="stable")[:, :E]
    take = lambda a: np.take_along_axis(a, order[..., None], 1)  # noqa: E731
    crop = (take(pts), take(nrgb),
            np.take_along_axis((labels == 2) & mask, order, 1))
    return pts, rgb, mask, crop


def test_pose_stage_6d_and_confidence(engines, scenes):
    jeng, peng = engines
    crop = scenes[3]
    j_pose, j_conf = jeng._pose_jit(jeng.params["rotation"], *crop)
    pose, conf = peng.pose_stage(*(torch.from_numpy(c) for c in crop))
    _pose_close(pose, j_pose, 1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(j_conf), atol=1e-5)
    assert peng.rot_model.pose_regression[2].out_features == 12
    assert not np.allclose(conf.numpy(), 1.0)


# ------------------------------------------------------- (d) the flip


def test_flip_against_the_fused_program(engines, scenes):
    jeng, peng = engines
    pts, rgb, mask = scenes[:3]
    try:
        jeng.cfg.icp_enabled = peng.cfg.icp_enabled = False
        want = jax.device_get(jeng._full_jit(
            {"params": jeng.params, "template": jeng.template},
            pts, rgb, mask))
        got = peng.predict_batch_arrays(pts, rgb, mask)
        off = dataclasses.replace(peng.cfg, rot_flip_disambiguation=False)
        peng.cfg, on = off, peng.cfg
        unflipped = peng.predict_batch_arrays(pts, rgb, mask)
        peng.cfg = on
    finally:
        jeng.cfg.icp_enabled = peng.cfg.icp_enabled = True
    assert set(got) == set(want)
    for k in ("segmentation", "seg_overflow", "ee_count", "kp_found",
              "kp_ok"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("ee_pose", "kp_pose"):
        _pose_close(got[k], want[k], 1e-4)
    np.testing.assert_allclose(got["rot_conf"].numpy(), want["rot_conf"],
                               atol=1e-5)
    # the flip stage ran on the network pose and nothing else; these
    # weights flip one item and keep the other
    _pose_close(got["kp_pose"], unflipped["kp_pose"], 0.0)
    flipped = (got["ee_pose"] != unflipped["ee_pose"]).any(-1).tolist()
    assert flipped == [True, False]
