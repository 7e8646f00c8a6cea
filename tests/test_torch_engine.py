"""Port engine vs the JAX engine, stage by stage and whole (CPU, f32).

One JAX engine (minkunet14A everywhere, f32 compute, P = 1024) and one
port engine on ``device="cpu"`` share weights through ``load_jax_params``.
Each port stage takes the JAX stage's inputs; pose, keypoint and ICP
stages get an EE crop from the scenes' ground-truth labels so that they
see a real EE.  Integer outputs are exact; poses agree to 1e-4 before ICP
and 1e-3 after it (15 SVD iterations); quaternions compare up to sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.geometry import kabsch as jax_kabsch_mod
from mrcc_tpu.geometry.preprocess import normalize_colors as jax_normalize
from mrcc_tpu.geometry.transform import matrix_to_quat as jax_matrix_to_quat
from mrcc_tpu.solve import key_point_predictions as jax_key_point_predictions
from mrcc_tpu.solve import largest_cluster_mask as jax_cluster
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.geometry import kabsch, matrix_to_quat
from mrcc_tpu_torch.solve import key_point_predictions, largest_cluster_mask

P, E = 1024, 512
CFG = dict(point_capacity=P, seg_voxel_capacity=768, ee_point_capacity=E,
           ee_voxel_capacity=512, kp_voxel_capacity=512,
           seg_hierarchy_caps=(512, 256, 128, 64),
           ee_hierarchy_caps=(256, 128, 64, 64),
           kp_hierarchy_caps=(384, 256, 128, 64),
           seg_backbone="minkunet14A", rot_backbone="minkunet14A",
           kp_backbone="minkunet14A", icp_iterations=15,
           icp_template_points=256, compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _quat_close(a, b, atol):
    a, b = _n(a), _n(b)
    d = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))
    assert d.max() <= atol, d


def _pose_close(a, b, atol):
    np.testing.assert_allclose(_n(a)[..., :3], _n(b)[..., :3], atol=atol)
    _quat_close(_n(a)[..., 3:], _n(b)[..., 3:], atol)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxConfig(k3_self_keyed=False, **CFG), seed=0)
    peng = InferenceEngine(InferenceConfig(**CFG), device="cpu")
    peng.load_jax_params(jax.device_get(jeng.params))
    return jeng, peng


@pytest.fixture(scope="module")
def scenes():
    """B = 2 scenes padded to P, with labels for a ground-truth EE crop."""
    pts = np.zeros((2, P, 3), np.float32)
    rgb = np.zeros((2, P, 3), np.float32)
    mask = np.zeros((2, P), bool)
    labels = np.zeros((2, P), np.int32)
    gt = np.zeros((2, 7), np.float32)
    for i in range(2):
        s = generate_sample(seed=20 + i, n_ee=300, n_arm=300, n_bg=380)
        n = len(s["points"])
        pts[i, :n], rgb[i, :n], mask[i, :n] = s["points"], s["rgb"], True
        labels[i, :n] = s["labels"]
        q = s["pose"][3:]  # XYZW
        gt[i] = np.concatenate([s["pose"][:3], q[3:], q[:3]])
    nrgb = np.asarray(jax_normalize(jnp.asarray(rgb), mask=jnp.asarray(mask)))
    order = np.argsort(~((labels == 2) & mask), axis=1, kind="stable")[:, :E]
    take = lambda a: np.take_along_axis(a, order[..., None], 1)  # noqa: E731
    crop = (take(pts), take(nrgb),
            np.take_along_axis((labels == 2) & mask, order, 1))
    return pts, rgb, mask, crop, gt


# ----------------------------------------------------------- geometry


def test_kabsch_planar_and_mirrored():
    rng = np.random.default_rng(0)
    planar = np.concatenate([rng.normal(size=(12, 2)), np.zeros((12, 1))], 1)
    for ref in (planar.astype(np.float32),
                rng.normal(size=(10, 3)).astype(np.float32)):
        for mirror in (False, True):
            tgt = ref @ np.diag([1, 1, -1 if mirror else 1]) + 0.3
            tgt = tgt.astype(np.float32)
            r_j, t_j = jax_kabsch_mod.kabsch(jnp.asarray(ref),
                                             jnp.asarray(tgt))
            r, t = kabsch(_t(ref), _t(tgt))
            assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5
            np.testing.assert_allclose(r.numpy(), np.asarray(r_j), atol=1e-5)
            np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-5)


def test_matrix_to_quat_shepperd_branches():
    """Near each of the four pivots: w, x, y, z dominant."""
    def rot(axis, ang):
        a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k

    mats = [rot([1, 2, 3], 0.2), rot([1, 0.01, 0.02], 3.1),
            rot([0.02, 1, 0.01], 3.1), rot([0.01, 0.03, 1], 3.1),
            rot([1, 1, 0], np.pi)]
    m = np.stack(mats).astype(np.float32)
    _quat_close(matrix_to_quat(_t(m)), jax_matrix_to_quat(jnp.asarray(m)),
                1e-6)


def test_largest_cluster_mask_exact():
    rng = np.random.default_rng(3)
    b, p = 3, 600
    blobs = [rng.normal(size=(p // 3, 3)) * s + c for s, c in
             ((0.02, 0.0), (0.03, 0.5), (0.01, -0.4))]
    pts = np.stack([np.concatenate(blobs)[rng.permutation(p)]
                    for _ in range(b)]).astype(np.float32)
    mask = rng.random((b, p)) > 0.2
    want = jax.vmap(lambda x, m: jax_cluster(x, m, dist=0.06, capacity=400))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = largest_cluster_mask(_t(pts), _t(mask), dist=0.06, capacity=400)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def test_key_point_predictions_ties_take_the_first_point():
    """Points of one voxel share their logits: exact ties everywhere."""
    rng = np.random.default_rng(4)
    voxel_logits = rng.normal(size=(2, 12, 6)).astype(np.float32) * 3
    pv = rng.integers(0, 12, size=(2, 80))           # point -> voxel
    logits = np.take_along_axis(voxel_logits, pv[..., None], 1)
    mask = rng.random((2, 80)) > 0.2
    want = jax.vmap(jax_key_point_predictions)(jnp.asarray(logits),
                                               jnp.asarray(mask))
    got = key_point_predictions(_t(logits), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    probs = np.where(mask[..., None], torch.softmax(_t(logits), -1).numpy(),
                     -1.0)
    first = np.argmax(probs, axis=1)                  # numpy: first maximum
    np.testing.assert_array_equal(got[0].numpy(), first)
    assert (np.sum(probs == probs.max(1, keepdims=True), 1) > 1).any()


# ------------------------------------------------------------- stages


def test_seg_stage(engines, scenes):
    jeng, peng = engines
    pts, rgb, mask = scenes[:3]
    want = jeng._seg_jit(jeng.params["segmentation"], pts, rgb, mask)
    got = peng.seg_stage(_t(pts), _t(rgb), _t(mask))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pose_kp_icp_stages_on_gt_crop(engines, scenes):
    jeng, peng = engines
    ee_pts, ee_rgb, ee_valid = scenes[3]
    j_pose, j_conf = jeng._pose_jit(jeng.params["rotation"], ee_pts, ee_rgb,
                                    ee_valid)
    pose, conf = peng.pose_stage(_t(ee_pts), _t(ee_rgb), _t(ee_valid))
    _pose_close(pose, j_pose, 1e-4)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(j_conf))

    j_kp = jeng._kp_jit(jeng.params["key_points"], ee_pts, ee_rgb, ee_valid)
    kp = peng.kp_stage(_t(ee_pts), _t(ee_rgb), _t(ee_valid))
    _pose_close(kp[0], j_kp[0], 1e-4)
    for i in (1, 3):  # kp_ok, kp_found
        np.testing.assert_array_equal(kp[i].numpy(), np.asarray(j_kp[i]))
    np.testing.assert_array_equal(kp[2].numpy(), np.asarray(j_kp[2]))
    np.testing.assert_allclose(kp[4].numpy(), np.asarray(j_kp[4]), atol=1e-5)

    # ICP from perturbed ground-truth seeds (it converges there; from an
    # arbitrary seed one nearest-neighbour near-tie decided by the last bit
    # of an SVD sends the two runs down different paths)
    noise = np.random.default_rng(3).normal(size=(2, 2, 7)).astype(np.float32)
    seeds = scenes[4] + noise * np.array([0.01] * 3 + [0.02] * 4, np.float32)
    seeds[..., 3:] /= np.linalg.norm(seeds[..., 3:], axis=-1, keepdims=True)
    j_icp = jeng._icp_jit(jeng.template, ee_pts, ee_valid, *seeds)
    icp = peng.icp_stage(_t(ee_pts), _t(ee_valid), _t(seeds[0]),
                         _t(seeds[1]))
    for g, w in zip(icp, j_icp):
        _pose_close(g, w, 1e-3)


@pytest.mark.parametrize("icp", [False, True])
def test_predict_batch_arrays(engines, scenes, icp):
    jeng, peng = engines
    pts, rgb, mask = scenes[:3]
    try:  # both engines read icp_enabled at call time
        jeng.cfg.icp_enabled = peng.cfg.icp_enabled = icp
        want = jax.device_get(jeng.predict_batch_arrays(pts, rgb, mask))
        got = peng.predict_batch_arrays(pts, rgb, mask)
    finally:
        jeng.cfg.icp_enabled = peng.cfg.icp_enabled = True
    assert set(got) == set(want)
    for k in ("segmentation", "seg_overflow", "ee_count", "kp_found",
              "kp_ok"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("ee_pose", "kp_pose"):
        _pose_close(got[k], want[k], 1e-3 if icp else 1e-4)
    np.testing.assert_allclose(got["kp_conf"].numpy(), want["kp_conf"],
                               atol=1e-5)
    np.testing.assert_allclose(got["kp_coords"].numpy(), want["kp_coords"],
                               atol=1e-6)
    assert int(got["ee_count"].sum()) > 0
