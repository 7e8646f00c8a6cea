"""The port's pose algebra, metrics, calibration averaging, keypoint labels,
percentile translation and flip disambiguation vs the JAX package (CPU,
f32).

Seeded numpy inputs go to both packages.  Values agree to 1e-5 and angles
to 1e-3 degrees; booleans, indices and ``get_6_key_points``' ``point_idx``
are exactly equal.  Quaternions from an eigensolver compare up to sign
(q = -q).  The JAX functions that take one item (``predict_translation``,
``disambiguate_flip``, ``compute_pose_metrics``) run under ``jax.vmap``
against the port's batched ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.data import labels as jax_labels
from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.geometry import calibration as jax_calib
from mrcc_tpu.geometry import metrics as jax_metrics
from mrcc_tpu.geometry import quaternion as jax_quat
from mrcc_tpu.geometry import transform as jax_tf
from mrcc_tpu.solve import symmetry as jax_sym
from mrcc_tpu.solve.translation import predict_translation as jax_translation
from mrcc_tpu_torch.data import labels
from mrcc_tpu_torch.geometry import calibration as calib
from mrcc_tpu_torch.geometry import metrics, quaternion, transform
from mrcc_tpu_torch.solve import disambiguate_flip, predict_translation
from mrcc_tpu_torch.solve.symmetry import _quat_angle


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


TOL = 1e-5
ANGLE_TOL = np.deg2rad(1e-3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol)


def _quat_close(got, want, atol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    d = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
    assert np.max(d) <= atol, d


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n, spread=0.3):
    return np.concatenate([rng.normal(size=(n, 3)) * spread,
                           _unit(rng.normal(size=(n, 4)))],
                          -1).astype(np.float32)


# --------------------------------------------------------- quaternion


@pytest.mark.parametrize("name", ["xyzw_to_wxyz", "wxyz_to_xyzw", "qnormalize",
                                  "qfix", "expmap_to_quat"])
def test_quaternion_unary(name):
    rng = np.random.default_rng(1)
    if name == "qfix":
        x = _unit(rng.normal(size=(9, 3, 4)))
    elif name == "expmap_to_quat":
        x = rng.normal(size=(12, 3))
        x[0] = 0.0  # the sinc's removable singularity
    else:
        x = rng.normal(size=(12, 4)) * rng.uniform(0.5, 2.0, (12, 1))
    x = x.astype(np.float32)
    want = getattr(jax_quat, name)(jnp.asarray(x))
    got = getattr(quaternion, name)(_t(x))
    _close(got.numpy(), want)


def test_switch_pose_w():
    x = np.random.default_rng(2).normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(quaternion.switch_pose_w(_t(x)).numpy(),
                                  np.asarray(jax_quat.switch_pose_w(x)))


@pytest.mark.parametrize("name", ["qmul", "qangle"])
def test_quaternion_binary(name):
    rng = np.random.default_rng(3)
    a = _unit(rng.normal(size=(16, 4))).astype(np.float32)
    b = _unit(rng.normal(size=(16, 4))).astype(np.float32)
    b[0] = -a[0]  # the same rotation: angle 0
    want = getattr(jax_quat, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(quaternion, name)(_t(a), _t(b))
    _close(got.numpy(), want, ANGLE_TOL if name == "qangle" else TOL)


def test_qrot_broadcasts():
    rng = np.random.default_rng(4)
    q = _unit(rng.normal(size=(6, 1, 4))).astype(np.float32)
    v = rng.normal(size=(6, 10, 3)).astype(np.float32)
    _close(quaternion.qrot(_t(q), _t(v)).numpy(),
           jax_quat.qrot(jnp.asarray(q), jnp.asarray(v)))
    one = q[0, 0]
    _close(quaternion.qrot(_t(one), _t(v[0])).numpy(),
           jax_quat.qrot(jnp.asarray(one), jnp.asarray(v[0])))


@pytest.mark.parametrize("order", ["xyz", "yzx", "zxy", "xzy", "yxz", "zyx"])
def test_euler_to_quat_and_back(order):
    e = np.random.default_rng(5).uniform(-1.2, 1.2, (10, 3)).astype(
        np.float32)
    want = jax_quat.euler_to_quat(jnp.asarray(e), order=order)
    got = quaternion.euler_to_quat(_t(e), order=order)
    _close(got.numpy(), want)
    _close(quaternion.qeuler(got, order=order).numpy(),
           jax_quat.qeuler(want, order=order), ANGLE_TOL)


# ---------------------------------------------------------- transform


@pytest.mark.parametrize("name", ["pose_inverse", "pose_to_matrix"])
def test_pose_unary(name):
    x = _poses(np.random.default_rng(6), 8)
    want = getattr(jax_tf, name)(jnp.asarray(x))
    got = getattr(transform, name)(_t(x))
    if name == "pose_inverse":
        _close(got[:, :3].numpy(), np.asarray(want)[:, :3])
        _quat_close(got[:, 3:].numpy(), np.asarray(want)[:, 3:])
    else:
        _close(got.numpy(), want)


def test_matrix_inverse_rigid():
    m = np.asarray(jax_tf.pose_to_matrix(_poses(np.random.default_rng(7), 5)))
    _close(transform.matrix_inverse_rigid(_t(m)).numpy(),
           jax_tf.matrix_inverse_rigid(jnp.asarray(m)))
    _close((transform.matrix_inverse_rigid(_t(m)) @ _t(m)).numpy(),
           np.broadcast_to(np.eye(4), m.shape))


@pytest.mark.parametrize("name", ["base2cam_matrix", "base2cam_pose",
                                  "transform_pose2pose"])
def test_pose_binary(name):
    rng = np.random.default_rng(8)
    a, b = _poses(rng, 8), _poses(rng, 8)
    want = np.asarray(getattr(jax_tf, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(transform, name)(_t(a), _t(b)).numpy()
    if name == "base2cam_matrix":
        _close(got, want)
    else:
        _close(got[:, :3], want[:, :3])
        _quat_close(got[:, 3:], want[:, 3:])


@pytest.mark.parametrize("name", ["transform_points",
                                  "inverse_transform_points"])
def test_transform_points(name):
    rng = np.random.default_rng(9)
    pose = _poses(rng, 3)
    pts = rng.normal(size=(3, 20, 3)).astype(np.float32)
    want = getattr(jax_tf, name)(jnp.asarray(pose), jnp.asarray(pts))
    _close(getattr(transform, name)(_t(pose), _t(pts)).numpy(), want)
    back = transform.inverse_transform_points(
        _t(pose), transform.transform_points(_t(pose), _t(pts)))
    _close(back.numpy(), pts)


def test_dists_to_line():
    rng = np.random.default_rng(10)
    p = rng.normal(size=(4, 30, 3)).astype(np.float32)
    a = rng.normal(size=(4, 1, 3)).astype(np.float32)
    b = rng.normal(size=(4, 1, 3)).astype(np.float32)
    _close(transform.dists_to_line(_t(p), _t(a), _t(b)).numpy(),
           jax_tf.dists_to_line(p, a, b))


# ------------------------------------------------------------ metrics


def test_compute_pose_metrics():
    rng = np.random.default_rng(11)
    gt, pred = _poses(rng, 12), _poses(rng, 12)
    pred[0, 3:] = -gt[0, 3:]                  # same rotation, other sign
    pred[1, 3:] = gt[1, 3:] * 3.0             # unnormalised
    want = jax.vmap(jax_metrics.compute_pose_metrics)(jnp.asarray(gt),
                                                      jnp.asarray(pred))
    got = metrics.compute_pose_metrics(_t(gt), _t(pred))
    _close(got["dist_position"].numpy(), want["dist_position"])
    _close(got["angle_diff"].numpy(), want["angle_diff"], ANGLE_TOL)
    one = metrics.compute_pose_metrics(_t(gt[2]), _t(pred[2]))
    _close(one["angle_diff"].numpy(), want["angle_diff"][2], ANGLE_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_compute_segmentation_metrics(masked):
    rng = np.random.default_rng(12)
    gt = rng.integers(0, 3, (2, 300))
    pred = np.where(rng.random((2, 300)) < 0.7, gt,
                    rng.integers(0, 3, (2, 300)))
    pred[pred == 1] = 0                        # class 1 never predicted
    mask = rng.random((2, 300)) > 0.3 if masked else None
    want = jax_metrics.compute_segmentation_metrics(
        jnp.asarray(gt), jnp.asarray(pred),
        mask=None if mask is None else jnp.asarray(mask))
    got = metrics.compute_segmentation_metrics(
        _t(gt), _t(pred), mask=None if mask is None else _t(mask))
    for k in ("accuracy", "precision", "recall"):
        _close(float(got[k]), float(want[k]))
        for cn, per in want["class_results"].items():
            _close(float(got["class_results"][cn][k]), float(per[k]))


def test_compute_kp_error_and_add():
    rng = np.random.default_rng(13)
    gt = rng.normal(size=(6, 3)).astype(np.float32)
    cls = np.array([4, 0, 2, 5])
    kp = (gt[cls] + rng.normal(size=(4, 3)) * 0.01).astype(np.float32)
    _close(float(metrics.compute_kp_error(_t(gt), _t(kp), _t(cls))),
           float(jax_metrics.compute_kp_error(gt, kp, cls)))
    pts = rng.normal(size=(50, 3)).astype(np.float32) * 0.1
    a, b = _poses(rng, 5), _poses(rng, 5)
    _close(metrics.compute_add(_t(pts), _t(a), _t(b)).numpy(),
           jax_metrics.compute_add(pts, a, b))


@pytest.mark.parametrize("unit", [True, False])
def test_rotational_and_translational_diff(unit):
    rng = np.random.default_rng(14)
    a, b = _poses(rng, 10), _poses(rng, 10)
    b[0, 3:] = a[0, 3:]
    want = jax_metrics.rotational_diff(jnp.asarray(a[:, 3:]),
                                       jnp.asarray(b[:, 3:]), degree=unit)
    got = metrics.rotational_diff(_t(a[:, 3:]), _t(b[:, 3:]), degree=unit)
    _close(got.numpy(), want, 1e-3 if unit else ANGLE_TOL)
    _close(metrics.translational_diff(_t(a[:, :3]), _t(b[:, :3]),
                                      cm=unit).numpy(),
           jax_metrics.translational_diff(a[:, :3], b[:, :3], cm=unit),
           1e-4 if unit else TOL)


# -------------------------------------------------------- calibration


@pytest.mark.parametrize("n", [7, 8])
def test_mad_outliers_odd_and_even(n):
    rng = np.random.default_rng(15)
    y = rng.normal(size=n).astype(np.float32)
    y[2] += 9.0
    want = np.asarray(jax_calib.mad_outliers(jnp.asarray(y)))
    got = calib.mad_outliers(_t(y)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2]
    flat = np.full(n, 0.5, np.float32)          # zero MAD: no outliers
    assert not calib.mad_outliers(_t(flat)).any()


def test_pose_outliers_and_remove_planted():
    rng = np.random.default_rng(16)
    base = _poses(rng, 1)[0]
    poses = np.repeat(base[None], 12, 0)
    poses[:, :3] += rng.normal(size=(12, 3)) * 0.003
    poses[:, 3:] = _unit(poses[:, 3:] + rng.normal(size=(12, 4)) * 0.003)
    poses[3, 0] += 0.5                          # a position outlier
    poses[7, 3:] = _unit(rng.normal(size=4))    # a rotation outlier
    poses = poses.astype(np.float32)
    signed = poses.copy()
    signed[9, 3:] *= -1                         # same rotation, other sign
    want = np.asarray(jax_calib.pose_outliers(jnp.asarray(signed)))
    got = calib.pose_outliers(_t(signed)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] and got[7]
    np.testing.assert_array_equal(got, calib.pose_outliers(_t(poses)))
    np.testing.assert_array_equal(calib.pose_outliers(_t(poses[:, :3])),
                                  jax_calib.pose_outliers(poses[:, :3]))
    # the reference's filter is a no-op on both sides
    np.testing.assert_array_equal(calib.remove_pose_outliers(_t(poses)),
                                  np.asarray(
                                      jax_calib.remove_pose_outliers(poses)))


@pytest.mark.parametrize("weighted", [False, True])
def test_average_quaternions_mixed_signs(weighted):
    rng = np.random.default_rng(17)
    q0 = _unit(rng.normal(size=4))
    q = _unit(q0 + rng.normal(size=(9, 4)) * 0.05)
    q[::2] *= -1                                # q = -q
    q = q.astype(np.float32)
    w = rng.uniform(0.2, 2.0, 9).astype(np.float32) if weighted else None
    want = jax_calib.average_quaternions(jnp.asarray(q), weights=w)
    got = calib.average_quaternions(_t(q), weights=w)
    _quat_close(got.numpy(), want)
    _quat_close(got.numpy(), q0, 0.05)


@pytest.mark.parametrize("case", ["one", "many", "weights", "bad_weights"])
def test_average_poses(case):
    rng = np.random.default_rng(18)
    n = 1 if case == "one" else 6
    poses = _poses(rng, n, spread=0.05)
    poses[1:, 3:] = _unit(poses[0, 3:] + rng.normal(size=(n - 1, 4)) * 0.05)
    poses = poses.astype(np.float32)
    w = {"weights": rng.uniform(0.5, 1.5, n).astype(np.float32),
         "bad_weights": np.ones(n + 1, np.float32)}.get(case)
    want = np.asarray(jax_calib.average_poses(jnp.asarray(poses), weights=w))
    got = calib.average_poses(_t(poses), weights=w).numpy()
    _close(got[:3], want[:3])
    _quat_close(got[3:], want[3:])
    if case != "bad_weights":
        _close(calib.average_translations(_t(poses[:, :3]), w).numpy(),
               jax_calib.average_translations(poses[:, :3], w))


# ------------------------------------------------------------- labels


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 0.0), (2, 0.01),
                                        (3, 0.03)])
def test_get_6_key_points(seed, noise):
    s = generate_sample(seed=seed, n_ee=600, n_arm=200, n_bg=200)
    ee = s["points"][s["labels"] == 2]
    q = s["pose"][3:]
    pose = np.concatenate([s["pose"][:3], q[3:], q[:3]])   # WXYZ
    pose = pose + np.random.default_rng(seed).normal(size=7) * noise
    want = jax_labels.get_6_key_points(ee, pose, euclidean_threshold=0.04)
    got = labels.get_6_key_points(ee, pose, euclidean_threshold=0.04)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0])
    np.testing.assert_array_equal(labels.KEY_POINTS_6, jax_labels.KEY_POINTS_6)


def test_get_6_key_points_face_hidden():
    s = generate_sample(seed=4, n_ee=600, n_arm=200, n_bg=200)
    q = s["pose"][3:]
    pose = np.concatenate([s["pose"][:3], q[3:], q[:3]])
    ee = s["points"][s["labels"] == 2]
    local = (ee - pose[:3]) @ labels.quat_to_matrix_np(pose[3:7])
    back = ee[local[:, 0] < -0.01]              # only the back of the EE
    got = labels.get_6_key_points(back, pose)
    want = jax_labels.get_6_key_points(back, pose)
    assert len(got[1]) == len(want[1]) == 0


# -------------------------------------------------------- translation


@pytest.mark.parametrize("p", [None, 0.0, 2.0, 50.0, 100.0])
def test_z_percentile(p):
    rng = np.random.default_rng(19)
    b, n = 4, 64
    pts = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.05
    mask = rng.random((b, n)) > 0.3
    mask[1] = False                              # count 0: index 0
    mask[2, 40:] = False                         # padding after the rows
    pts[2, 40:] = -5.0                           # padding that would win
    q = _unit(rng.normal(size=(b, 4))).astype(np.float32)
    want = jax.vmap(lambda x, m, r: jax_translation(x, m, r,
                                                    z_percentile=p))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(q))
    got = predict_translation(_t(pts), _t(mask), _t(q), z_percentile=p)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# ----------------------------------------------------------- symmetry


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_disambiguate_flip_both_outcomes(axis):
    rng = np.random.default_rng(20)
    b, n = 6, 80
    ee = _poses(rng, b)
    flip = np.asarray({"x": [0, 1, 0, 0], "y": [0, 0, 1, 0],
                       "z": [0, 0, 0, 1]}[axis], np.float32)
    kp = ee.copy()
    noise = rng.normal(size=(b, 4)) * 0.05
    # items 0-2: the keypoint pose near the flipped branch; 3-5 near the
    # network's; item 2's keypoint pose is not trusted
    kp[:3, 3:] = _unit(np.asarray(jax_quat.qmul(ee[:3, 3:], flip))
                       + noise[:3])
    kp[3:, 3:] = _unit(ee[3:, 3:] + noise[3:])
    kp_ok = np.array([True, True, False, True, True, True])
    pts = (ee[:, None, :3] + rng.normal(size=(b, n, 3)) * 0.04).astype(
        np.float32)
    mask = rng.random((b, n)) > 0.2
    args = [ee, kp.astype(np.float32), kp_ok, pts, mask]
    want_pose, want_use = jax.vmap(
        lambda *a: jax_sym.disambiguate_flip(*a, axis=axis,
                                             z_percentile=2.0))(
        *map(jnp.asarray, args))
    got_pose, got_use = disambiguate_flip(*map(_t, args), axis=axis,
                                          z_percentile=2.0)
    np.testing.assert_array_equal(got_use.numpy(), np.asarray(want_use))
    np.testing.assert_array_equal(got_use.numpy(),
                                  [True, True, False, False, False, False])
    _close(got_pose.numpy(), want_pose)
    _close(_quat_angle(_t(ee[:, 3:]), _t(kp[:, 3:])).numpy(),
           jax.vmap(jax_sym._quat_angle)(ee[:, 3:], kp[:, 3:]), ANGLE_TOL)
