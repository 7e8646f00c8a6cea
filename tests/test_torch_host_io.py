"""The port's robot and camera I/O against the JAX package's:

- ``utils/ros_utils``: ``arrays_to_pointcloud2_data`` byte for byte and
  ``pointcloud2_to_arrays`` (NaN rows skipped or kept, a cloud without
  ``rgb``) equal to JAX's;
- ``FreenectDataEngine`` with stand-in ``rospy`` / message modules (as
  ``tests/test_freenect_mocked.py``): the clear error without ROS, the
  pose callback's XYZW -> WXYZ, the queue of one dropping frames while
  full, and ``run`` subscribing both topics and throttling the clouds;
- ``utils/aruco``: ``project_to_rgbd`` equal to JAX's; ``compute_ee_pose``
  on a rendered tag (``tests/test_app_extras.py``'s) within 1e-5 of JAX's,
  and through the cv2-free ``tag_pose_from_corners`` on its corners;
- ``ArucoCalibrationApp.run`` (ICP from the tag pose, then
  ``engine.calibrate``) on the CPU against JAX's app on the same frames:
  each frame's pose and the extrinsic within 1e-5 without ICP and 1e-3
  with it (quaternions up to sign; ICP amplifies f32 rounding, as in
  ``test_torch_engine.py``: here 1.1e-4 on one coordinate).
"""

import sys
import types

import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.app.aruco_calibration import \
    ArucoCalibrationApp as JaxArucoCalibrationApp
from mrcc_tpu.utils import aruco as jax_aruco
from mrcc_tpu.utils import ros_utils as jax_ros
from mrcc_tpu_torch.app import (ArucoCalibrationApp, InferenceConfig,
                                InferenceEngine)
from mrcc_tpu_torch.utils import aruco, ros_utils

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _msg(data, step, fields, n):
    return types.SimpleNamespace(
        data=data, point_step=step, width=n, height=1,
        fields=[types.SimpleNamespace(name=a, offset=o, datatype=d)
                for a, o, d in fields])


# ------------------------------------------------------------ PointCloud2

def test_pointcloud2_codec_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    pts[5] = np.nan
    rgb = rng.random((64, 3)).astype(np.float32)
    got = ros_utils.arrays_to_pointcloud2_data(pts, rgb)
    want = jax_ros.arrays_to_pointcloud2_data(pts, rgb)
    assert got == want
    msg = _msg(*got, 64)
    for skip in (True, False):
        g = ros_utils.pointcloud2_to_arrays(msg, skip_nans=skip)
        w = jax_ros.pointcloud2_to_arrays(msg, skip_nans=skip)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(ros_utils.pointcloud2_to_arrays(msg)[0]) == 63
    # a cloud without colours
    xyz = _msg(got[0], got[1], got[2][:3], 64)
    np.testing.assert_array_equal(ros_utils.pointcloud2_to_arrays(xyz)[1],
                                  jax_ros.pointcloud2_to_arrays(xyz)[1])


# ---------------------------------------------------------------- freenect

@pytest.fixture()
def fake_ros(monkeypatch):
    rospy = types.ModuleType("rospy")
    rospy.subscribed = []
    rospy.Subscriber = lambda topic, kind, cb: rospy.subscribed.append(
        (topic, kind, cb))
    rospy.init_node = lambda *a, **k: None
    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")
    sensor_msg.PointCloud2 = "PointCloud2"
    sensor.msg = sensor_msg
    geom = types.ModuleType("geometry_msgs")
    geom_msg = types.ModuleType("geometry_msgs.msg")
    geom_msg.PoseStamped = "PoseStamped"
    geom.msg = geom_msg
    for name, mod in [("rospy", rospy), ("sensor_msgs", sensor),
                      ("sensor_msgs.msg", sensor_msg),
                      ("geometry_msgs", geom),
                      ("geometry_msgs.msg", geom_msg)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return rospy


def _pose_msg(xyz, xyzw):
    return types.SimpleNamespace(pose=types.SimpleNamespace(
        position=types.SimpleNamespace(x=xyz[0], y=xyz[1], z=xyz[2]),
        orientation=types.SimpleNamespace(x=xyzw[0], y=xyzw[1], z=xyzw[2],
                                          w=xyzw[3])))


def test_freenect_requires_ros(monkeypatch):
    from mrcc_tpu_torch.app import FreenectDataEngine

    monkeypatch.setitem(sys.modules, "rospy", None)
    with pytest.raises(RuntimeError, match="ROS"):
        FreenectDataEngine()


def test_freenect_callbacks_match_jax(fake_ros):
    from mrcc_tpu.app.freenect_data_engine import \
        FreenectDataEngine as JaxFreenect
    from mrcc_tpu_torch.app import FreenectDataEngine

    msg = _pose_msg((0.1, 0.2, 0.3), (0.1, -0.2, 0.3, 0.9))
    eng, jeng = FreenectDataEngine(), JaxFreenect()
    eng._on_pose(msg)
    jeng._on_pose(msg)
    np.testing.assert_array_equal(eng._pose, jeng._pose)
    np.testing.assert_allclose(eng._pose, [0.1, 0.2, 0.3, 0.9, 0.1, -0.2,
                                           0.3])
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    rgb = rng.random((100, 3)).astype(np.float32)
    eng._on_cloud(pts, rgb)
    eng._on_cloud(pts * 2, rgb)  # the queue holds one: dropped
    dto = eng.get()
    np.testing.assert_array_equal(dto.points, pts)  # the first one wins
    np.testing.assert_array_equal(dto.ee2base_pose, jeng._pose)
    assert eng._queue.empty()


def test_freenect_run_subscribes_and_throttles(fake_ros, monkeypatch):
    from mrcc_tpu_torch.app import FreenectDataEngine
    from mrcc_tpu_torch.app import freenect_data_engine as fde

    eng = FreenectDataEngine(fps=2.0)
    eng.run()
    topics = {t: (kind, cb) for t, kind, cb in fake_ros.subscribed}
    assert topics["/robot/ee_pose"][0] == "PoseStamped"
    assert topics["/camera/depth_registered/points"][0] == "PointCloud2"
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    msg = _msg(*ros_utils.arrays_to_pointcloud2_data(
        pts, rng.random((10, 3))), 10)
    on_cloud = topics["/camera/depth_registered/points"][1]
    clock = iter([100.0, 100.2, 100.6])
    monkeypatch.setattr(fde.time, "time", lambda: next(clock))
    on_cloud(msg)
    np.testing.assert_array_equal(eng.get().points, pts)
    on_cloud(msg)  # 0.2 s later: under the 0.5 s period, skipped
    assert eng._queue.empty()
    on_cloud(msg)
    assert not eng._queue.empty()


# ------------------------------------------------------------------ ArUco

def test_project_to_rgbd_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3000, 3)).astype(np.float32) * [0.5, 0.4, 0.3]
    pts[:, 2] += 1.2
    pts[:20] = pts[20:40] + [0, 0, 0.1]  # pixels hit twice: nearest wins
    rgb = rng.random((3000, 3)).astype(np.float32)
    got = aruco.project_to_rgbd(pts, rgb, aruco.CAMERA_MATRIX_DEFAULT)
    want = jax_aruco.project_to_rgbd(pts, rgb,
                                     jax_aruco.CAMERA_MATRIX_DEFAULT)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tag_cloud(tilt=0.0, shift=(0.0, 0.0, 0.0)):
    """``tests/test_app_extras.py``'s rendered tag (DICT_6X6_1000, id 7, a
    white border) as a plane of points at z = 1, tilted about y and
    shifted."""
    tag_px, size = 200, 0.075
    dic = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_1000)
    marker = cv2.aruco.generateImageMarker(dic, 7, tag_px)
    pad = int(tag_px * 0.3)
    img = np.full((tag_px + 2 * pad, tag_px + 2 * pad), 255, np.uint8)
    img[pad:-pad, pad:-pad] = marker
    h = img.shape[0]
    ys, xs = np.mgrid[0:h, 0:h]
    span = size * (h / tag_px)
    u = (xs / (h - 1) - 0.5) * span
    v = (ys / (h - 1) - 0.5) * span
    pts = np.stack([u.ravel(), v.ravel(), np.zeros(h * h)], 1)
    c, s = np.cos(tilt), np.sin(tilt)
    pts = pts @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]).T
    pts = (pts + [0, 0, 1.0] + np.asarray(shift)).astype(np.float32)
    g = (img.ravel() / 255.0).astype(np.float32)
    return pts, np.stack([g, g, g], 1)


def _quat_close(a, b, atol):
    d = min(np.abs(a - b).max(), np.abs(a + b).max())
    assert d <= atol, (a, b)


def test_compute_ee_pose_matches_jax():
    pts, rgb = _tag_cloud()
    got = aruco.compute_ee_pose(pts, rgb, device="cpu")
    want = jax_aruco.compute_ee_pose(pts, rgb)
    assert got is not None and want is not None
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-5)
    _quat_close(got[3:], np.asarray(want[3:]), 1e-5)
    # the same pose from the detected corners, without cv2's help after
    rgb_img, depth = aruco.project_to_rgbd(pts, rgb,
                                           aruco.CAMERA_MATRIX_DEFAULT)
    det = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_1000),
        cv2.aruco.DetectorParameters())
    corners, _, _ = det.detectMarkers(cv2.cvtColor(
        (rgb_img * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY))
    split = aruco.tag_pose_from_corners(corners[0][0], depth, device="cpu")
    np.testing.assert_array_equal(split, got)
    # a corner without depth: no pose
    assert aruco.tag_pose_from_corners(corners[0][0], np.zeros_like(depth),
                                       device="cpu") is None
    # without a tag: no pose
    assert aruco.compute_ee_pose(pts, np.ones_like(rgb), device="cpu") is None


class _Frames:
    """Two robot positions of two frames each: the tag tilted and shifted
    per frame, the EE-to-base pose per position."""

    def __init__(self):
        self.frames = []
        for p, (tilt, base) in enumerate(((0.05, (0.3, 0.1, 0.5)),
                                          (-0.08, (0.2, -0.2, 0.6)))):
            for f in range(2):
                pts, rgb = _tag_cloud(tilt + 0.01 * f,
                                      (0.01 * f, -0.005 * p, 0.02 * p))
                self.frames.append(types.SimpleNamespace(
                    points=pts, rgb=rgb, id=f"p{p + 1}",
                    ee2base_pose=np.array(base + (0.96, 0.0, 0.28, 0.0),
                                          np.float32)))
        self.i = 0

    def get(self):
        if self.i == len(self.frames):
            return None
        self.i += 1
        return self.frames[self.i - 1]


@pytest.mark.parametrize("icp", [False, True])
def test_aruco_calibration_app_matches_jax(icp):
    tol = 1e-3 if icp else 1e-5
    small = dict(icp_iterations=5, icp_template_points=256)
    app = ArucoCalibrationApp(_Frames(), icp_enabled=icp, engine=(
        InferenceEngine(InferenceConfig(**small), device="cpu",
                        calibration_only=True)))
    japp = JaxArucoCalibrationApp(_Frames(), icp_enabled=icp, engine=(
        JaxEngine(JaxConfig(**small), calibration_only=True)))
    for f in _Frames().frames:
        got, want = app.predict(f), japp.predict(f)
        np.testing.assert_allclose(got.ee_pose[:3], want.ee_pose[:3],
                                   atol=tol)
        _quat_close(got.ee_pose[3:], np.asarray(want.ee_pose[3:]), tol)
        np.testing.assert_allclose(got.base_pose[:3], want.base_pose[:3],
                                   atol=tol)
    if icp:  # ICP moved the tag pose
        tag = aruco.compute_ee_pose(_Frames().frames[0].points,
                                    _Frames().frames[0].rgb, device="cpu")
        assert np.abs(app.predict(_Frames().frames[0]).ee_pose
                      - tag).max() > 1e-4
    got, want = app.run(), japp.run()
    assert got.pose_camera_link is not None
    np.testing.assert_allclose(got.pose_camera_link[:3],
                               np.asarray(want.pose_camera_link)[:3],
                               atol=tol)
    _quat_close(got.pose_camera_link[3:],
                np.asarray(want.pose_camera_link)[3:], tol)
