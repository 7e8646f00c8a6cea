"""Public names of the JAX package that the port lacked, held against JAX
on the CPU.

- ``solve.icp_refine_batch`` against ``mrcc_tpu/solve/icp.py:114`` (a
  ``vmap`` of the one-cloud ICP) from perturbed ground-truth seeds of two
  scenes' EE crops, where ICP converges (ROADMAP C5): positions within
  1e-4, quaternions up to sign.
- ``geometry.preprocess.base_at_origin`` against ``preprocess.py:32``,
  without and with a mask (padding rows far below the valid ones must not
  set the minimum): exact.
- ``models.minkunet.MinkUNet18D / 14A / 34C / 34A / 101``: the module
  ``make_minkunet`` gives for the name (state-dict names and shapes equal)
  with the JAX constructor's planes, depths and block.
- ``utils.aruco.tag_pose_from_corners`` / ``compute_ee_pose``: the card by
  default (``resolve_device``), so without one they raise unless the CPU is
  asked for; ``ArucoCalibrationApp`` solves the tag on its engine's device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.geometry import preprocess as jax_preprocess
from mrcc_tpu.models import minkunet as jax_minkunet
from mrcc_tpu.solve import icp as jax_icp
from mrcc_tpu_torch.app import aruco_calibration
from mrcc_tpu_torch.geometry.preprocess import base_at_origin
from mrcc_tpu_torch.models import minkunet
from mrcc_tpu_torch.solve import default_template, icp_refine_batch
from mrcc_tpu_torch.utils import aruco


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_icp_refine_batch_matches_jax():
    b, e = 2, 512
    pts = np.zeros((b, e, 3), np.float32)
    mask = np.zeros((b, e), bool)
    gt = np.zeros((b, 7), np.float32)
    for i in range(b):
        s = generate_sample(seed=30 + i, n_ee=300, n_arm=300, n_bg=380)
        ee = s["points"][s["labels"] == 2][:e]
        pts[i, :len(ee)], mask[i, :len(ee)] = ee, True
        q = s["pose"][3:]  # XYZW
        gt[i] = np.concatenate([s["pose"][:3], q[3:], q[:3]])
    noise = np.random.default_rng(5).normal(size=(b, 7)).astype(np.float32)
    seeds = gt + noise * np.array([0.01] * 3 + [0.02] * 4, np.float32)
    seeds[:, 3:] /= np.linalg.norm(seeds[:, 3:], axis=-1, keepdims=True)
    template = default_template(256)
    got = icp_refine_batch(torch.as_tensor(template), torch.as_tensor(pts),
                           torch.as_tensor(mask), torch.as_tensor(seeds),
                           iterations=10, threshold=0.08).numpy()
    want = np.asarray(jax_icp.icp_refine_batch(
        jnp.asarray(template), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(seeds), iterations=10, threshold=0.08))
    assert got.shape == want.shape == (b, 7)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-4)
    for g, w in zip(got[:, 3:], want[:, 3:]):
        assert min(np.abs(g - w).max(), np.abs(g + w).max()) <= 1e-4
    # ICP moved the seeds towards the truth
    assert (np.abs(got[:, :3] - gt[:, :3]).max()
            < np.abs(seeds[:, :3] - gt[:, :3]).max())


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_base_at_origin_matches_jax(masked):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(2, 64, 3)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((2, 64)) > 0.3
        pts[~mask] = -50.0  # padding rows far below every valid row
    got, got_off = base_at_origin(torch.as_tensor(pts), None if mask is None
                                  else torch.as_tensor(mask))
    want, want_off = jax_preprocess.base_at_origin(pts, mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
    if masked:
        assert (got.numpy()[mask] >= 0).all()
        assert (got_off.numpy() > -50.0).all()


CONSTRUCTORS = (("MinkUNet18D", "minkunet18D"), ("MinkUNet14A", "minkunet14A"),
                ("MinkUNet34C", "minkunet34C"), ("MinkUNet34A", "minkunet34A"),
                ("MinkUNet101", "minkunet101"))


@pytest.mark.parametrize("ctor,name", CONSTRUCTORS,
                         ids=[c for c, _ in CONSTRUCTORS])
def test_named_minkunets(ctor, name):
    net = getattr(minkunet, ctor)(3, 5)
    ref = minkunet.make_minkunet(name, 3, 5)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert got == want
    # the JAX constructor's planes, depths and block
    jnet = getattr(jax_minkunet, ctor)(3, 5)
    v = minkunet.variant(name)
    assert tuple(v["planes"]) == tuple(jnet.planes)
    assert tuple(v["layers"]) == tuple(jnet.layers)
    assert v["block"] == jnet.block


def test_aruco_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corners = np.array([[300, 200], [340, 200], [340, 240], [300, 240]],
                       np.float32)
    depth = np.full((480, 640), 0.8, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        aruco.tag_pose_from_corners(corners, depth)
    pose = aruco.tag_pose_from_corners(corners, depth, device="cpu")
    assert pose.shape == (7,) and np.isfinite(pose).all()


def test_aruco_app_solves_on_its_engines_device(monkeypatch):
    seen = []

    def fake(points, rgb, device=None, **kw):
        seen.append(device)

    monkeypatch.setattr(aruco_calibration, "compute_ee_pose", fake)
    app = aruco_calibration.ArucoCalibrationApp(None, icp_enabled=False,
                                                device="cpu")
    frame = type("F", (), {"points": np.zeros((4, 3), np.float32),
                           "rgb": np.zeros((4, 3), np.float32),
                           "ee2base_pose": None})()
    app.predict(frame)
    assert seen == [torch.device("cpu")]
