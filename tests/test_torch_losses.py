"""The pose criteria of the port vs the JAX package (CPU, f32).

Every ``LossType`` under both reductions, plus ``compute_confidence`` on
cos2 and cos2_6d, ``symmetry_flip_axis`` on cos2_6d and the
position-disabled branches, from seeded numpy inputs handed to both
packages: the value and its gradient with respect to ``y_pred`` (from
``jax.grad`` and ``torch.autograd``) agree to 1e-5 in relative norm (f32,
the two sum in different orders).  ``compute_pose_dist`` is held the same
way and must leave its inputs as they were, at predictions 0.2 rad or
more from their labels: the angle is ``arccos(2 <q, q'>^2 - 1)``, whose
derivative ``1 / sin`` turns the f32 rounding of ``1 - x`` (2e-5 relative
at 0.05 rad) into the gradient's error near 0.

The inputs put some items under the confidence thresholds (position 0.03 m,
angle 0.24 rad), some between them and the ignore thresholds and some
above, so every mask of the confidence terms is exercised.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.geometry.metrics import compute_pose_dist as jax_pose_dist
from mrcc_tpu.train.losses import LossConfig as JaxLossConfig
from mrcc_tpu.train.losses import get_criterion as jax_get_criterion
from mrcc_tpu_torch.geometry import compute_pose_dist
from mrcc_tpu_torch.train import LossConfig, LossType, get_criterion


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


B, N = 8, 40
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(loss_type, confidence, seed=0, scales=(0.01, 0.04, 0.3)):
    """Label poses, predictions near them (by default items 0-2 within the
    confidence thresholds, 3-5 between, 6-7 beyond), coords, validity,
    probs."""
    rng = np.random.default_rng(seed)
    y = np.concatenate([rng.normal(size=(B, 3)) * 0.2,
                        _unit(rng.normal(size=(B, 4)))], -1)
    scale = np.repeat(scales, [3, 3, 2])[:, None]
    pos = y[:, :3] + rng.normal(size=(B, 3)) * scale / np.sqrt(3)
    quat = y[:, 3:] + rng.normal(size=(B, 4)) * scale * 2
    quat *= rng.uniform(0.8, 1.2, (B, 1))  # unnormalised, as a head gives
    if loss_type == LossType.COS2_6D:
        rot = _rotmat(_unit(quat))
        rot6 = np.concatenate([rot[:, :, 0], rot[:, :, 1]], -1)
        pred = np.concatenate([pos, rot6 + rng.normal(size=(B, 6)) * 0.05],
                              -1)
    else:
        pred = np.concatenate([pos, quat], -1)
    if confidence:
        pred = np.concatenate([pred, rng.uniform(0.05, 0.95, (B, 3))], -1)
    coords = rng.normal(size=(B, N, 3)) * 8
    valid = rng.random((B, N)) < 0.8
    probs = rng.uniform(0.2, 1.0, (B, N))
    return [a.astype(np.float32) for a in (y, pred, coords)] + [
        valid, probs.astype(np.float32)]


def _rotmat(q):
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2)


_EXTRA = [
    ("cos2", dict(compute_confidence=True)),
    ("cos2", dict(disable_position=True)),
    ("cos2_6d", dict(compute_confidence=True)),
    ("cos2_6d", dict(symmetry_flip_axis="z", compute_confidence=True)),
    ("cos2_6d", dict(symmetry_flip_axis="x")),
    ("wgeodesic", dict(disable_position=True)),
    ("smoothl1", dict(disable_orientation=True)),
]
CASES = [(t.value, {"reduction": r}) for t in LossType
         for r in ("mean", "sum")] + [(t, {"reduction": "mean", **kw})
                                      for t, kw in _EXTRA]


def _case_id(case):
    loss_type, kw = case
    return "-".join([loss_type] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("loss_type,kw", CASES, ids=map(_case_id, CASES))
def test_criterion_matches_jax(loss_type, kw):
    lt = LossType(loss_type)
    y, pred, coords, valid, probs = _inputs(
        lt, kw.get("compute_confidence", False), seed=len(loss_type))
    jcfg = JaxLossConfig(loss_type=loss_type, **kw)
    cfg = LossConfig(loss_type=lt, **kw)
    assert dataclasses.asdict(cfg).keys() == dataclasses.asdict(jcfg).keys()
    extra = {"probs": probs} if lt == LossType.KP_POSE_MATCH else {}
    jfn = jax_get_criterion(jcfg)

    def jloss(p):
        return jfn(jnp.asarray(y), p, coords=jnp.asarray(coords),
                   coords_valid=jnp.asarray(valid),
                   **{k: jnp.asarray(v) for k, v in extra.items()})

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred.copy()).requires_grad_()
    got = get_criterion(cfg)(torch.from_numpy(y), p,
                             coords=torch.from_numpy(coords),
                             coords_valid=torch.from_numpy(valid),
                             **{k: torch.from_numpy(v)
                                for k, v in extra.items()})
    got.backward()
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) <= TOL, (float(got), float(want))
    assert np.linalg.norm(np.asarray(want_g)) > 0
    assert _rel(p.grad, want_g) <= TOL, _rel(p.grad, want_g)


def test_pose_dist_matches_jax():
    y, pred, *_ = _inputs(LossType.COS2, True, seed=3,
                          scales=(0.15, 0.3, 0.6))
    assert float(jax_pose_dist(y, pred)[3].min()) > 0.2
    w = np.random.default_rng(4).normal(size=(4, B)).astype(np.float32)

    def jsum(p):
        return sum((jnp.asarray(w[i]) * d).sum() for i, d in
                   enumerate(jax_pose_dist(jnp.asarray(y), p)))

    want = jax_pose_dist(jnp.asarray(y), jnp.asarray(pred))
    want_g = jax.grad(jsum)(jnp.asarray(pred))
    y_t = torch.from_numpy(y.copy())
    p = torch.from_numpy(pred.copy()).requires_grad_()
    got = compute_pose_dist(y_t, p)
    for g, v in zip(got, want):
        assert g.shape == (B,)
        assert _rel(g.detach(), v) <= TOL
    sum((torch.from_numpy(w[i]) * d).sum() for i, d in enumerate(got)
        ).backward()
    assert _rel(p.grad, want_g) <= TOL
    # the inputs are left as they were, also with a position scale
    compute_pose_dist(y_t, p.detach(), position_voxelization=100.0)
    assert np.array_equal(y_t.numpy(), y)
    assert np.array_equal(p.detach().numpy(), pred)
