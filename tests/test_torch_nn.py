"""The ICP nearest-neighbour search of the port vs the JAX package (CPU).

- ``ops.nn.nn_search`` (plain twin) against ``nn_search_pallas`` in
  interpret mode, item by item (M = 256 template points, N = 512 targets,
  a quarter of them invalid): ``d2`` within 1e-5 absolute (f32 at ~1 m,
  where the two sum in different orders), ``idx`` equal except where the
  two smallest ``d2`` of a row lie within 1e-6 of ``|a|^2`` (a near-tie:
  the f32 rounding of ``|a|^2 - 2ab + |b|^2`` is relative to ``|a|^2``, and
  the summation order may decide it either way).
- ``icp_refine(use_pallas=True)`` against the JAX ``icp_refine(use_pallas=
  True)`` (its kernel in interpret mode) from perturbed ground-truth seeds
  of two scenes' EE crops, where ICP converges (ROADMAP C5): poses within
  1e-4, quaternions up to sign.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.ops import nn_pallas
from mrcc_tpu.solve import icp as jax_icp
from mrcc_tpu_torch.ops.nn import nn_search
from mrcc_tpu_torch.solve import default_template, icp_refine


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


B = 2


def test_nn_search_matches_jax():
    rng = np.random.default_rng(0)
    tmpl = (rng.normal(size=(B, 256, 3)) * 0.1 + 1.0).astype(np.float32)
    tgt = (rng.normal(size=(B, 512, 3)) * 0.1 + 1.0).astype(np.float32)
    mask = rng.random((B, 512)) > 0.25
    idx, d2 = nn_search(torch.as_tensor(tmpl), torch.as_tensor(tgt),
                        torch.as_tensor(mask))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    for b in range(B):
        w_idx, w_d2 = nn_pallas.nn_search_pallas(
            jnp.asarray(tmpl[b]), jnp.asarray(tgt[b]), jnp.asarray(mask[b]),
            interpret=True)
        np.testing.assert_allclose(d2[b].numpy(), np.asarray(w_d2),
                                   atol=1e-5)
        sqs = (tmpl[b] ** 2).sum(-1)
        full = sqs[:, None] - 2 * tmpl[b] @ tgt[b].T + (tgt[b] ** 2).sum(-1)
        full = np.where(mask[b][None], full, np.inf)
        two = np.sort(full, axis=1)[:, :2]
        tie = (two[:, 1] - two[:, 0]) <= 1e-6 * sqs
        differ = idx[b].numpy() != np.asarray(w_idx)
        assert not (differ & ~tie).any(), np.flatnonzero(differ & ~tie)
        assert mask[b][idx[b].numpy()].all()


def test_icp_refine_with_the_kernel_matches_jax(monkeypatch):
    monkeypatch.setattr(nn_pallas, "nn_search_pallas",
                        partial(nn_pallas.nn_search_pallas, interpret=True))
    e = 512
    pts = np.zeros((B, e, 3), np.float32)
    mask = np.zeros((B, e), bool)
    gt = np.zeros((B, 7), np.float32)
    for i in range(B):
        s = generate_sample(seed=20 + i, n_ee=300, n_arm=300, n_bg=380)
        ee = s["points"][s["labels"] == 2][:e]
        pts[i, :len(ee)], mask[i, :len(ee)] = ee, True
        q = s["pose"][3:]  # XYZW
        gt[i] = np.concatenate([s["pose"][:3], q[3:], q[:3]])
    noise = np.random.default_rng(3).normal(size=(B, 7)).astype(np.float32)
    seeds = gt + noise * np.array([0.01] * 3 + [0.02] * 4, np.float32)
    seeds[:, 3:] /= np.linalg.norm(seeds[:, 3:], axis=-1, keepdims=True)
    template = default_template(256)
    got = icp_refine(torch.as_tensor(template), torch.as_tensor(pts),
                     torch.as_tensor(mask), torch.as_tensor(seeds),
                     iterations=15, use_pallas=True).numpy()
    for b in range(B):
        want = np.asarray(jax_icp.icp_refine(
            jnp.asarray(template), jnp.asarray(pts[b]), jnp.asarray(mask[b]),
            jnp.asarray(seeds[b]), iterations=15, use_pallas=True))
        np.testing.assert_allclose(got[b, :3], want[:3], atol=1e-4)
        dq = min(np.abs(got[b, 3:] - want[3:]).max(),
                 np.abs(got[b, 3:] + want[3:]).max())
        assert dq <= 1e-4, dq
    assert not np.allclose(got, seeds, atol=1e-6)   # ICP moved the seeds
