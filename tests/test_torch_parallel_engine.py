"""The port's engine under a 2-rank mesh (gloo, CPU) against the JAX
engine.

Under a mesh the JAX engine ``shard_map``s every stage over the batch
axis with no collective, so its result is, by definition, the engine run
on each shard alone; the test runs the JAX engine on each half of the
batch (cheaper than a JAX mesh compile) at ``tests/test_multichip.py``'s
``small_cfg`` (minkunet14A, f32, P = 1024, 3 ICP iterations).  Two ranks
of ``torch_dp_worker.py`` share its weights (``load_jax_params``) and run
the B = 8 batch both ways a user can call the engine: the plain global
batch (results gathered from both ranks) and ``fleet.globalize`` of each
rank's rows (``fleet.local_slice`` of the results).

Segmentation, EE count, ``kp_found`` and ``kp_ok`` are exact; poses agree
to 1e-3 (quaternions up to sign; ICP amplifies f32 rounding, as in
``test_torch_engine.py``), keypoint confidences to 1e-4 (a softmax maximum
after the f32 keypoint net: one of the 24 differs by 1.2e-5 here, with or
without the mesh).  Each rank's rows are also bit-equal to the port's own
engine without a mesh on that half: the mesh changes no arithmetic.

The second batch's halves differ in colour range (0-255 against 0-1).
``normalize_colors`` decides its branches over the batch it sees, so the
sharded result (each half normalised alone) differs from the unsharded
one (C6): the ranks must equal the per-shard JAX result, and the test
shows that it differs from the port's unsharded engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.geometry.preprocess import normalize_colors as jax_normalize
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from test_multichip import build_batch, small_cfg
from torch_dp_worker import run_ranks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: under the suite's
    parallel workers torch's default of a thread a core oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXACT = ("segmentation", "seg_overflow", "ee_count", "kp_found", "kp_ok")


def _port_cfg():
    fields = {f.name for f in dataclasses.fields(InferenceConfig)}
    return {k: v for k, v in dataclasses.asdict(small_cfg()).items()
            if k in fields}


def _pose_close(a, b, atol):
    np.testing.assert_allclose(a[..., :3], b[..., :3], atol=atol)
    d = np.minimum(np.abs(a[..., 3:] - b[..., 3:]).max(-1),
                   np.abs(a[..., 3:] + b[..., 3:]).max(-1))
    assert d.max() <= atol, d


def _assert_matches(got, want):
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("ee_pose", "kp_pose"):
        _pose_close(got[k], want[k], 1e-3)
    np.testing.assert_allclose(got["kp_conf"], want["kp_conf"], atol=1e-4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    pts, rgb, mask = build_batch()
    mixed = rgb.copy()
    mixed[:4] *= 255.0  # the first rank's clouds in 0-255, the second's 0-1
    batches = [(pts, rgb, mask), (pts, mixed, mask)]
    jeng = JaxEngine(small_cfg(), seed=0)
    want = []
    for p, c, m in batches:
        halves = [jax.device_get(jeng.predict_batch_arrays(
            p[s], c[s], m[s])) for s in (slice(0, 4), slice(4, 8))]
        want.append(halves)
    params = jax.device_get(jeng.params)
    eng = InferenceEngine(InferenceConfig(**_port_cfg()), device="cpu")
    eng.load_jax_params(params)
    port = [[{k: v.numpy() for k, v in eng.predict_batch_arrays(
        p[s], c[s], m[s]).items()} for s in (slice(0, 4), slice(4, 8))]
        for p, c, m in batches]
    ranks = run_ranks("engine", {"cfg": _port_cfg(), "params": params,
                                 "batches": batches},
                      tmp_path_factory.mktemp("engine"), timeout_s=400)
    return batches, eng, want, port, ranks


@pytest.mark.parametrize("case", [0, 1], ids=["batch", "mixed_colours"])
def test_ranks_equal_jax_per_shard(run, case):
    _, _, want, port, ranks = run
    halves = want[case]
    whole = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    for rank, r in enumerate(ranks):
        got = r["batches"][case]
        _assert_matches(got["local"], halves[rank])
        _assert_matches(got["whole"], whole)
        for k, v in port[case][rank].items():
            assert got["local"][k].tobytes() == v.tobytes(), k
            assert got["whole"][k][rank * 4:rank * 4 + 4].tobytes() == \
                v.tobytes(), k
    assert int(whole["ee_count"].sum()) > 0


def test_mixed_colours_differ_unsharded(run):
    """C6: the mixed batch normalised whole is not normalised per half, and
    the unsharded engine's result is not the sharded one."""
    batches, eng, _, _, ranks = run
    pts, mixed, mask = batches[1]
    whole = np.asarray(jax_normalize(jnp.asarray(mixed),
                                     mask=jnp.asarray(mask)))
    halves = np.concatenate([np.asarray(jax_normalize(
        jnp.asarray(mixed[s]), mask=jnp.asarray(mask[s])))
        for s in (slice(0, 4), slice(4, 8))])
    assert np.abs(whole - halves)[mask].max() > 0.1
    single = {k: v.numpy() for k, v in
              eng.predict_batch_arrays(pts, mixed, mask).items()}
    sharded = ranks[0]["batches"][1]["whole"]
    assert (single["segmentation"] != sharded["segmentation"]).any()
