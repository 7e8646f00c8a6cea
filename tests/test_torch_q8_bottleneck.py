"""int8 on the bottleneck backbone (minkunet50 / 101) vs the JAX int8
engine (CPU).

The bottleneck's 1x1 convs have no int8 form and stay in the feature
dtype, in JAX as in the port; its k3 convs and the U-Net's down / up
convs take the int8 route where the JAX engine's does
(``sparse.hierarchy.q8_route``).  A bottleneck MinkUNet (minkunet50's
blocks at reduced width and depth, bf16): the port's calibration records
what JAX's ``q8_stats`` records (to 1e-2 relative: bf16 activations on two
float routes), the JAX statistics load across, and the int8 logits are
within 3e-2 relative norm of the JAX int8 net's (jitted, Pallas in
interpret mode) with argmax labels equal on at least 99 % of valid voxels.
The minkunet50 int8 engine calibrates and predicts on the CPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import MinkUNetBase
from mrcc_tpu_torch.sparse.nn import q8_calibration, q8_convs, set_q8
from test_torch_q8_routes import B, ENGINE_CFG, _hierarchies, _t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_int8_bottleneck_minkunet_matches_jax():
    """minkunet50's block at reduced width and depth, bf16, self-keyed
    levels where the int8 engine self-keys (a 64-row level on tables)."""
    caps = (256, 128, 64, 64)
    cap0 = 512
    flags = tuple(l >= 3 for l in range(5))
    vox, lq, lv = _hierarchies(cap0, caps, flags, self_keyed=True)
    assert [level.nbr_sk is None for level in lq] == list(flags)
    arch = dict(planes=(4, 8, 8, 8, 8, 8, 8, 4), layers=(1,) * 8,
                block="bottleneck", init_dim=8)
    jmod = JaxMinkUNet(3, 5, **arch)
    feats = vox.feats.astype(jnp.bfloat16)
    # init and the calibration apply on the float route ("xla" levels)
    with sparse_impl("xla"):
        lx = jax.jit(partial(jax_build_hierarchy, depth=4,
                             capacities=caps))(vox)
        variables = jax.jit(jmod.init)(jax.random.PRNGKey(2), vox.feats, lx)
        _, q8 = jax.jit(partial(jmod.apply, mutable=["q8_stats"]))(
            variables, feats, lx)
    variables = jax.device_get({**variables, **q8})

    port = MinkUNetBase(3, 5, **arch).eval()
    load_jax_variables(port, {c: {"unet": t} for c, t in variables.items()})
    convs = dict(q8_convs(port))
    # k3 / down / up convs only: the 1x1 convs have no int8 form
    assert not any(".conv1" in n or ".conv3" in n for n in convs)
    stats = {n: m.act_absmax.clone() for n, m in convs.items()}
    for m in convs.values():
        m.act_absmax = None
    tfeats = _t(vox.feats).bfloat16()
    with torch.no_grad(), q8_calibration(port):
        port(tfeats, lv)
    for n, m in convs.items():
        np.testing.assert_allclose(m.act_absmax.numpy(), stats[n].numpy(),
                                   rtol=1e-2, err_msg=n)
        m.act_absmax = stats[n]

    with sparse_impl("pallas-int8"):
        want = np.asarray(jax.jit(jmod.apply)(variables, feats, lq),
                          np.float32)
    set_q8(port, True)
    with torch.no_grad():
        got = port(tfeats, lv).float().numpy()
    assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want)
    valid = np.asarray(lq[0].valid)
    agree = (got.argmax(-1) == want.argmax(-1))[valid].mean()
    assert agree >= 0.99, agree


def test_int8_engine_on_the_bottleneck_backbone():
    cfg = InferenceConfig(**{**ENGINE_CFG, "seg_backbone": "minkunet50",
                             "kp_backbone": "minkunet50"})
    eng = InferenceEngine(cfg, device="cpu")
    pts, rgb, mask = build_batch(B, 1024, seed=11)
    eng.calibrate_q8(pts, rgb, mask)
    convs = q8_convs(eng.seg_model)
    assert convs and all(m.q8 and m.act_absmax is not None
                         for _, m in convs)
    out = eng.predict_batch_arrays(pts, rgb, mask)
    assert out["segmentation"].shape == (B, 1024)
    assert torch.isfinite(out["ee_pose"]).all()
    assert torch.isfinite(out["kp_pose"]).all()
