"""The Bottleneck block, the bottleneck MinkUNets (minkunet50 / 101) and
AliveUNet vs the JAX package (CPU, f32, eval mode).

JAX variable trees come from ``jax.eval_shape`` and are filled from a numpy
seed (random batch norm statistics and biases, so that eval mode reads
them); the port loads them through ``interop.load_jax_variables``.
Outputs agree to relative norm 1e-4; AliveUNet's padding rows are exactly
0.  An engine on the bottleneck backbone runs ``predict_batch_arrays`` on
the CPU; its int8 form is held in ``test_torch_q8_bottleneck.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.models.aliveunet import AliveUNet as JaxAliveUNet
from mrcc_tpu.models.blocks import SparseBottleneck as JaxBottleneck
from mrcc_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet
from mrcc_tpu.models.minkunet import make_minkunet as jax_make_minkunet
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import AliveUNet, MinkUNetBase, SparseBottleneck
from mrcc_tpu_torch.models.minkunet import variant
from mrcc_tpu_torch.sparse import build_hierarchy
from mrcc_tpu_torch.sparse.types import SparseVoxels

CAPS = (256, 128, 64, 64)


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


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def levels():
    """B = 2 clouds at capacity 1024 as depth-4 (MinkUNet) and depth-3
    (AliveUNet) hierarchies on both sides."""
    rng = np.random.default_rng(0)
    b, p = 2, 700
    pts = (rng.normal(size=(b, p, 3)) * 0.05).astype(np.float32)
    rgb = rng.random((b, p, 3)).astype(np.float32) - 0.5
    mask = rng.random((b, p)) > 0.05
    vox, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                             jnp.asarray(mask), 0.005, 1024)
    port_vox = SparseVoxels(off=_t(vox.off), key=_t(vox.key),
                            feats=_t(vox.feats), valid=_t(vox.valid),
                            count=_t(vox.count))
    out = {}
    for depth, caps in ((4, CAPS), (3, CAPS[:3])):
        lv_j = jax.jit(partial(jax_build_hierarchy, depth=depth,
                               capacities=caps))(vox)
        out[depth] = (lv_j, build_hierarchy(port_vox, depth,
                                            capacities=caps))
    return vox.feats, out


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            if coll == "batch_stats" and k == "var":
                x = rng.uniform(0.5, 1.5, v.shape)
            elif k in ("mean", "bias"):
                x = rng.normal(size=v.shape) * 0.1
            elif k == "scale":
                x = rng.uniform(0.8, 1.2, v.shape)
            else:
                x = rng.normal(size=v.shape) * np.sqrt(2.0 / v.shape[-1])
            out[k] = x.astype(np.float32)
        return out

    return {c: walk(t, c) for c, t in shapes.items()}


def _run_pair(jmod, port, feats, lv_j, lv, seed, scope=None):
    """Fill the JAX variables, load them into ``port`` (under the flax
    ``scope`` the port's names carry, if any), run both."""
    variables = _fill(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                     feats, lv_j), seed)
    scoped = variables if scope is None else {
        c: {scope: t} for c, t in variables.items()}
    load_jax_variables(port, scoped).eval()
    want = np.asarray(jax.jit(jmod.apply)(variables, feats, lv_j))
    with torch.no_grad():
        got = port(_t(feats), lv).numpy()
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("cin,planes", [(8, 4), (16, 4)])
def test_bottleneck_block(cin, planes, levels):
    """A width change (1x1 + BN residual) and an identity residual."""
    _, lvs = levels
    lv_j, lv = lvs[4]
    level_j, level = lv_j[1], lv[1]
    rng = np.random.default_rng(cin)
    f = rng.normal(size=level.valid.shape + (cin,)).astype(np.float32)
    f = jnp.asarray(f * np.asarray(level.valid)[..., None])
    jmod = JaxBottleneck(planes)
    port = SparseBottleneck(cin, planes)
    assert (port.downsample is None) == (cin == 4 * planes)
    got, want = _run_pair(jmod, port, f, level_j, level, seed=cin)
    assert got.shape[-1] == 4 * planes
    assert _rel(got, want) <= 1e-4


def test_bottleneck_minkunet(levels):
    feats, lvs = levels
    lv_j, lv = lvs[4]
    cfg = dict(planes=(4, 4, 8, 8, 8, 8, 4, 4), layers=(1,) * 8,
               block="bottleneck", init_dim=8)
    got, want = _run_pair(JaxMinkUNet(3, 5, **cfg), MinkUNetBase(3, 5, **cfg),
                          feats, lv_j, lv, seed=3, scope="unet")
    assert _rel(got, want) <= 1e-4
    assert (got[~lv[0].valid.numpy()] == 0).all()


@pytest.mark.parametrize("name", ["minkunet50", "minkunet101",
                                  "minkunet50A", "minkunet101D"])
def test_variant_matches_make_minkunet(name):
    jmod = jax_make_minkunet(name, 3, 4)
    cfg = variant(name)
    assert cfg == dict(planes=jmod.planes, layers=jmod.layers,
                       block=jmod.block)
    with torch.device("meta"):
        port = MinkUNetBase(3, 4, **cfg)
    # the decoder's widths follow expansion 4 (skips of 4 * planes)
    assert port.block5[0].conv1.kernel.shape[1] == (cfg["planes"][4]
                                                    + 4 * cfg["planes"][2])
    assert port.final.kernel.shape[1] == 4 * cfg["planes"][7]


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_aliveunet(block, levels):
    feats, lvs = levels
    lv_j, lv = lvs[3]
    kw = dict(m=4, depth=3, block_reps=2, block=block)
    got, want = _run_pair(JaxAliveUNet(3, 5, **kw), AliveUNet(3, 5, **kw),
                          feats, lv_j, lv, seed=5)
    assert _rel(got, want) <= 1e-4
    pad = ~lv[0].valid.numpy()
    assert pad.any() and (got[pad] == 0).all()


def _engine_cfg(**kw):
    return InferenceConfig(
        point_capacity=1024, seg_voxel_capacity=768, ee_point_capacity=512,
        ee_voxel_capacity=512, kp_voxel_capacity=512,
        seg_hierarchy_caps=(512, 256, 128, 64),
        ee_hierarchy_caps=(256, 128, 64, 64),
        kp_hierarchy_caps=(384, 256, 128, 64), seg_backbone="minkunet50",
        rot_backbone="minkunet14A", kp_backbone="minkunet50",
        icp_iterations=5, icp_template_points=256, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_the_bottleneck_backbone(dtype):
    from mrcc_tpu_torch.data.synthetic import build_batch

    pts, rgb, mask = build_batch(2, 1024, seed=11)
    eng = InferenceEngine(_engine_cfg(compute_dtype=dtype), device="cpu")
    assert isinstance(eng.seg_model.block1[0], SparseBottleneck)
    out = eng.predict_batch_arrays(pts, rgb, mask)
    assert out["segmentation"].shape == (2, 1024)
    assert torch.isfinite(out["ee_pose"]).all()
    assert torch.isfinite(out["kp_pose"]).all()

