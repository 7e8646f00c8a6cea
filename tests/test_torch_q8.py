"""int8 convs of the port vs the JAX package's q8 wrappers (CPU).

The JAX side runs ``gather_gemm_conv_sk_q8`` and ``gather_gemm_conv_tiled_q8``
under ``jax.jit``, as the JAX engine does (XLA turns their ``/ 127`` into a
product with the reciprocal), with their Pallas kernels in interpret mode,
over a hierarchy built under
``"xla"`` (the same sort) with the int8 packs attached by the JAX package's
own helpers (``sk_neighbor_pack``, ``build_tiled_maps``, ``_up_tiled_maps``).
The port runs its plain twins on the same bf16 features and f32 weights.

Tolerances:
- each q8 twin equals the JAX wrapper to 1 bf16 ulp of the output,
  elementwise (the int32 sums are exact, so 0 is expected);
- the same outputs are within 3e-2 relative norm of the JAX ``"xla"`` f32
  conv (``bench.py``'s int8 certification bound);
- the int8 segmentation net with JAX-calibrated ``q8_stats`` carried
  across: logits within 2e-2 relative norm, argmax labels equal on at least
  99.5 % of valid voxels (an ulp of difference in a bf16 layer between the
  convs can move one activation across a quantisation step).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.models import RobotNetSegmentation as JaxSeg
from mrcc_tpu.ops import conv_pallas as CP
from mrcc_tpu.ops.rank_pallas import pack_deltas, sk_neighbor_pack
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import conv as JC
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.hierarchy import K3_OFFSETS, _up_tiled_maps
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu.sparse.nn import SparseConvK3 as JaxConvK3
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import RobotNetSegmentation
from mrcc_tpu_torch.ops import conv_q8 as Q
from mrcc_tpu_torch.sparse import build_hierarchy
from mrcc_tpu_torch.sparse.nn import SparseConvK3, q8_calibration, q8_convs
from mrcc_tpu_torch.sparse.types import SparseVoxels


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
DELTAS = tuple(int(d) for d in pack_deltas(K3_OFFSETS))


def _t(x):
    return torch.from_numpy(np.array(x))


def _q8_levels(lv_j):
    """The JAX levels with the int8 packs a ``"pallas-int8"`` build gives."""
    out = []
    for i, lv in enumerate(lv_j):
        extra = dict(nbr_sk=sk_neighbor_pack(lv.off, lv.key, lv.valid,
                                             K3_OFFSETS))
        if i > 0:
            extra["child_tiled"] = CP.build_tiled_maps(
                lv.child_idx, lv.child_hit, lv_j[i - 1].key.shape[1])
        if i + 1 < len(lv_j):
            extra["up_tiled"] = _up_tiled_maps(
                lv.parent_idx, lv.parent_ok, lv.octant, lv.valid,
                lv_j[i + 1].key.shape[1])
        out.append(dataclasses.replace(lv, **extra))
    return tuple(out)


def _levels(cap, caps, seed, n_pts=700):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, n_pts, 3)) * 0.05).astype(np.float32)
    rgb = (rng.random((B, n_pts, 3)) - 0.5).astype(np.float32)
    mask = rng.random((B, n_pts)) > 0.05
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), 0.005, cap)
    with sparse_impl("xla"):
        lv_j = jax.jit(partial(jax_build_hierarchy, depth=4,
                               capacities=caps))(vox_j)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox_j.off), key=_t(vox_j.key), feats=_t(vox_j.feats),
        valid=_t(vox_j.valid), count=_t(vox_j.count)), 4, capacities=caps)
    return vox_j.feats, lv_j, _q8_levels(lv_j), lv


@pytest.fixture(scope="module")
def levels():
    """128-aligned capacities; level 1 overflows (parent_ok false)."""
    return _levels(768, (512, 256, 128, 128), seed=0)


@pytest.fixture(scope="module")
def wide_levels():
    """A 16384-row level 0 over 128-row coarse levels: the int8 down
    conv's table is over the 5 MiB budget at 384 channels (256 + 128)."""
    return _levels(16384, (128, 128, 128, 128), seed=1)


def _feats(level, c, rng, scale=1.0):
    x = rng.normal(size=level.valid.shape + (c,)) * scale
    x = np.where(np.asarray(level.valid)[..., None], x, 0.0)
    return jnp.asarray(x, jnp.bfloat16)


def _bf16_ulp(x):
    a = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(a, 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (diff <= ulp).all(), float((diff / ulp).max())
    return float(diff.max())


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mask(out, valid):
    return torch.where(valid[..., None], out, 0.0)


@pytest.mark.parametrize("cin,cout", [(3, 32), (48, 64), (256, 40)])
def test_sk_q8_matches_jax(levels, cin, cout):
    _, lv_j, lq_j, lv = levels
    rng = np.random.default_rng(cin)
    l = 0 if cin < 256 else 1
    f = _feats(lv[l], cin, rng)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    want = jax.jit(partial(CP.gather_gemm_conv_sk_q8, deltas=DELTAS,
                           identity_k=13))(
        f, jnp.asarray(w), lq_j[l].key, lq_j[l].nbr_sk, lq_j[l].valid)
    got = Q.gather_gemm_sk_q8(_t(f.astype(jnp.float32)).bfloat16(), _t(w),
                              lv[l].key, lv[l].kbits)
    assert got.dtype == torch.bfloat16
    assert _assert_ulp(_mask(got, lv[l].valid), want) == 0.0
    with sparse_impl("xla"):
        ref = JC.conv_k3(f.astype(jnp.float32), jnp.asarray(w), lv_j[l])
    assert _rel(got, ref) <= 3e-2
    # a calibrated absmax equal to the dynamic one gives the same bits
    amax = _t(f.astype(jnp.float32)).abs().amax(dim=(0, 1))
    stat = Q.gather_gemm_sk_q8(_t(f.astype(jnp.float32)).bfloat16(), _t(w),
                               lv[l].key, lv[l].kbits, act_absmax=amax)
    assert torch.equal(stat, got)


@pytest.mark.parametrize("case", ["narrow", "split"])
def test_down_q8_matches_jax(levels, wide_levels, case):
    """``split``: 384 channels over a 16384-row table split 256 + 128."""
    _, lv_j, lq_j, lv = levels if case == "narrow" else wide_levels
    cin, cout = (32, 48) if case == "narrow" else (384, 24)
    l = 0
    fine, coarse = lv[l], lv[l + 1]
    n = fine.key.shape[1]
    if case == "split":
        assert Q.q8_channel_groups("down", n, cin) == ((0, 256), (256, 384))
    rng = np.random.default_rng(cin)
    f = _feats(fine, cin, rng)
    w = (rng.normal(size=(8, cin, cout)) / np.sqrt(8 * cin)).astype(
        np.float32)
    want = jax.jit(partial(CP.gather_gemm_conv_tiled_q8, k=8))(
        f, jnp.asarray(w), lq_j[l + 1].child_tiled, lq_j[l + 1].valid)
    got = Q.gather_gemm_down_q8(_t(f.astype(jnp.float32)).bfloat16(), _t(w),
                                coarse.child_idx, coarse.child_hit)
    assert _assert_ulp(_mask(got, coarse.valid), want) == 0.0
    with sparse_impl("xla"):
        ref = JC.conv_down(f.astype(jnp.float32), jnp.asarray(w), lv_j[l],
                           lv_j[l + 1])
    assert _rel(got, ref) <= 3e-2


@pytest.mark.parametrize("cin,cout", [(64, 32), (896, 16)])
def test_up_q8_matches_jax(levels, cin, cout):
    """Broadcast-k up conv: each octant keeps its own column scales (the
    octants' weights below differ in scale by up to 8x); 896 channels split
    768 + 128 by the int8 k-lane cap."""
    _, lv_j, lq_j, lv = levels
    l = 1
    fine, coarse = lv[l], lv[l + 1]
    assert not bool(fine.parent_ok[fine.valid].all())  # overflowed parents
    rng = np.random.default_rng(cin)
    f = _feats(coarse, cin, rng)
    w = (rng.normal(size=(8, cin, cout)) / np.sqrt(cin)
         * (1.0 + np.arange(8))[:, None, None]).astype(np.float32)
    groups = Q.q8_channel_groups("up", coarse.key.shape[1], cin)
    assert len(groups) == (2 if cin == 896 else 1)
    _, s_c = Q.quantize_activations(_t(f.astype(jnp.float32)))
    _, m = Q.quantize_weights(_t(w), s_c, groups, per_octant=True)
    assert m.shape == (len(groups), 8, cout)
    assert not torch.allclose(m[0, 0], m[0, 7])
    want = jax.jit(partial(CP.gather_gemm_conv_tiled_q8, k=8, bcast_k=True))(
        f, jnp.asarray(w), lq_j[l].up_tiled, lq_j[l].valid)
    got = Q.gather_gemm_up_q8(_t(f.astype(jnp.float32)).bfloat16(), _t(w),
                              fine.parent_idx, fine.row_ok, fine.octant)
    assert _assert_ulp(_mask(got, fine.valid), want) == 0.0
    with sparse_impl("xla"):
        ref = JC.conv_transpose_up(f.astype(jnp.float32), jnp.asarray(w),
                                   lv_j[l + 1], lv_j[l])
    assert _rel(got, ref) <= 3e-2


def _jax_groups(mode, n, c):
    if mode == "k3":
        c_g = CP._sk_plan(n, c, 1)[0]
    elif mode == "down" and n * 128 > CP._TABLE_BUDGET:
        c_g = min(CP._padded_lanes(c), 128)    # gather_gemm_conv_streamed
    else:  # over the budget, an up conv lane-packs: c_g = 128 // pack
        c_g, _, _, kg, n_kg, pack = CP._split_plan(n, c, 8, 8, itemsize=1)
        assert kg == 8 and n_kg == 1
        assert pack == 1 or (mode == "up" and n * 128 > CP._TABLE_BUDGET)
    return tuple((a, min(a + c_g, c)) for a in range(0, c, c_g))


@pytest.mark.parametrize("mode", ["k3", "down", "up"])
def test_channel_groups_match_the_jax_plans(mode):
    for n in (128, 1024, 12544, 13696, 16384, 20480, 40960, 65536):
        for c in (3, 32, 96, 128, 130, 256, 384, 416, 768, 896, 1000):
            if n > Q.Q8_MAX_ROWS and mode == "k3":
                with pytest.raises(ValueError):
                    Q.q8_channel_groups(mode, n, c)
                continue
            assert Q.q8_channel_groups(mode, n, c) == _jax_groups(mode, n, c), \
                (mode, n, c)


def test_calibration_records_what_jax_records(levels):
    """Module state: the port's calibration mode and the JAX module's
    ``mutable=["q8_stats"]`` apply store the same absmax (max over two
    passes); the calibrated conv then uses it."""
    _, _, lq_j, lv = levels
    rng = np.random.default_rng(5)
    xs = [_feats(lv[0], 16, rng, scale=s) for s in (1.0, 2.0)]
    jmod = JaxConvK3(24)
    with sparse_impl("pallas-int8"):
        variables = jmod.init(jax.random.PRNGKey(0), xs[0], lq_j[0])
        assert "q8_stats" not in variables
        for x in xs:
            _, upd = jmod.apply(variables, x, lq_j[0], mutable=["q8_stats"])
            variables = {**variables, **upd}
    port = SparseConvK3(16, 24)
    assert port.act_absmax is None and "act_absmax" not in port.state_dict()
    load_jax_variables(port, {"params": variables["params"]})
    port.q8 = True
    with torch.no_grad(), q8_calibration(port):
        dyn = port(_t(xs[1].astype(jnp.float32)).bfloat16(), lv[0])
        port(_t(xs[0].astype(jnp.float32)).bfloat16(), lv[0])
    want = np.asarray(variables["q8_stats"]["act_absmax"])
    np.testing.assert_array_equal(port.act_absmax.numpy(), want)
    with torch.no_grad():
        stat = port(_t(xs[1].astype(jnp.float32)).bfloat16(), lv[0])
    # xs[1] holds the larger absmax: calibrated == dynamic, bit for bit
    assert torch.equal(stat, dyn)
    # the bridge carries JAX's collection strictly, and clears it
    fresh = SparseConvK3(16, 24)
    load_jax_variables(fresh, variables)
    assert torch.equal(fresh.act_absmax, port.act_absmax)
    load_jax_variables(fresh, {"params": variables["params"]})
    assert fresh.act_absmax is None


@pytest.fixture(scope="module")
def seg_net(levels):
    """minkunet14A and its variables with the JAX module's calibrated
    ``q8_stats`` (recorded by a calibration apply under ``"xla"``)."""
    feats, lv_j, _, _ = levels
    jmod = JaxSeg(backbone="minkunet14A", in_channels=3, num_classes=3)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(1), feats, lv_j)
    with sparse_impl("xla"):
        _, q8 = jax.jit(partial(jmod.apply, mutable=["q8_stats"]))(
            variables, feats.astype(jnp.bfloat16), lv_j)
    return jmod, jax.device_get({**variables, **q8})


def _port_seg():
    return RobotNetSegmentation(backbone="minkunet14A", in_channels=3,
                                num_classes=3).eval()


def test_weight_bridge_carries_q8_stats(seg_net):
    """A calibrated stage loads with every ``act_absmax`` mapped and none
    left over; an uncalibrated one loads with none; strict both ways."""
    _, variables = seg_net
    port = _port_seg()
    convs = q8_convs(port)
    leaves = jax.tree_util.tree_leaves(variables["q8_stats"])
    assert len(leaves) == len(convs) > 0
    load_jax_variables(port, variables)
    want = variables["q8_stats"]["unet"]["block1_0"]["conv2"]["act_absmax"]
    np.testing.assert_array_equal(
        dict(convs)["block1.0.conv2"].act_absmax.numpy(), want)
    assert all(m.act_absmax is not None for _, m in convs)
    uncalibrated = {k: v for k, v in variables.items() if k != "q8_stats"}
    load_jax_variables(port, uncalibrated)
    assert all(m.act_absmax is None for _, m in convs)
    assert not any(k.endswith("act_absmax") for k in port.state_dict())
    short = jax.tree_util.tree_map(lambda x: x, variables)
    short["q8_stats"]["unet"].pop("conv0p1s1")
    with pytest.raises(KeyError):
        load_jax_variables(port, short)
    extra = jax.tree_util.tree_map(lambda x: x, variables)
    extra["q8_stats"]["unet"]["final"] = {"act_absmax": np.ones(
        (96,), np.float32)}
    with pytest.raises(KeyError):
        load_jax_variables(port, extra)


def test_int8_segmentation_net_matches_jax(levels, seg_net):
    """minkunet14A, B = 2, 128-aligned capacities: the JAX net under
    ``"pallas-int8"`` (jitted) and the port's int8 net share the weights and
    the JAX-calibrated ``q8_stats``."""
    feats, lv_j, lq_j, lv = levels
    jmod, variables = seg_net
    with sparse_impl("pallas-int8"):
        want = np.asarray(jax.jit(jmod.apply)(
            variables, feats.astype(jnp.bfloat16), lq_j))
    port = _port_seg()
    load_jax_variables(port, variables)
    for _, m in q8_convs(port):
        m.q8 = True
    with torch.no_grad():
        got = port(_t(feats).bfloat16(), lv).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2
    valid = np.asarray(lv_j[0].valid)
    agree = (got.argmax(-1) == want.argmax(-1))[valid].mean()
    assert agree >= 0.995, agree


# ------------------------------------------------------------- engine

ENGINE_CFG = dict(point_capacity=1024, seg_voxel_capacity=768,
                  seg_hierarchy_caps=(512, 256, 128, 128),
                  ee_point_capacity=512, ee_voxel_capacity=512,
                  ee_hierarchy_caps=(256, 128, 64, 64),
                  kp_voxel_capacity=512,
                  kp_hierarchy_caps=(384, 256, 128, 128),
                  seg_backbone="minkunet14A", rot_backbone="minkunet14A",
                  kp_backbone="minkunet14A", icp_iterations=3,
                  icp_template_points=128, conv_impl="pallas-int8")


def test_int8_engine_calibrates_and_predicts():
    eng = InferenceEngine(InferenceConfig(**ENGINE_CFG), device="cpu")
    flags = {st: {m.q8 for _, m in q8_convs(model)}
             for st, model in eng.models().items()}
    # seg and kp in int8; rotation on the bf16 route (64-row levels and all)
    assert flags == {"segmentation": {True}, "rotation": {False},
                     "key_points": {True}}
    pts, rgb, mask = build_batch(2, 1024, seed=1)
    dyn = eng.predict_batch_arrays(pts, rgb, mask)
    assert eng.calibrate_q8(pts, rgb, mask) is eng
    for model in eng.models().values():
        convs = q8_convs(model)
        assert all(m.act_absmax is not None and bool(
            (m.act_absmax >= 0).all()) for _, m in convs)
        assert "conv0p1s1.act_absmax" in model.state_dict()
    out = eng.predict_batch_arrays(pts, rgb, mask)
    poses = torch.cat([out["ee_pose"], out["kp_pose"]])
    assert bool(torch.isfinite(poses).all())
    assert out["segmentation"].shape == (2, 1024)
    # calibrated on this very batch, every conv's absmax is the dynamic one
    assert out.keys() == dyn.keys()
    for k in out:
        assert torch.equal(out[k], dyn[k]), k
    # a state dict of the calibrated engine loads into a fresh one
    other = InferenceEngine(InferenceConfig(**ENGINE_CFG), device="cpu",
                            seed=1)
    for stage, model in other.models().items():
        model.load_state_dict(eng.models()[stage].state_dict())
    again = other.predict_batch_arrays(pts, rgb, mask)
    for k in out:
        assert torch.equal(again[k], out[k]), k


# the other int8 configurations run since the per-conv gate was ported
# (test_torch_q8_routes.py); the case keeps its id
@pytest.mark.parametrize("kw", [pytest.param(dict(conv_impl="triton"),
                                             id="kw5")])
def test_int8_configurations_not_ported_raise(kw):
    with pytest.raises((NotImplementedError, ValueError)):
        InferenceConfig(**{**ENGINE_CFG, **kw})


def test_rotation_int8_on_request():
    cfg = InferenceConfig(**{**ENGINE_CFG, "rot_conv_impl": "pallas-int8",
                             "ee_hierarchy_caps": (256, 128, 128, 128)})
    eng = InferenceEngine(cfg, device="cpu")
    assert {m.q8 for _, m in q8_convs(eng.rot_model)} == {True}
    cfg = InferenceConfig(**{**ENGINE_CFG, "conv_impl": "pallas"})
    eng = InferenceEngine(cfg, device="cpu")
    assert not any(m.q8 for model in eng.models().values()
                   for _, m in q8_convs(model))
