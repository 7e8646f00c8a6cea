"""The int8 engine's per-conv route vs the JAX int8 engine (CPU).

Under ``conv_impl="pallas-int8"`` the JAX engine decides conv by conv
whether a k3, down or up conv runs in int8: the level must carry the tiled
map that ``build_hierarchy`` builds under ``"pallas-int8"`` and
``sparse/conv.py::_pallas_route_tiled`` must accept the shapes at the
features' itemsize; elsewhere ``conv_kernel_map`` runs the conv in the
features' dtype.  The port's gate is ``sparse.hierarchy.q8_route``.

- the gate equals ``_pallas_route_tiled`` over a grid of (n_in, n_out,
  dtype);
- for each engine configuration that raised before the gate was ported
  (f32 compute; a 64-row seg level; a 448-row kp level; 64-row rotation
  levels under int8; f32 levels of 49152 / 24576 rows in
  ``test_torch_q8_wide.py``), the k3, down
  and up convs around the levels it changes take the JAX route, and their
  outputs
  equal the JAX convs' under ``"pallas-int8"`` (jitted, Pallas in
  interpret mode, over a hierarchy the JAX package builds under
  ``"pallas-int8"``): bf16 outputs to 1 bf16 ulp elementwise, f32 outputs
  to 1e-5 relative; the port engine of that configuration predicts finite
  outputs on the CPU.  The bottleneck backbone: ``test_torch_q8_bottleneck.py``.

The engines are held conv by conv and net by net, not as whole JAX stages:
one JAX int8 stage in interpret mode costs about 70 s of compile on the
CPU, per configuration.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import conv as JC
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.app.inference_engine import _k3_route
from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.sparse import build_hierarchy
from mrcc_tpu_torch.sparse import conv as C
from mrcc_tpu_torch.sparse.hierarchy import q8_route, q8_supported
from mrcc_tpu_torch.sparse.types import SparseVoxels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 2
CIN, COUT = 16, 24
ENGINE_CFG = dict(point_capacity=1024, seg_voxel_capacity=768,
                  seg_hierarchy_caps=(512, 256, 128, 128),
                  ee_point_capacity=512, ee_voxel_capacity=512,
                  ee_hierarchy_caps=(256, 128, 64, 64),
                  kp_voxel_capacity=512,
                  kp_hierarchy_caps=(384, 256, 128, 128),
                  seg_backbone="minkunet14A", rot_backbone="minkunet14A",
                  kp_backbone="minkunet14A", icp_iterations=3,
                  icp_template_points=128, conv_impl="pallas-int8")


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------- the gate

class _Shape:
    def __init__(self, shape, dtype=None):
        self.shape = shape
        self.dtype = dtype


def _jax_route(n_in, n_out, dtype):
    """``_pallas_route_tiled`` under ``"pallas-int8"`` on a map of n_out
    rows (tiles of the JAX conv's own tile, or one row where none fits)."""
    t = next((t for t in (256, 128, 64, 32, 16, 8)
              if n_out % t == 0 and n_out >= t), 1)
    feats = _Shape((B, n_in, 8), dtype)
    tiled = (_Shape((B, n_out // t, 8, t)),)
    with sparse_impl("pallas-int8"):
        return JC._pallas_route_tiled(feats, tiled)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gate_equals_pallas_route_tiled(dtype):
    ns = (8, 24, 32, 64, 96, 128, 160, 448, 512, 768, 1000, 1024, 10240,
          10272, 20480, 24576, 40960, 49152, 65536, 131072, 131080)
    itemsize = jnp.dtype(dtype).itemsize
    accepted = 0
    for n_in in ns:
        for n_out in ns:
            want = _jax_route(n_in, n_out, jnp.dtype(dtype))
            assert q8_supported(n_in, n_out, itemsize) == want, (n_in, n_out)
            accepted += want
    assert 0 < accepted < len(ns) ** 2


# ------------------------------------------------------- per configuration

def _clouds(n_pts, seed, b):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(b, n_pts, 3)) * 0.05).astype(np.float32)
    rgb = (rng.random((b, n_pts, 3)) - 0.5).astype(np.float32)
    mask = rng.random((b, n_pts)) > 0.05
    return pts, rgb, mask


def _hierarchies(cap0, caps, flags, self_keyed, seed=0, n_pts=700, b=B):
    """The JAX hierarchy as its int8 engine builds it (under
    ``"pallas-int8"``, ``k3_self_keyed`` as the engine's ``_k3_sk``) and
    the port's on the same voxels with the engine's table flags."""
    pts, rgb, mask = _clouds(n_pts, seed, b)
    vox, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                             jnp.asarray(mask), 0.005, cap0)
    with sparse_impl("pallas-int8"):
        lq = jax.jit(partial(jax_build_hierarchy, depth=4, capacities=caps,
                             k3_self_keyed=self_keyed))(vox)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox.off), key=_t(vox.key), feats=_t(vox.feats),
        valid=_t(vox.valid), count=_t(vox.count)), 4, capacities=caps,
        k3_tables=flags)
    return vox, lq, lv


def _jax_route_of(conv, feats, lq):
    """Whether the JAX int8 engine runs ``conv`` (kind, level) in int8."""
    kind, l = conv
    with sparse_impl("pallas-int8"):
        def tiled(f, t):
            return t is not None and bool(JC._pallas_route_tiled(f, t))
        if kind == "k3":
            return lq[l].nbr_sk is not None or tiled(feats[l],
                                                     lq[l].nbr_tiled)
        if kind == "down":
            return tiled(feats[l], lq[l + 1].child_tiled)
        return tiled(feats[l + 1], lq[l].up_tiled)


def _port_route_of(conv, lv, itemsize):
    kind, l = conv
    n = [level.valid.shape[1] for level in lv]
    if kind == "k3":
        return lv[l].nbr_idx is None or q8_route("k3", n[l], n[l], itemsize)
    return q8_route(kind, n[l], n[l + 1], itemsize)


def _jax_convs(convs, feats, ws, lq):
    out = []
    for (kind, l), w in zip(convs, ws):
        if kind == "k3":
            out.append(JC.conv_k3(feats[l], w, lq[l]))
        elif kind == "down":
            out.append(JC.conv_down(feats[l], w, lq[l], lq[l + 1]))
        else:
            out.append(JC.conv_transpose_up(feats[l + 1], w, lq[l + 1],
                                            lq[l]))
    return out


def _port_convs(convs, feats, ws, lv):
    out = []
    with torch.no_grad():
        for (kind, l), w in zip(convs, ws):
            if kind == "k3":
                out.append(C.conv_k3(feats[l], w, lv[l], q8=True))
            elif kind == "down":
                out.append(C.conv_down(feats[l], w, lv[l], lv[l + 1],
                                       q8=True))
            else:
                out.append(C.conv_transpose_up(feats[l + 1], w, lv[l + 1],
                                               lv[l], q8=True))
    return out


def _bf16_ulp(x):
    a = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(a, 2.0 ** -126)))
    return 2.0 ** (e - 7)


# name: (engine config over ENGINE_CFG, stage, the convs held (kind,
# level; "up" at l runs level l + 1 -> l), which of them the JAX int8
# engine runs in int8)
CONFIGS = {
    # every table level in int8 on f32 features
    "f32": (dict(compute_dtype="float32"), "seg",
            [("k3", 0), ("down", 0), ("up", 0), ("k3", 4)],
            [True, True, True, True]),
    # the 64-row level: no tiled k3 or down map (bf16 tables and
    # conv_kernel_map); its up map exists and passes the gate
    "seg_64_rows": (dict(seg_hierarchy_caps=(512, 256, 128, 64)), "seg",
                    [("k3", 4), ("down", 3), ("up", 3), ("k3", 3)],
                    [False, False, True, True]),
    # 448 rows: not 128-aligned, the up conv into it passes
    "kp_448_rows": (dict(kp_voxel_capacity=448), "kp",
                    [("k3", 0), ("down", 0), ("up", 0), ("k3", 1)],
                    [False, False, True, True]),
    # the int8 rotation net's 64-row levels
    "rot_64_rows": (dict(rot_conv_impl="pallas-int8"), "rot",
                    [("k3", 3), ("down", 2), ("up", 2), ("up", 3)],
                    [False, False, True, True]),
}


def check_configuration(kw, stage, convs, int8, seed=0):
    """Hold the ``convs`` of an int8 engine configuration's ``stage``
    against the JAX int8 engine's, routes included; run the port engine
    on the CPU where its capacities are small."""
    cfg = InferenceConfig(**{**ENGINE_CFG, **kw})
    eng = InferenceEngine(cfg, device="cpu")
    caps = eng.level_caps[stage]
    flags = _k3_route(cfg, stage, caps)
    assert flags == eng.k3_tables[stage]
    dtype = cfg.compute_dtype
    big = caps[0] > 4096     # one cloud, and no engine run on the CPU
    vox, lq, lv = _hierarchies(caps[0], caps[1:], flags,
                               self_keyed=dtype == "bfloat16",
                               b=1 if big else B)
    # the port builds tables exactly where the JAX engine does not
    # self-key
    assert [level.nbr_idx is not None for level in lv] == [
        level.nbr_sk is None for level in lq]

    rng = np.random.default_rng(seed)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    feats = [jnp.asarray(np.where(np.asarray(level.valid)[..., None],
                                  rng.normal(size=level.valid.shape + (CIN,)),
                                  0.0), jdt) for level in lq]
    assert [_jax_route_of(c, feats, lq) for c in convs] == int8
    assert [_port_route_of(c, lv, jdt.itemsize) for c in convs] == int8

    ws = [(rng.normal(size=(27 if k == "k3" else 8, CIN, COUT))
           / np.sqrt(8 * CIN)).astype(np.float32) for k, _ in convs]
    with sparse_impl("pallas-int8"):
        want = jax.jit(partial(_jax_convs, convs))(
            feats, [jnp.asarray(w) for w in ws], lq)
    got = _port_convs(convs, [_t(f.astype(jnp.float32)).to(tdt)
                              for f in feats], [_t(w) for w in ws], lv)
    for conv, g, x in zip(convs, got, want):
        assert g.dtype == tdt
        g = g.float().numpy()
        x = np.asarray(x, np.float32)
        if dtype == "bfloat16":
            ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(x)))
            assert (np.abs(g - x) <= ulp).all(), conv
        else:
            assert np.linalg.norm(g - x) <= 1e-5 * np.linalg.norm(x), conv
    if big:
        return
    pts, rgb, mask = build_batch(B, 1024, seed=11)
    out = eng.predict_batch_arrays(pts, rgb, mask)
    assert torch.isfinite(out["ee_pose"]).all()
    assert torch.isfinite(out["kp_pose"]).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_configuration_matches_jax(name):
    check_configuration(*CONFIGS[name], seed=len(name))
