"""K2 / K3 plain twins vs the JAX package's ``"xla"`` convolutions (CPU).

The JAX side runs ``conv_k3`` over its searchsorted neighbour tables and
``conv_down`` / ``conv_transpose_up`` over the same hierarchy; the port runs
its self-keyed and map twins.  f32, relative norm <= 1e-5 (summation order
only).  Cases: a cloud touching offset coords 0 and 1023 (border keys alias
across the packed fields), levels whose capacity overflows (parent_ok
false), Cin = 3, and a scattered cloud whose neighbours lie far apart in
key order.

Gradients: ``dfeats`` and ``dW`` of the port's autograd Functions (the
custom-VJP formulas over the reverse maps and the dW twins) against
``jax.grad`` of the JAX functions under ``sparse_impl("xla")``, and against
autograd through the plain forward twins, at the same tolerance.
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
from mrcc_tpu_torch.ops.conv import (gather_gemm_down, gather_gemm_down_plain,
                                     gather_gemm_sk, gather_gemm_sk_plain,
                                     gather_gemm_up, gather_gemm_up_plain)
from mrcc_tpu_torch.sparse import build_hierarchy
from mrcc_tpu_torch.sparse import conv as C
from mrcc_tpu_torch.sparse.types import SparseVoxels

Q = 0.01
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _points(case, rng):
    if case == "border":
        ax = (0, 1, 2, 3, 511, 512, 1020, 1021, 1022, 1023)
        off = np.array([(x, y, z) for x in ax for y in ax for z in ax],
                       np.float32)
        off = off[rng.random(len(off)) < 0.7]
    elif case == "scattered":
        # eight dense blobs spread over the window: k3 neighbours of one
        # blob sit between rows of the others in key order
        centres = rng.integers(40, 984, size=(8, 3))
        off = np.concatenate([c + rng.integers(-4, 5, size=(90, 3))
                              for c in centres]).astype(np.float32)
    else:
        off = np.round(rng.normal(size=(900, 3)) * 6 + 512).astype(np.float32)
    pts = ((off - 512 + 0.5) * Q).astype(np.float32)
    return pts


CASES = {
    # name: (cloud, Cin, Cout, voxel capacity, level capacities)
    "border": ("border", 3, 8, 768, (512, 256, 128, 64)),
    "overflow": ("blob", 16, 12, 512, (128, 64, 32, 16)),
    "cin3": ("blob", 3, 16, 768, (512, 256, 128, 64)),
    "scattered": ("scattered", 24, 20, 768, (512, 256, 128, 64)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cloud, cin, cout, cap, caps = CASES[request.param]
    rng = np.random.default_rng(len(request.param))
    b = 2
    clouds = [_points(cloud, rng) for _ in range(b)]
    n_min = min(700, *(len(c) for c in clouds))
    pts = np.stack([c[:n_min] for c in clouds])
    n_pts = pts.shape[1]
    rgb = rng.random((b, n_pts, 3)).astype(np.float32)
    mask = np.ones((b, n_pts), bool)
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), Q, cap)
    lv_j = jax.jit(partial(jax_build_hierarchy, depth=4,
                           capacities=caps))(vox_j)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox_j.off), key=_t(vox_j.key), feats=_t(vox_j.feats),
        valid=_t(vox_j.valid), count=_t(vox_j.count)), 4, capacities=caps)

    def feats(level, c):
        x = rng.normal(size=level.valid.shape + (c,)).astype(np.float32)
        return np.where(np.asarray(level.valid)[..., None], x, 0.0)

    return dict(name=request.param, cin=cin, cout=cout, lv_j=lv_j, lv=lv,
                feats=feats, rng=rng)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(got.numpy() - want)
                 / max(np.linalg.norm(want), 1e-12))


def test_conv_k3_matches_jax(case):
    lv_j, lv, cin, cout = case["lv_j"], case["lv"], case["cin"], case["cout"]
    for l in (0, 2):
        f = case["feats"](lv[l], cin)
        w = (case["rng"].normal(size=(27, cin, cout)) / 9).astype(np.float32)
        bias = case["rng"].normal(size=(cout,)).astype(np.float32)
        want = jax.jit(JC.conv_k3)(jnp.asarray(f), jnp.asarray(w), lv_j[l],
                                   bias=jnp.asarray(bias))
        got = C.conv_k3(_t(f), _t(w), lv[l], bias=_t(bias))
        assert _rel(got, want) <= TOL
        plain = gather_gemm_sk_plain(_t(f), _t(w), lv[l].key, lv[l].kbits)
        torch.testing.assert_close(
            gather_gemm_sk(_t(f), _t(w), lv[l].key, lv[l].kbits), plain,
            rtol=0, atol=0)
        nobias = jax.jit(JC.conv_k3)(jnp.asarray(f), jnp.asarray(w), lv_j[l])
        assert _rel(plain, nobias) <= TOL
    if case["name"] == "border":
        # the bitmap gates a real aliasing key: without it the result moves
        l0 = lv[0]
        f = _t(case["feats"](l0, cin))
        w = _t((case["rng"].normal(size=(27, cin, cout))).astype(np.float32))
        open_bits = torch.where(l0.valid, (1 << 27) - 1, 0).to(torch.int32)
        assert not torch.allclose(gather_gemm_sk_plain(f, w, l0.key, l0.kbits),
                                  gather_gemm_sk_plain(f, w, l0.key,
                                                       open_bits))


def test_conv_down_matches_jax(case):
    lv_j, lv, cin, cout = case["lv_j"], case["lv"], case["cin"], case["cout"]
    for l in (0, 3):
        f = case["feats"](lv[l], cin)
        w = (case["rng"].normal(size=(8, cin, cout)) / 3).astype(np.float32)
        want = jax.jit(JC.conv_down)(jnp.asarray(f), jnp.asarray(w), lv_j[l],
                                     lv_j[l + 1])
        got = C.conv_down(_t(f), _t(w), lv[l], lv[l + 1])
        assert _rel(got, want) <= TOL
        args = (_t(f), _t(w), lv[l + 1].child_idx, lv[l + 1].child_hit)
        torch.testing.assert_close(gather_gemm_down(*args),
                                   gather_gemm_down_plain(*args), rtol=0,
                                   atol=0)


def test_conv_transpose_up_matches_jax(case):
    lv_j, lv, cin, cout = case["lv_j"], case["lv"], case["cin"], case["cout"]
    for l in (0, 3):
        f = case["feats"](lv[l + 1], cin)
        w = (case["rng"].normal(size=(8, cin, cout)) / 3).astype(np.float32)
        want = jax.jit(JC.conv_transpose_up)(jnp.asarray(f), jnp.asarray(w),
                                             lv_j[l + 1], lv_j[l])
        got = C.conv_transpose_up(_t(f), _t(w), lv[l + 1], lv[l])
        assert _rel(got, want) <= TOL
        row_ok = lv[l].valid & lv[l].parent_ok
        args = (_t(f), _t(w), lv[l].parent_idx, row_ok, lv[l].octant)
        torch.testing.assert_close(gather_gemm_up(*args),
                                   gather_gemm_up_plain(*args), rtol=0,
                                   atol=0)
    if case["name"] == "overflow":
        assert not bool(lv[0].parent_ok[lv[0].valid].all())


# ------------------------------------------------------------ gradients

def _conv_pair(kind, case, l):
    """(JAX fn(f, w), port fn(f, w), plain twin fn(f, w), feats, weights,
    cotangent) of one conv on level l."""
    lv_j, lv, cin, cout = case["lv_j"], case["lv"], case["cin"], case["cout"]
    rng = case["rng"]
    if kind == "k3":
        taps, src, dst = 27, l, l
        jfn = lambda f, w: JC.conv_k3(f, w, lv_j[l])  # noqa: E731
        pfn = lambda f, w: C.conv_k3(f, w, lv[l])  # noqa: E731
        plain = lambda f, w: gather_gemm_sk_plain(  # noqa: E731
            f, w, lv[l].key, lv[l].kbits)
    elif kind == "down":
        taps, src, dst = 8, l, l + 1
        jfn = lambda f, w: JC.conv_down(f, w, lv_j[l], lv_j[l + 1])  # noqa
        pfn = lambda f, w: C.conv_down(f, w, lv[l], lv[l + 1])  # noqa: E731
        plain = lambda f, w: gather_gemm_down_plain(  # noqa: E731
            f, w, lv[l + 1].child_idx, lv[l + 1].child_hit)
    else:
        taps, src, dst = 8, l + 1, l
        jfn = lambda f, w: JC.conv_transpose_up(  # noqa: E731
            f, w, lv_j[l + 1], lv_j[l])
        pfn = lambda f, w: C.conv_transpose_up(  # noqa: E731
            f, w, lv[l + 1], lv[l])
        plain = lambda f, w: gather_gemm_up_plain(  # noqa: E731
            f, w, lv[l].parent_idx, lv[l].valid & lv[l].parent_ok,
            lv[l].octant)
    f = case["feats"](lv[src], cin)
    w = (rng.normal(size=(taps, cin, cout)) / 3).astype(np.float32)
    ct = rng.normal(size=lv[dst].valid.shape + (cout,)).astype(np.float32)
    return jfn, pfn, plain, f, w, ct


def _port_grads(fn, f, w, ct):
    f, w = _t(f).requires_grad_(), _t(w).requires_grad_()
    (fn(f, w) * _t(ct)).sum().backward()
    return f.grad, w.grad


@pytest.mark.parametrize("kind", ["k3", "down", "up"])
def test_conv_grads_match_jax(case, kind):
    for l in (0, 3):
        jfn, pfn, _, f, w, ct = _conv_pair(kind, case, l)
        with sparse_impl("xla"):
            want = jax.jit(jax.grad(
                lambda f, w: jnp.sum(jfn(f, w) * ct), argnums=(0, 1)))(
                    jnp.asarray(f), jnp.asarray(w))
        got = _port_grads(pfn, f, w, ct)
        for g, wj, name in zip(got, want, ("dfeats", "dW")):
            assert _rel(g, wj) <= TOL, (kind, l, name, _rel(g, wj))


@pytest.mark.parametrize("kind", ["k3", "down", "up"])
def test_conv_backward_matches_autograd_of_the_plain_twin(case, kind):
    """The VJP formulas are the exact transpose of the forward twins."""
    _, pfn, plain, f, w, ct = _conv_pair(kind, case, 1)
    got = _port_grads(pfn, f, w, ct)
    want = _port_grads(plain, f, w, ct)
    for g, wt in zip(got, want):
        assert _rel(g, wt.numpy()) <= TOL
