"""Port models vs the JAX package: the weight bridge and eval parity (CPU).

The JAX model is initialised, its batch norms and biases are given random
values (so running statistics matter), and the same variables load into the
port module through ``mrcc_tpu_torch.interop.load_jax_variables``.  The
port's state dict then goes back through the JAX package's own
``import_state_dict(strict=True)`` and must give the same tree: the mapping
is one to one from both sides.  Logits / poses agree to relative norm 1e-4
in f32.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.models import RobotNetEncode as JaxEncode
from mrcc_tpu.models import RobotNetSegmentation as JaxSeg
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.train.interop import import_state_dict
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import RobotNetEncode, RobotNetSegmentation
from mrcc_tpu_torch.sparse import build_hierarchy
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


CAPS = (256, 128, 64, 64)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def levels():
    rng = np.random.default_rng(0)
    b, p = 2, 700
    pts = (rng.normal(size=(b, p, 3)) * 0.05).astype(np.float32)
    rgb = rng.random((b, p, 3)).astype(np.float32) - 0.5
    mask = rng.random((b, p)) > 0.05
    vox_j, _, _ = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                               jnp.asarray(mask), 0.005, 512)
    lv_j = jax.jit(partial(jax_build_hierarchy, depth=4,
                           capacities=CAPS))(vox_j)
    lv = build_hierarchy(SparseVoxels(
        off=_t(vox_j.off), key=_t(vox_j.key), feats=_t(vox_j.feats),
        valid=_t(vox_j.valid), count=_t(vox_j.count)), 4, capacities=CAPS)
    return vox_j.feats, lv_j, lv


def _randomise(variables, seed):
    """Random BN statistics/affines and biases (init leaves them trivial)."""
    rng = np.random.default_rng(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.array(v)
            if coll == "batch_stats" and k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k in ("mean", "bias"):
                v = rng.normal(size=v.shape) * 0.1
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {c: walk(jax.device_get(t), c) for c, t in variables.items()}


def _pair(kind, backbone, feats, lv_j):
    if kind == "seg":
        jmod = JaxSeg(backbone=backbone, in_channels=3, num_classes=3)
        port = RobotNetSegmentation(backbone=backbone, in_channels=3,
                                    num_classes=3)
    else:
        jmod = JaxEncode(backbone=backbone, in_channels=3, out_channels=7)
        port = RobotNetEncode(backbone=backbone, in_channels=3,
                              out_channels=7)
    key = (kind, backbone)
    if key not in _VARIABLES:
        _VARIABLES[key] = _randomise(
            jax.jit(jmod.init)(jax.random.PRNGKey(1), feats, lv_j), 2)
    return jmod, port.eval(), _VARIABLES[key]


_VARIABLES = {}  # (kind, backbone) -> randomised JAX variables


@pytest.mark.parametrize("kind", ["seg", "encode"])
@pytest.mark.parametrize("backbone", ["minkunet14A", "minkunet18"])
def test_eval_parity(kind, backbone, levels):
    feats, lv_j, lv = levels
    jmod, port, variables = _pair(kind, backbone, feats, lv_j)
    load_jax_variables(port, variables)
    want = np.asarray(jax.jit(jmod.apply)(variables, feats, lv_j))
    with torch.no_grad():
        got = port(_t(feats), lv).numpy()
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 1e-4, err


@pytest.mark.parametrize("kind", ["seg", "encode"])
def test_weight_bridge_is_strict_both_ways(kind, levels):
    feats, lv_j, _ = levels
    _, port, variables = _pair(kind, "minkunet14A", feats, lv_j)
    load_jax_variables(port, variables)
    # back through the JAX package's own importer, strictly
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = import_state_dict(sd, variables, strict=True)
    flat = lambda t: {p: np.asarray(x) for p, x in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for p in a:
        np.testing.assert_array_equal(a[p], b[p])
    # a JAX leaf missing, or one left over, is refused
    short = jax.tree_util.tree_map(lambda x: x, variables)
    first = next(iter(short["params"]))
    short["params"].pop(first)
    with pytest.raises(KeyError):
        load_jax_variables(port, short)
    extra = jax.tree_util.tree_map(lambda x: x, variables)
    extra["params"]["unused_layer"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_jax_variables(port, extra)
