"""The sparse ResNet family and its layers vs the JAX package (CPU).

The JAX modules' variable trees come from ``jax.eval_shape`` (no init
compile) and are filled from a numpy seed: He-normal kernels, random batch
norm statistics and affines, random biases.  The same arrays load into the
port through ``interop.load_jax_variables`` (strictly: every leaf used,
every port tensor assigned).  Eval-mode logits agree to relative norm 1e-4
in f32 and 2e-2 in bf16 (the stem's instance norm computes its statistics
in the feature dtype on both sides: bf16's own noise).  The strided map
conv, the child max pool, the instance norm and the tanh GELU are each
held against the JAX function.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.models.resnet_sparse import SparseResFieldNet as JaxFieldNet
from mrcc_tpu.models.resnet_sparse import SparseResNetBase as JaxResNet
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import conv as jax_conv
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.hierarchy import downsample_level as jax_downsample
from mrcc_tpu.sparse.nn import SparseInstanceNorm as JaxInstanceNorm
from mrcc_tpu_torch.interop import jax_path, load_jax_variables
from mrcc_tpu_torch.models import (SparseResFieldNet, SparseResNet14,
                                   SparseResNet50, SparseResNetBase)
from mrcc_tpu_torch.sparse import build_hierarchy, downsample_level
from mrcc_tpu_torch.sparse import conv as C
from mrcc_tpu_torch.sparse.nn import (SparseDropout, SparseInstanceNorm,
                                      gelu)
from mrcc_tpu_torch.sparse.types import SparseVoxels

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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
def cloud():
    """tests/test_resnet.py's cloud: B = 2 (one item 500 points), 1 cm
    voxels, capacity 1024, as a depth-0 hierarchy on both sides."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 800, 3)).astype(np.float32) * 0.3
    rgb = rng.normal(size=(2, 800, 3)).astype(np.float32)
    mask = np.ones((2, 800), bool)
    mask[1, 500:] = False
    vox, _, _ = jax_voxelize(pts, rgb, mask, 1 / 100.0, capacity=1024)
    (l0_j,) = jax_build_hierarchy(vox, depth=0)
    (l0,) = build_hierarchy(SparseVoxels(
        off=_t(vox.off), key=_t(vox.key), feats=_t(vox.feats),
        valid=_t(vox.valid), count=_t(vox.count)), 0)
    return vox.feats, l0_j, l0


def _fill(shapes, seed):
    """Numpy values for a JAX variable tree of ShapeDtypeStructs."""
    rng = np.random.default_rng(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            shape = v.shape
            if coll == "batch_stats" and k == "var":
                x = rng.uniform(0.5, 1.5, shape)
            elif k in ("mean", "bias"):
                x = rng.normal(size=shape) * 0.1
            elif k == "scale":
                x = rng.uniform(0.8, 1.2, shape)
            else:  # kernels: He-normal over the output width
                x = rng.normal(size=shape) * np.sqrt(2.0 / shape[-1])
            out[k] = x.astype(np.float32)
        return out

    return {c: walk(t, c) for c, t in shapes.items()}


def _variables(jmod, feats, level, seed):
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), feats, level)
    return _fill(jax.tree_util.tree_map(lambda x: x, shapes), seed)


NARROW = dict(planes=(8, 8, 8, 8), init_dim=8)
MODELS = {
    "resnet14": (lambda: JaxResNet(3, 5, layers=(1, 1, 1, 1), **NARROW),
                 lambda: SparseResNet14(3, 5, **NARROW)),
    "resnet50": (lambda: JaxResNet(3, 4, layers=(3, 4, 6, 3),
                                   block="bottleneck", planes=(4, 4, 4, 4),
                                   init_dim=8),
                 lambda: SparseResNet50(3, 4, planes=(4, 4, 4, 4),
                                        init_dim=8)),
    "resfieldnet": (lambda: JaxFieldNet(3, 5),
                    lambda: SparseResFieldNet(3, 5)),
}


@pytest.fixture(scope="module")
def pairs(cloud):
    feats, l0_j, _ = cloud
    out = {}
    for i, (name, (jax_make, port_make)) in enumerate(MODELS.items()):
        jmod = jax_make()
        variables = _variables(jmod, feats, l0_j, seed=10 + i)
        port = load_jax_variables(port_make(), variables).eval()
        out[name] = (jmod, port, variables)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(name, dtype, cloud, pairs):
    feats, l0_j, l0 = cloud
    jmod, port, variables = pairs[name]
    want = np.asarray(jax.jit(jmod.apply)(variables, feats.astype(dtype),
                                          l0_j), np.float32)
    with torch.no_grad():
        got = port(_t(feats).to(getattr(torch, dtype)), l0)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    err = _rel(got.numpy(), want)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_load_strictly_and_read_back(name, pairs):
    jmod, port, variables = pairs[name]
    state = port.state_dict()
    flat = {(c, tuple(k.key for k in p)): np.asarray(v) for c in variables
            for p, v in jax.tree_util.tree_flatten_with_path(
                variables[c])[0]}
    assert len(state) == len(flat)
    for key, tensor in state.items():
        arr = flat[jax_path(port, key)]
        if arr.ndim == 2:
            arr = arr.T
        np.testing.assert_array_equal(tensor.numpy(), arr, err_msg=key)
    # ResNet's top-level `final` and raw kernels are not under `unet`
    assert all(p[0] != "unet" for _, p in map(
        partial(jax_path, port), state))
    broken = {c: dict(t) for c, t in variables.items()}
    broken["params"] = {k: v for k, v in broken["params"].items()
                        if k != "final" and k != "resnet"}
    with pytest.raises(KeyError):
        load_jax_variables(MODELS[name][1](), broken)


def test_resnet_depths_build():
    """ResNet18 / 34 / 101 instantiate with the JAX layer counts."""
    from mrcc_tpu_torch.models import (SparseResNet18, SparseResNet34,
                                       SparseResNet101)

    for make, layers in ((SparseResNet18, (2, 2, 2, 2)),
                         (SparseResNet34, (3, 4, 6, 3)),
                         (SparseResNet101, (3, 4, 23, 3))):
        net = make(3, 4, **NARROW)
        assert tuple(len(getattr(net, f"layer{i + 1}"))
                     for i in range(4)) == layers


@pytest.fixture(scope="module")
def strided(cloud):
    """The stem's k3 s2 level and conv5's k3 s3 level on both sides."""
    _, l0_j, l0 = cloud
    out = {}
    for stride, cap in ((2, 512), (3, 256)):
        _, jc = jax.jit(partial(jax_downsample, capacity=cap, stride=stride,
                                kernel_size=3))(l0_j)
        _, pc = downsample_level(l0, cap, stride=stride, kernel_size=3)
        out[stride] = (jc, pc)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [2, 3])
def test_conv_kernel_map_strided(stride, dtype, cloud, strided):
    _, l0_j, l0 = cloud
    jc, pc = strided[stride]
    rng = np.random.default_rng(stride)
    f = rng.normal(size=(2, l0.key.shape[1], 6)).astype(np.float32)
    f = f * l0.valid.numpy()[..., None]
    w = rng.normal(size=(27, 6, 10)).astype(np.float32) * 0.3
    bias = rng.normal(size=(10,)).astype(np.float32)
    want = jax_conv.conv_kernel_map(
        jnp.asarray(f, dtype), jnp.asarray(w), jc.child_idx, jc.child_hit,
        jc.valid, bias=jnp.asarray(bias))
    got = C.conv_kernel_map(_t(f).to(getattr(torch, dtype)), _t(w),
                            pc.child_idx, pc.child_hit, pc.valid,
                            bias=_t(bias))
    assert got.dtype == getattr(torch, dtype)
    err = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert err <= TOL[dtype], err
    assert (got[~pc.valid] == 0).all()


def test_conv_kernel_map_refuses_autograd(strided):
    _, pc = strided[2]
    n_in = int(pc.child_idx.max()) + 1
    f = torch.randn(2, n_in, 3, requires_grad=True)
    with pytest.raises(ValueError, match="inference only"):
        C.conv_kernel_map(f, torch.randn(27, 3, 4), pc.child_idx,
                          pc.child_hit, pc.valid)
    with torch.no_grad():
        C.conv_kernel_map(f, torch.randn(27, 3, 4), pc.child_idx,
                          pc.child_hit, pc.valid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_down(dtype, cloud):
    _, l0_j, l0 = cloud
    jf, jc = jax.jit(partial(jax_downsample, capacity=200, stride=2,
                             kernel_size=2))(l0_j)
    pf, pc = downsample_level(l0, 200, stride=2, kernel_size=2)
    rng = np.random.default_rng(4)
    f = rng.normal(size=(2, l0.key.shape[1], 5)).astype(np.float32) - 2.0
    want = jax_conv.max_pool_down(jnp.asarray(f, dtype), jf, jc)
    got = C.max_pool_down(_t(f).to(getattr(torch, dtype)), pf, pc)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert (~pf.parent_ok & l0.valid).any()  # an overflowing capacity
    assert (got[~pc.valid] == 0).all() and (got[pc.valid] < 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm(dtype, cloud):
    _, _, l0 = cloud
    rng = np.random.default_rng(5)
    valid = l0.valid.numpy()
    f = (rng.normal(size=(2, valid.shape[1], 7)) * 3 + 1).astype(np.float32)
    f = f * valid[..., None]
    variables = {"params": {
        "scale": rng.uniform(0.8, 1.2, 7).astype(np.float32),
        "bias": (rng.normal(size=7) * 0.1).astype(np.float32)}}
    want = JaxInstanceNorm().apply(variables, jnp.asarray(f, dtype),
                                   jnp.asarray(valid))
    norm = SparseInstanceNorm(7)
    with torch.no_grad():
        norm.scale.copy_(_t(variables["params"]["scale"]))
        norm.bias.copy_(_t(variables["params"]["bias"]))
        got = norm(_t(f).to(getattr(torch, dtype)), l0.valid)
    assert got.dtype == torch.float32  # f32 parameters promote, as in JAX
    err = _rel(got.numpy(), np.asarray(want, np.float32))
    assert err <= (1e-6 if dtype == "float32" else TOL[dtype]), err
    assert (got[~l0.valid] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_tanh_form(dtype):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, dtype)), np.float32)
    got = gelu(_t(x).to(getattr(torch, dtype))).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6
                               if dtype == "float32" else 2e-2)
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4  # not torch's default erf form


def test_dropout_train_mask_and_scale():
    drop = SparseDropout(0.3, seed=11)
    x = torch.ones(4, 5000, 8)
    drop.train()
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    y2 = drop(x)
    assert not torch.equal(y, y2)        # the generator moves on
    again = SparseDropout(0.3, seed=11).train()
    assert torch.equal(again(x), y)      # and is seeded
    drop.eval()
    assert torch.equal(drop(x), x)


def test_resnet_forward_in_train_mode_needs_no_grad(cloud, pairs):
    """Train mode (batch statistics, dropout) runs under no_grad; with
    autograd recording, the strided map conv refuses."""
    feats, _, l0 = cloud
    port = copy.deepcopy(pairs["resnet14"][1]).train()
    with torch.no_grad():
        out = port(_t(feats), l0)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="inference only"):
        port(_t(feats), l0)


def test_resnet_base_defaults_are_the_published_widths():
    with torch.device("meta"):  # shapes only, no storage
        net = SparseResNetBase(3, 10, layers=(3, 4, 6, 3),
                               block="bottleneck")
    assert tuple(net.stem_kernel.shape) == (27, 3, 64)
    assert tuple(net.conv5_kernel.shape) == (27, 2048, 2048)
    assert net.conv5_kernel.numel() == 113_246_208
    assert sum(p.numel() for p in net.parameters()) == 152_794_058
