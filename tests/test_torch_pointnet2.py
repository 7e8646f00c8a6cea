"""The dense models vs the JAX package (CPU): PointNet2SSG (B = 2 x 1024
points), PointNet2MSGEncoder (B = 2 x 512) and PointNet (B = 2 x 6).

The JAX variable trees come from ``jax.eval_shape`` and are filled from a
numpy seed (LeCun-scaled kernels, random norm affines and statistics); the
same arrays load into the port through ``interop.load_jax_variables``,
strictly both ways.  Eval-mode outputs agree to 1e-5 in relative norm; a
train-mode forward with JAX's dropout masks installed in the port's dropout
modules (read from ``capture_intermediates``: the mask is where the
dropout's output is nonzero; where its input is 0 the mask does not
matter) to 1e-5, and the running statistics it updates to 1e-6.  The
train-mode forward runs in float64 on both sides (``jax.enable_x64``, the
port's ``.double()``): in f32 a norm over the B = 2 pooled rows (PointNet's
``bn6``, the encoder's head) computes ``E[x^2] - E[x]^2`` of two nearby
values and turns the two sides' ~1e-7 matmul rounding into ~2e-4 (both
sides alike; in f64 they agree to ~1e-12).  The norms
follow flax (ROADMAP C30): decay 0.99, the biased variance as
``E[x^2] - E[x]^2``; on rows whose mean is 50 sigma, with data whose sums
are exact in f32, the port's variance equals flax's bit for bit and
differs from the two-pass variance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mrcc_tpu.models import pointnet2 as JM
from mrcc_tpu_torch.interop import (import_state_dict, jax_path,
                                    load_jax_variables)
from mrcc_tpu_torch.models import pointnet2 as TM
from mrcc_tpu_torch.sparse.nn import init_parameters


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs files in
    parallel workers; torch's default of a thread a core oversubscribes
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fill(shapes, seed, head=None, head_scale=1.0):
    """Random JAX variables of the tree ``shapes``; the kernel of the
    module ``head`` scaled by ``head_scale``."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [p.key for p in path]
        name = keys[-1]
        if name == "kernel":
            out = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
            if head is not None and keys[-2] == head:
                out = out * head_scale
        elif name == "scale":
            out = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            out = 0.1 * rng.normal(size=s.shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _x(seed, b, n, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    x[..., :3] *= 0.1
    return x


MODELS = {
    # name: (JAX module, port module, input, dropout modules in call order)
    "ssg": (lambda: JM.PointNet2SSG(num_classes=6, in_channels=3),
            lambda: TM.PointNet2SSG(num_classes=6, in_channels=3),
            lambda: _x(0, 2, 1024, 6), ("drop",)),
    "msg": (lambda: JM.PointNet2MSGEncoder(num_classes=7),
            lambda: TM.PointNet2MSGEncoder(num_classes=7, in_channels=3),
            lambda: _x(1, 2, 512, 6), ("drop1", "drop2")),
    "pointnet": (lambda: JM.PointNet(out_channels=7),
                 lambda: TM.PointNet(out_channels=7, in_channels=4),
                 lambda: _x(2, 2, 6, 4), ("drop",)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(name, JAX module, its variables, port module loaded with them,
    input)."""
    jm, tm, x, _ = MODELS[request.param]
    jm, x = jm(), x()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    variables = fill(shapes, 3)
    port = load_jax_variables(tm(), jax.device_get(variables))
    return request.param, jm, variables, port, x


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def test_eval_outputs(pair):
    name, jm, variables, port, x = pair
    want = _outputs(jax.jit(jm.apply)(variables, x))
    port.eval()
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < 1e-5, name


def _jax_train(jm, variables, x):
    """A float64 train-mode apply with a fixed dropout key: outputs and
    the updated batch statistics and intermediates (host numpy)."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)

        @jax.jit
        def run(v, x):
            return jm.apply(v, x, train=True, mutable=["batch_stats",
                                                       "intermediates"],
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            capture_intermediates=True)

        return jax.device_get(run(v64, x.astype(np.float64)))


def _dropout_masks(inter):
    """JAX's keep masks in call order: output nonzero (inputs of 0 keep)."""
    drops = sorted(k for k in inter if k.startswith("Dropout_"))
    return [np.asarray(inter[k]["__call__"][0]) != 0 for k in drops]


def test_train_forward_and_running_stats(pair, monkeypatch):
    name, jm, variables, _, x = pair
    port = load_jax_variables(MODELS[name][1](), jax.device_get(variables))
    out, upd = _jax_train(jm, variables, x)
    masks = _dropout_masks(upd["intermediates"])
    mods = MODELS[name][3]
    assert len(masks) == len(mods)
    for mod, mask in zip(mods, masks):
        drop = getattr(port, mod)
        keep = 1.0 - drop.rate
        monkeypatch.setattr(drop, "forward", lambda f, _m=torch.from_numpy(
            mask), _k=keep: torch.where(_m, f / _k, 0.0))
    port = port.double().train()
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(x.astype(np.float64))))
    for g, w in zip(got, _outputs(out)):
        assert _rel(g.numpy(), w) < 1e-5, name
    stats = jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]
    buffers = dict(port.named_buffers())
    names = {jax_path(port, n): n for n in buffers}
    assert len(stats) == len(buffers)
    for path, want in stats:
        key = ("batch_stats", tuple(p.key for p in path))
        assert _rel(buffers[names[key]].numpy(), want) < 1e-6, key


def test_dropout_masks_change_between_calls():
    """The port draws a fresh mask each train-mode call (C28: the JAX
    dense steps reuse one key every step)."""
    net = init_parameters(TM.PointNet(out_channels=7, in_channels=4), 0)
    net.train()
    x = torch.from_numpy(_x(4, 4, 6, 4))
    a, b = net(x), net(x)
    assert not torch.equal(a, b)
    net.eval()
    assert torch.equal(net(x), net(x))


def test_bridge_is_strict_both_ways(pair):
    name, jm, variables, port, _ = pair
    v = jax.device_get(variables)
    # every JAX leaf went to a port tensor and back (no top-level unet)
    assert all(jax_path(port, n)[1][0] != "unet" for n in port.state_dict())
    extra = {"params": dict(v["params"], stray={"kernel": np.ones((2, 2))}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(MODELS[name][1](), extra)
    first = sorted(v["params"])[0]
    short = {"params": {k: t for k, t in v["params"].items() if k != first},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(MODELS[name][1](), short)


def test_pointnet_linear_names():
    """PointNet's ``linear1`` / ``linear2`` keep their names (the bridge's
    ``linear.`` rule is for SparseLinear's child), and its top-level
    ``bn1`` stays at the top (no ``unet`` scope)."""
    net = TM.PointNet(out_channels=7)
    assert jax_path(net, "linear1.weight") == ("params",
                                               ("linear1", "kernel"))
    assert jax_path(net, "linear2.bias") == ("params", ("linear2", "bias"))
    assert jax_path(net, "bn1.bn.running_var") == ("batch_stats",
                                                   ("bn1", "var"))
    ssg = TM.PointNet2SSG()
    assert jax_path(ssg, "sa1.mlp.conv0.weight") == (
        "params", ("sa1", "mlp", "conv0", "kernel"))


def test_reference_pth_names_raise():
    """A reference PointNet2 state dict (``mlp_convs.N`` / ``mlp_bns.N``)
    maps onto no port tensor, and the import raises, as the JAX package's
    strict import does."""
    net = TM.PointNet2SSG(num_classes=6)
    sd = {"sa1.mlp_convs.0.weight": torch.zeros(32, 9, 1, 1),
          "sa1.mlp_bns.0.weight": torch.ones(32)}
    with pytest.raises(KeyError, match="no port tensor"):
        import_state_dict(net, sd)


def _exact_large_mean(seed, b=2, n=128, c=8):
    """Rows at mean 50 sigma whose sums are exact in f32: x = (200 + j) / 4
    for integers j in [-8, 8]; the squares' sum stays under 2^24 sixteenths
    and n is a power of two, so E[x] and E[x^2] are exact in any order."""
    j = np.random.default_rng(seed).integers(-8, 9, size=(b, n, c))
    return ((200 + j) / 4).astype(np.float32)


def test_c30_fast_variance_at_large_mean():
    x = _exact_large_mean(5)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    y_j, upd = bn.apply(variables, x, mutable=["batch_stats"])
    port = TM.PointBatchNorm(8)
    port.train()
    with torch.no_grad():
        y_t = port(torch.from_numpy(x))
    ra_var = port.bn.running_var.numpy()
    np.testing.assert_array_equal(ra_var, np.asarray(
        upd["batch_stats"]["var"]))
    np.testing.assert_array_equal(port.bn.running_mean.numpy(), np.asarray(
        upd["batch_stats"]["mean"]))
    assert _rel(y_t.numpy(), y_j) < 1e-6
    # the fast variance E[x^2] - E[x]^2 (E[x]^2 rounded to f32) is not the
    # two-pass one on these rows; the port's running variance moved to the
    # first, and away from torch's unbiased variance at momentum 0.1
    x64 = x.reshape(-1, 8).astype(np.float64)
    mean = x64.mean(0).astype(np.float32)            # exact
    mean2 = (x64 ** 2).mean(0).astype(np.float32)    # exact
    fast = np.maximum(mean2 - mean * mean, np.float32(0))
    two_pass = x64.var(0)

    def moved(var):
        return (np.float32(0.99) * np.float32(1.0)
                + np.float32(1 - 0.99) * np.float32(var))

    assert np.abs(fast - two_pass).max() > 1e-5
    np.testing.assert_array_equal(ra_var, moved(fast))
    assert (ra_var != moved(two_pass)).any()
    torch_bn = torch.nn.BatchNorm1d(8)
    torch_bn(torch.from_numpy(x.reshape(-1, 8)))
    assert not np.allclose(torch_bn.running_var.detach().numpy(), ra_var,
                           rtol=1e-3)
