"""Training on the k3-table route: the port vs the JAX package (CPU).

- ``dw_k3_map_plain`` (the k3-table dW's plain twin) against the TPU
  kernel's own wrapper, ``dw_gather_gemm`` over ``build_tiled_maps`` in
  interpret mode, at b = 1, n = 1024, 32 x 32, f32: rtol 2e-3 (the
  tolerance of ``tests/test_conv_pallas.py``'s dW oracle; the kernel sums
  windows in another order), over the port's rank tables of a real level;
  and against ``jax.grad`` of the XLA table conv ``conv_kernel_map``;
- ``K3MapConvFn``'s backward against autograd through the plain forward
  twin, f32, relative norm 1e-5;
- ``train_uses_k3_tables`` against the JAX step's gate
  (``_use_self_keyed`` under the ``"pallas"`` impl) over a grid of level
  sizes, with ``k3_self_keyed`` on and off;
- one segmentation step with ``k3_self_keyed=False`` (every level on
  tables) against JAX ``make_segmentation_train_step`` from the same
  weights, with the tolerances of ``tests/test_torch_train.py``: loss
  1e-5, gradients 1e-4 in relative norm over all parameters, the update
  1e-3 where the gradient is above the noise (ROADMAP C9).  The weights
  are ``tests/test_torch_train.py``'s (seed 2).  On the CPU the table
  route's gradients equal the self-keyed route's bit for bit (the plain
  twins sum in the same order); from another seed (3) both sit 2.5e-4 from
  JAX's alike, the ReLU-gate noise of C9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.models import RobotNetSegmentation as JaxSeg
from mrcc_tpu.ops.conv_pallas import build_tiled_maps, dw_gather_gemm
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.conv import conv_kernel_map
from mrcc_tpu.sparse.hierarchy import _use_self_keyed
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu.train.losses import segmentation_loss as jax_segmentation_loss
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import TrainState
from mrcc_tpu.train.trainer import \
    make_segmentation_train_step as jax_make_segmentation_train_step
from mrcc_tpu_torch.data.dataset import DataConfig
from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import RobotNetSegmentation
from mrcc_tpu_torch.ops import conv
from mrcc_tpu_torch.sparse import (build_hierarchy, train_uses_k3_tables,
                                   voxelize)
from mrcc_tpu_torch.sparse import conv as C
from mrcc_tpu_torch.train import TrainConfig, make_segmentation_train_step
from test_torch_train import _flat, _jax_leaf, _randomise, _rel, _scene_batch


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


Q = 0.01
CAP = 256
CAPS = (256, 128, 64, 64)
LR = 1e-4


@pytest.fixture(scope="module")
def table_level():
    """Level 0 of one scene at 1024 rows (full, 5 cm voxels: ~9 neighbours
    a row), with its rank tables."""
    pts, rgb, mask = build_batch(1, 4096, seed=2)
    vox, _ = voxelize(torch.from_numpy(pts), torch.from_numpy(rgb),
                      torch.from_numpy(mask), 0.05, 1024)
    lv = build_hierarchy(vox, 4, capacities=(512, 256, 128, 64),
                         k3_tables=(True,) + (False,) * 4)[0]
    assert lv.key.shape == (1, 1024) and int(lv.count[0]) == 1024
    assert int(lv.nbr_hit.sum()) > 8 * 1024
    return lv


def _feats(level, c, seed):
    x = np.random.default_rng(seed).normal(size=level.key.shape + (c,))
    return torch.where(level.valid[..., None],
                       torch.from_numpy(x.astype(np.float32)), 0.0)


def test_dw_k3_map_matches_the_tpu_kernel(table_level):
    lv = table_level
    f, g = _feats(lv, 32, 0), _feats(lv, 32, 1)
    got = conv.dw_k3_map(f, g, lv.nbr_idx, lv.nbr_hit)  # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == (27, 32, 32)
    idx, hit = jnp.asarray(lv.nbr_idx.numpy()), jnp.asarray(
        lv.nbr_hit.numpy())
    tiled = build_tiled_maps(idx, hit, 1024)
    want = np.asarray(dw_gather_gemm(jnp.asarray(f.numpy()),
                                     jnp.asarray(g.numpy()), tiled, 27,
                                     cin=32))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)

    # and the weight cotangent of the XLA table conv
    valid = jnp.asarray(lv.valid.numpy())

    def loss(w):
        return (conv_kernel_map(jnp.asarray(f.numpy()), w, idx, hit, valid)
                * jnp.asarray(g.numpy())).sum()

    dw = np.asarray(jax.grad(loss)(jnp.zeros((27, 32, 32), jnp.float32)))
    np.testing.assert_allclose(got.numpy(), dw, rtol=2e-3, atol=2e-3)
    assert _rel(got, dw) <= 1e-5


@pytest.mark.parametrize("cin,cout", [(3, 16), (24, 40)])
def test_k3_map_conv_function_backward(table_level, cin, cout):
    """conv_k3 on a table level under autograd (K3MapConvFn: the table conv
    of g with W[26 - k]^T, the k3-table dW) vs autograd through the plain
    forward twin."""
    lv = table_level
    f0 = _feats(lv, cin, 2)
    w0 = torch.from_numpy(np.random.default_rng(3).normal(
        size=(27, cin, cout)).astype(np.float32) / 5)
    ct = _feats(lv, cout, 4)
    grads = []
    for run in (lambda f, w: C.conv_k3(f, w, lv),
                lambda f, w: conv.gather_gemm_k3_map_plain(
                    f, w, lv.nbr_idx, lv.nbr_hit)):
        f = f0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        (run(f, w) * ct).sum().backward()
        grads.append((f.grad, w.grad))
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("k3_self_keyed", [True, False])
def test_train_route_matches_the_jax_gate(k3_self_keyed):
    for n in (64, 128, 1000, 16384, 20480, 20608, 65536):
        with sparse_impl("pallas"):
            want = not (k3_self_keyed and _use_self_keyed(n))
        assert train_uses_k3_tables(n, k3_self_keyed) == want, n


# ------------------------------------------- one train step on tables

@pytest.fixture(scope="module")
def table_step_pair():
    batch = _scene_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmod = JaxSeg(backbone="minkunet14A", in_channels=3, num_classes=3)

    @jax.jit
    def init(points, feats, mask):
        vox, _, _ = jax_voxelize(points, feats, mask, Q, CAP)
        levels = jax_build_hierarchy(vox, 4, capacities=CAPS)
        return jmod.init(jax.random.PRNGKey(1), vox.feats, levels)

    variables = _randomise(init(jb["points"], jb["feats"], jb["mask"]), 2)
    step, opt = jax_make_segmentation_train_step(
        jmod, JaxDataConfig(), JaxTrainConfig(conv_impl="xla",
                                              k3_self_keyed=False), CAP)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))

    @jax.jit
    def step_and_grads(state, b):
        new_state, metrics = step(state, b, LR)
        with sparse_impl("xla"):
            vox, _, vlabels = jax_voxelize(b["points"], b["feats"],
                                           b["mask"], Q, CAP,
                                           labels=b["labels"])
            levels = jax_build_hierarchy(vox, 4, capacities=CAPS)

            def loss_fn(p):
                logits, _ = jmod.apply({"params": p,
                                        "batch_stats": state.batch_stats},
                                       vox.feats, levels, train=True,
                                       mutable=["batch_stats"])
                return jax_segmentation_loss(logits, vlabels, vox.valid)

            return new_state, metrics, jax.grad(loss_fn)(state.params)

    new_state, metrics, grads = step_and_grads(state, jb)
    port = load_jax_variables(
        RobotNetSegmentation(backbone="minkunet14A", in_channels=3,
                             num_classes=3), variables)
    port_step, _ = make_segmentation_train_step(
        port, DataConfig(), TrainConfig(k3_self_keyed=False), CAP,
        device="cpu")
    levels = port_step.prepare(batch)[2]
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    port_metrics = port_step(batch, LR)
    return dict(
        jax_metrics={k: float(v) for k, v in metrics.items()},
        port_metrics={k: float(v) for k, v in port_metrics.items()},
        jax_params=_flat(jax.device_get(new_state.params)),
        jax_old=_flat(variables["params"]),
        jax_grads=_flat(jax.device_get(grads)), port=port, before=before,
        route=port_step.k3_tables, levels=levels)


def test_table_step_runs_on_tables(table_step_pair):
    assert table_step_pair["route"] == (True,) * 5
    assert all(lv.nbr_idx is not None for lv in table_step_pair["levels"])


def test_table_step_loss(table_step_pair):
    for k in ("loss", "accuracy"):
        want = table_step_pair["jax_metrics"][k]
        got = table_step_pair["port_metrics"][k]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (k, got, want)


def test_table_step_grads(table_step_pair):
    got, want = [], []
    for name, p in table_step_pair["port"].named_parameters():
        w = _jax_leaf(table_step_pair["jax_grads"], name, p)
        assert np.linalg.norm(w) > 0, name
        got.append(p.grad.numpy().ravel())
        want.append(w.ravel())
    assert len(want) == len(table_step_pair["jax_grads"])
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-4


def test_table_step_update(table_step_pair):
    pair = table_step_pair
    for name, p in pair["port"].named_parameters():
        want = (_jax_leaf(pair["jax_params"], name, p)
                - _jax_leaf(pair["jax_old"], name, p))
        got = (p.detach() - pair["before"][name]).numpy()
        g = _jax_leaf(pair["jax_grads"], name, p)
        keep = (g == 0) | (np.abs(g) > 1e-2 * np.sqrt((g ** 2).mean()))
        assert keep.mean() > 0.5, name
        assert _rel(got[keep], want[keep]) <= 1e-3, (name, _rel(got, want))
