"""Metric learning under a data-parallel mesh (ROADMAP C35): 2 gloo ranks
of the port's feature-extractor step against the JAX package's
single-process step on the same global batch.

The JAX step (``mrcc_tpu/cli/train_mains.py:362-383``, assembled as
``tests/test_torch_featurenet.py`` assembles it), jitted over a sharded
batch, mines its triplets over the whole batch.  The port's step gathers
every rank's embeddings and labels before the criterion
(``parallel.mesh.global_batch``); each rank backpropagates the global loss
into its own rows, and the gradients summed over the ranks are the single
process's.

Setup: FeatureNet minkunet14A (the JAX init with randomised BN statistics,
carried across), 6 ``YCBDataset`` clouds of three classes (256 points, 5
mm voxels, capacity 256, every level on k3 tables), lr 1e-4, 3 steps
through ``Trainer(mesh=...).step`` on both ranks of ``torch_dp_worker.py``.
The ranks' shards hold other classes than each other, so a per-rank miner
would pair other triplets.  Checked at ``test_torch_parallel_train.py``'s
tolerances: losses ``rtol=1e-4, atol=1e-5`` and the parameter norm
``rtol=1e-4`` against the JAX step, both ranks' losses, parameters and BN
statistics bit-equal; and each step's summed gradient norm ``rtol=1e-4``
(Adam's update is blind to a gradient's scale, so a gather whose backward
hands each rank R times its share would pass the rest).

Cases: the 6 clouds, and the first 5, which ``Trainer`` pads to 6 by
repeating cloud 0 whole, as the JAX trainer does (the JAX side steps on
``mrcc_tpu.parallel.pad_batch_to`` of them): the duplicate mines as a
positive of cloud 0 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrcc_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from mrcc_tpu.parallel.mesh import pad_batch_to as jax_pad_batch_to
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.train import metric_learning as jml
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import TrainState, _set_lr
from mrcc_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mrcc_tpu_torch.data.ycb import YCBDataset
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import FeatureNet
from test_torch_train import _randomise
from torch_dp_worker import run_ranks

Q = 1 / 200.0
CAP = 256
CAPS = (CAP, CAP // 2, CAP // 4, CAP // 8)  # the JAX main's halving
LR = 1e-4
STEPS = 3
CASES = ("six_clouds", "five_padded_to_six")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    ds = YCBDataset(num_classes=3, samples_per_class=2, max_points=CAP,
                    seed=4)
    batch = ds.collate([ds[i] for i in range(len(ds))])
    batch = {k: v for k, v in batch.items() if k != "others"}
    return [batch, {k: v[:5] for k, v in batch.items()}]


def _jax_runs(batches):
    """The JAX step's losses and end parameter norm per case, and the
    initial variables."""
    jmod = JaxFeatureNet(in_channels=3, out_channels=16,
                         backbone="minkunet14A")
    optimizer = jax_make_optimizer(JaxTrainConfig())

    def hierarchy(b):
        vox, _, _ = jax_voxelize(b["points"], b["feats"], b["mask"], Q, CAP)
        return vox, jax_build_hierarchy(vox, 4, capacities=CAPS)

    first = {k: jnp.asarray(v) for k, v in batches[0].items()}

    @jax.jit
    def init(b):
        vox, levels = hierarchy(b)
        return jmod.init(jax.random.PRNGKey(1), vox.feats, levels)

    variables = _randomise(init(first), 2)

    @jax.jit
    def step(state, batch, lr):  # train_mains.py:362-383
        vox, levels = hierarchy(batch)

        def loss_fn(params):
            emb, updates = jmod.apply(
                {"params": params, "batch_stats": state.batch_stats},
                vox.feats, levels, train=True, mutable=["batch_stats"])
            return jml.triplet_margin_loss(emb, batch["labels"]), updates

        (loss, updates), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        opt_state = _set_lr(state.opt_state, lr)
        upd, opt_state = optimizer.update(grads, opt_state, state.params)
        params = optax.apply_updates(state.params, upd)
        gnorm = jnp.sqrt(sum(jnp.sum(g ** 2)
                             for g in jax.tree_util.tree_leaves(grads)))
        return state.replace(params=params,
                             batch_stats=updates["batch_stats"],
                             opt_state=opt_state), loss, gnorm

    want = []
    for batch in batches:
        jb = {k: jnp.asarray(v) for k, v in
              jax_pad_batch_to(batch, 6).items()}
        state = TrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=optimizer.init(variables["params"]))
        losses, gnorms = [], []
        for _ in range(STEPS):
            state, loss, gnorm = step(state, jb, LR)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
        pnorm = float(jnp.sqrt(sum(
            jnp.sum(x.astype(jnp.float32) ** 2)
            for x in jax.tree_util.tree_leaves(state.params))))
        want.append((np.asarray(losses), np.asarray(gnorms), pnorm))
    return want, variables


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    batches = _batches()
    want, variables = _jax_runs(batches)
    model = load_jax_variables(FeatureNet(backbone="minkunet14A"), variables)
    tmp = tmp_path_factory.mktemp("metric")
    spec = {"state": {k: v.numpy() for k, v in model.state_dict().items()},
            "batches": batches, "lr": LR, "steps": STEPS, "capacity": CAP,
            "max_points": CAP, "exp": str(tmp)}
    return want, run_ranks("metric", spec, tmp, timeout_s=400), batches


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASES)
def test_two_ranks_match_jax_single_process(run, case):
    want, ranks, _ = run
    losses, gnorms, pnorm = want[case]
    r0, r1 = (r["cases"][case] for r in ranks)
    assert losses[0] > 0
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-5)
    # Adam's update does not see a gradient's scale: a gather whose
    # backward summed the ranks' whole-loss cotangents would pass the
    # losses and parameters with twice the gradient, so the summed
    # gradient itself is held too
    np.testing.assert_allclose(r0["grad_norms"], gnorms, rtol=1e-4)
    np.testing.assert_allclose(r0["param_norm"], pnorm, rtol=1e-4)
    for k in ("losses", "grad_norms", "param_sha", "buffer_sha"):
        assert r0[k] == r1[k], k


def test_shards_hold_other_classes(run):
    """Each rank's shard of the six clouds lacks a class the other holds,
    so a miner per rank would pair other triplets than the global one."""
    labels = np.asarray(run[2][0]["labels"])
    assert set(labels[:3]) != set(labels[3:])
    assert len(set(labels)) == 3
