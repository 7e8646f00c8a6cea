"""Data-parallel training of the port (2 gloo ranks on the CPU) against
the JAX package's single-process step on the same global batch.

A jitted JAX step on a sharded batch computes the statistics of the whole
padded batch, so the 2-process JAX fleet run is held to the single-process
step (``tests/test_multichip.py::TestFleetTwoProcessTraining``).  The port
keeps those global semantics with explicit reductions (``parallel.mesh``):
the batch norms' counts and sums and the loss's count run over both ranks,
and the gradients are summed over the ranks before the optimizer step.

The setup is ``fleet_train_setup`` (minkunet14A, 8 synthetic scenes of
1024 points, voxel capacity 512, lr 1e-3, 3 steps, the JAX init weights
loaded into the port model).  Each case runs ``Trainer(mesh=...).step`` on
both ranks of ``torch_dp_worker.py`` and checks, at the JAX fleet test's
own tolerances:

- the losses within ``rtol=1e-4, atol=1e-5`` and the parameter norm within
  ``rtol=1e-4`` of the JAX single-process step;
- both ranks' losses, accuracies, parameters and BN statistics bit-equal.

A resumed run: the setup's batch for one step less, a checkpoint of the
first rank only, then a new run on the same per-rank directories in which
the second rank starts from other weights and finds no checkpoint: both
ranks take the first rank's epoch, weights and optimizer state, and after
the last step hold the uninterrupted run's parameters bit for bit.

Cases: the setup's batch; the same batch with the second rank's scenes
cut to a quarter of their points (the shards hold very different numbers
of valid voxels, so a mean of the ranks' means is not the global mean);
and the first 7 scenes, which ``Trainer`` pads to 8 by repeating scene 0
(the JAX side steps on ``mrcc_tpu.parallel.pad_batch_to`` of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.parallel.mesh import pad_batch_to as jax_pad_batch_to
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import RobotNetSegmentation
from test_multichip import fleet_train_setup
from torch_dp_worker import run_ranks

LR = 1e-3
CASES = ("batch", "uneven_valid", "padded_7_to_8")


def _cases(batch_np):
    uneven = {k: v.copy() for k, v in batch_np.items()}
    uneven["mask"][4:, 256:] = False
    uneven["labels"][4:, 256:] = -100
    seven = {k: v[:7] for k, v in batch_np.items()}
    return [batch_np, uneven, seven]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    step, state0, batch_np, n_steps = fleet_train_setup()
    cases = _cases(batch_np)
    jstep = jax.jit(step)
    want = []
    for batch in cases:
        jb = {k: jnp.asarray(v)
              for k, v in jax_pad_batch_to(batch, 8).items()}
        state, losses = state0, []
        for _ in range(n_steps):
            state, metrics = jstep(state, jb, LR)
            losses.append(float(metrics["loss"]))
        pnorm = float(jnp.sqrt(sum(
            jnp.sum(x.astype(jnp.float32) ** 2)
            for x in jax.tree_util.tree_leaves(state.params))))
        want.append((np.asarray(losses), pnorm))
    model = load_jax_variables(
        RobotNetSegmentation(backbone="minkunet14A", in_channels=3,
                             num_classes=3),
        {"params": jax.device_get(state0.params),
         "batch_stats": jax.device_get(state0.batch_stats)})
    tmp = tmp_path_factory.mktemp("train")
    spec = {"state": {k: v.numpy() for k, v in model.state_dict().items()},
            "batches": cases, "lr": LR, "steps": n_steps, "capacity": 512,
            "exp": str(tmp)}
    return want, run_ranks("train", spec, tmp, timeout_s=400), cases


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASES)
def test_two_ranks_match_jax_single_process(run, case):
    want, ranks, _ = run
    losses, pnorm = want[case]
    r0, r1 = (r["cases"][case] for r in ranks)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r0["param_norm"], pnorm, rtol=1e-4)
    # replicated end state: both ranks agree bit for bit
    for k in ("losses", "accuracy", "param_sha", "buffer_sha"):
        assert r0[k] == r1[k], k
    assert losses[-1] < losses[0]


def test_uneven_case_is_uneven(run):
    """The second case's shards differ in their valid points fourfold."""
    mask = run[2][1]["mask"]
    assert mask[:4].sum() > 3 * mask[4:].sum()


def test_resumed_ranks_take_the_first_ranks_state(run):
    _, ranks, _ = run
    r0, r1 = (r["resume"] for r in ranks)
    assert r0["epoch"] == r1["epoch"] == len(ranks[0]["cases"][0]
                                             ["losses"]) - 1
    for k in ("param_sha", "buffer_sha"):
        assert r0[k] == r1[k], k
        # a resumed run steps as the uninterrupted one did
        assert r0[k] == ranks[0]["cases"][0][k], k
