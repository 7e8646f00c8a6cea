"""Segmentation training of the port vs the JAX package (CPU, plain twins).

Inputs are numpy arrays from a seed, handed to both packages:

- voxel labels exact against JAX ``voxelize(labels=...)``;
- ``SparseBatchNorm`` in train mode: output and running statistics within
  1e-6 of ``SparseBatchNorm(train=True)``;
- ``segmentation_loss`` within 1e-6;
- the optimizers over several steps with a per-epoch learning rate within
  1e-6 of ``optax.adamw`` / ``optax.sgd`` as the JAX trainer drives them;
- one whole train step against JAX ``make_segmentation_train_step`` (the
  ``"xla"`` route on CPU) at minkunet14A, B = 2, P = 700, capacity 256:
  loss and accuracy 1e-5; gradients (from ``jax.grad`` of the step's loss)
  relative norm 1e-4 over all parameters and 2e-3 per tensor; the update
  (after - before) relative norm 1e-3 per tensor; BN statistics 1e-5.

  Why per-tensor gradients get 2e-3: the forward passes agree to 1e-6, but
  a ReLU / LeakyReLU gate whose input lies within that of 0 opens in one
  run and not the other, and moves every gradient below it.  Measured on
  this input: perturbing the colours by 3e-6 relative moves the port's own
  gradients by up to 9e-3 per tensor, 1e-7 by 3e-6.  Port and JAX differ by
  4e-5 overall and <= 9e-4 per tensor.  Why the update is compared where
  the gradient is 0 or above 1 % of its tensor's rms: Adam's first step is
  lr * g / (|g| + eps), so where |g| is within the gradient noise (up to
  1e-6 here, against an rms of 5e-5 to 2e-3) its sign and size are noise —
  about a thousand of the 8.3 M entries flip sign.
- ``Trainer.fit`` with checkpoint round trip, retention and resume;
- the train step's device default (the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.models import RobotNetSegmentation as JaxSeg
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu.sparse.nn import SparseBatchNorm as JaxBatchNorm
from mrcc_tpu.train.losses import segmentation_loss as jax_segmentation_loss
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import TrainState, _set_lr
from mrcc_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mrcc_tpu.train.trainer import \
    make_segmentation_train_step as jax_make_segmentation_train_step
from mrcc_tpu_torch.cli.train_mains import train_segmentation
from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset
from mrcc_tpu_torch.data.synthetic import generate_sample
from mrcc_tpu_torch.interop import load_jax_variables, translate_key
from mrcc_tpu_torch.models import RobotNetSegmentation
from mrcc_tpu_torch.sparse import voxelize
from mrcc_tpu_torch.sparse.nn import SparseBatchNorm, init_parameters
from mrcc_tpu_torch.train import (Trainer, TrainConfig, latest_checkpoint,
                                  make_optimizer,
                                  make_segmentation_train_step,
                                  segmentation_loss, step_learning_rate)


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


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------- voxelize

@pytest.mark.parametrize("capacity", [2048, 300])  # 300 overflows
def test_voxel_labels_match_jax(capacity):
    rng = np.random.default_rng(capacity)
    b, p = 2, 1500
    pts = rng.normal(size=(b, p, 3)).astype(np.float32) * 0.3
    pts[:, : p // 2] = np.round(pts[:, : p // 2] / 10 / Q) * Q + Q / 2  # stacks
    rgb = rng.random((b, p, 3)).astype(np.float32)
    mask = rng.random((b, p)) > 0.1
    labels = rng.integers(0, 3, size=(b, p)).astype(np.int32)
    labels[:, : p // 4] = 1  # whole voxels agree
    _, pv_j, lab_j = jax_voxelize(jnp.asarray(pts), jnp.asarray(rgb),
                                  jnp.asarray(mask), Q, capacity,
                                  labels=jnp.asarray(labels))
    vox, pv, lab = voxelize(_t(pts), _t(rgb), _t(mask), Q, capacity,
                            labels=_t(labels))
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(lab_j), lab.numpy())
    np.testing.assert_array_equal(np.asarray(pv_j), pv.numpy())
    kept = lab.numpy()[vox.valid.numpy()]
    if capacity == 300:
        assert int(vox.count.min()) == capacity
    else:  # voxels whose points disagree, and voxels whose points agree
        assert (kept == -100).any() and (kept >= 0).any()
    assert len(voxelize(_t(pts), _t(rgb), _t(mask), Q, capacity)) == 2


# ------------------------------------------------------------ batch norm

@pytest.mark.parametrize("fill", [1.0, 0.3])
def test_train_batchnorm_matches_jax(fill):
    rng = np.random.default_rng(int(fill * 10))
    b, n, c = 2, 300, 24
    x = (rng.normal(size=(b, n, c)) * 2 + 0.5).astype(np.float32)
    valid = rng.random((b, n)) < fill
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32) * 0.1
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = JaxBatchNorm().apply(variables, jnp.asarray(x),
                                     jnp.asarray(valid), train=True,
                                     mutable=["batch_stats"])
    bn = SparseBatchNorm(c).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn.bn, name).copy_(_t(v))
    got = bn(_t(x), _t(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert not got[~_t(valid)].any()
    np.testing.assert_allclose(bn.bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    # eval mode normalises with the running statistics and leaves them
    stats = bn.bn.running_var.clone()
    bn.eval()(_t(x), _t(valid))
    assert torch.equal(bn.bn.running_var, stats)


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("kept", ["some", "none"])
def test_segmentation_loss_matches_jax(kept):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 200, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, size=(2, 200)).astype(np.int32)
    labels[rng.random((2, 200)) < 0.2] = -100
    valid = rng.random((2, 200)) < 0.8
    if kept == "none":
        labels[:] = -100
    want = float(jax_segmentation_loss(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       jnp.asarray(valid)))
    got = float(segmentation_loss(_t(logits), _t(labels), _t(valid)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("optim", ["Adam", "SGD"])
def test_optimizer_matches_optax(optim):
    """Several steps over epochs whose learning rate steps down; a large lr
    and decay make the update visible at f32 next to the parameters."""
    rng = np.random.default_rng(9)
    shapes = {"a": (27, 5, 7), "b": (7,), "c": (3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(lr=0.05, weight_decay=0.1, momentum=0.8, step_epoch=2,
              multiplier=0.5, optim=optim)
    jopt = jax_make_optimizer(JaxTrainConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = make_optimizer(list(tparams.values()), TrainConfig(**kw))
    for epoch in range(1, 6):
        lr = step_learning_rate(kw["lr"], epoch, kw["step_epoch"],
                                kw["multiplier"])
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                   grads.items()}, _set_lr(jstate, lr),
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        for group in topt.param_groups:
            group["lr"] = lr
        topt.step()
        for k in shapes:
            assert _rel(tparams[k].detach(), jparams[k]) <= 1e-6, (epoch, k)


# --------------------------------------------------- one whole train step

def _scene_batch(b=2, p=700, seed=0):
    """Two labelled scenes shrunk 8x about their centre, so that 0.01 m
    voxels fill capacity 256 without overflow (~237 voxels)."""
    out = {"points": np.zeros((b, p, 3), np.float32),
           "feats": np.zeros((b, p, 3), np.float32),
           "labels": np.full((b, p), -100, np.int32),
           "mask": np.zeros((b, p), bool)}
    for i in range(b):
        s = generate_sample(seed=seed + i, n_ee=200, n_arm=250, n_bg=250)
        pts = s["points"] - (s["points"].max(0) + s["points"].min(0)) / 2
        n = len(pts)
        out["points"][i, :n] = pts * 0.12
        out["feats"][i, :n] = s["rgb"]
        out["labels"][i, :n] = s["labels"].astype(np.int32)
        out["mask"][i, :n] = True
    return out


def _randomise(variables, seed):
    """Random BN statistics and affines, small random biases."""
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


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def step_pair():
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
        jmod, JaxDataConfig(), JaxTrainConfig(conv_impl="xla"), CAP)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))
    new_state, metrics = step(state, jb, LR)

    @jax.jit
    def grad_fn(params, batch_stats, b):
        with sparse_impl("xla"):
            vox, _, vlabels = jax_voxelize(b["points"], b["feats"],
                                           b["mask"], Q, CAP,
                                           labels=b["labels"])
            levels = jax_build_hierarchy(vox, 4, capacities=CAPS)

            def loss_fn(p):
                logits, _ = jmod.apply({"params": p,
                                        "batch_stats": batch_stats},
                                       vox.feats, levels, train=True,
                                       mutable=["batch_stats"])
                return jax_segmentation_loss(logits, vlabels, vox.valid)

            return jax.grad(loss_fn)(params)

    grads = grad_fn(variables["params"], variables["batch_stats"], jb)

    port = load_jax_variables(
        RobotNetSegmentation(backbone="minkunet14A", in_channels=3,
                             num_classes=3), variables)
    port_step, _ = make_segmentation_train_step(port, DataConfig(),
                                                TrainConfig(), CAP,
                                                device="cpu")
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    port_metrics = port_step(batch, LR)
    return dict(
        jax_metrics={k: float(v) for k, v in metrics.items()},
        port_metrics={k: float(v) for k, v in port_metrics.items()},
        jax_params=_flat(jax.device_get(new_state.params)),
        jax_old=_flat(variables["params"]),
        jax_stats=_flat(jax.device_get(new_state.batch_stats)),
        jax_grads=_flat(jax.device_get(grads)), port=port, before=before)


def _jax_leaf(flat, name, tensor):
    _, path = translate_key(name)
    arr = flat[path]
    return arr.T if tensor.dim() == 2 else arr  # nn.Linear [out, in]


def test_train_step_loss_and_accuracy(step_pair):
    for k in ("loss", "accuracy"):
        want, got = step_pair["jax_metrics"][k], step_pair["port_metrics"][k]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (k, got, want)
    assert step_pair["port_metrics"]["loss"] > 0.1


def test_train_step_grads(step_pair):
    port = step_pair["port"]
    names = [n for n, _ in port.named_parameters()]
    assert len(names) == len(step_pair["jax_grads"])
    got, want = [], []
    for name, p in port.named_parameters():
        w = _jax_leaf(step_pair["jax_grads"], name, p)
        assert np.linalg.norm(w) > 0, name
        assert _rel(p.grad.numpy(), w) <= 2e-3, (name, _rel(p.grad, w))
        got.append(p.grad.numpy().ravel())
        want.append(w.ravel())
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-4


def test_train_step_update(step_pair):
    port, before = step_pair["port"], step_pair["before"]
    for name, p in port.named_parameters():
        want = (_jax_leaf(step_pair["jax_params"], name, p)
                - _jax_leaf(step_pair["jax_old"], name, p))
        got = (p.detach() - before[name]).numpy()
        g = _jax_leaf(step_pair["jax_grads"], name, p)
        keep = (g == 0) | (np.abs(g) > 1e-2 * np.sqrt((g ** 2).mean()))
        assert keep.mean() > 0.5, name
        assert _rel(got[keep], want[keep]) <= 1e-3, (name, _rel(got, want))


def test_train_step_batchnorm_statistics(step_pair):
    port = step_pair["port"]
    n = 0
    for name, buf in port.named_buffers():
        _, path = translate_key(name)
        want = step_pair["jax_stats"][path]
        assert _rel(buf.numpy(), want) <= 1e-5, name
        n += 1
    assert n == len(step_pair["jax_stats"]) > 0


# ---------------------------------------------------- trainer, entry point

def _tiny_source(cfg):
    return SceneDataset(cfg, 2, seed=3, n_ee=200, n_arm=250, n_bg=250)


def _tiny_trainer(cfg, data, exp_path, seed):
    model = init_parameters(RobotNetSegmentation(backbone="minkunet14A"),
                            seed)
    tc = TrainConfig(batch_size=2, save_freq=4, seed=1)
    step, opt = make_segmentation_train_step(model, cfg, tc, 512,
                                             device="cpu")
    return Trainer(model, data, step, opt, tc, exp_path=str(exp_path),
                   exp_name="seg")


def test_trainer_fit_checkpoints_and_resume(tmp_path):
    cfg = DataConfig(max_points=1024)
    data = _tiny_source(cfg)
    first = _tiny_trainer(cfg, data, tmp_path, seed=0)
    hist = first.fit(2)
    assert [h["batches"] for h in hist] == [1, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert latest_checkpoint(str(tmp_path), "seg").endswith("000000002.ckpt")

    # a new trainer from other weights resumes at epoch 2 with the same
    # model and optimizer state
    second = _tiny_trainer(cfg, data, tmp_path, seed=7)
    assert second.epoch == 2
    for (name, a), b in zip(first.model.state_dict().items(),
                            second.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert (second.optimizer.state_dict()["state"][0]["step"]
            == first.optimizer.state_dict()["state"][0]["step"])
    hist = second.fit(5)
    assert len(hist) == 3
    # epoch 3 was pruned when 4 (a power of two) was saved; 5 is the last
    files = sorted(p.name for p in tmp_path.glob("seg-*.ckpt"))
    assert files == [f"seg-{e:09d}.ckpt" for e in (1, 2, 4, 5)]
    lines = (tmp_path / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 2 * 5  # loss and accuracy per epoch


def test_train_segmentation_main_on_cpu(tmp_path):
    cfg = DataConfig(max_points=1024)
    hist = train_segmentation(TrainConfig(batch_size=2), capacity=512,
                              epochs=2, device="cpu", data_cfg=cfg,
                              dataset=_tiny_source(cfg),
                              backbone="minkunet14A",
                              exp_path=str(tmp_path), exp_name="seg")
    assert len(hist) == 2 and hist[1]["lr"] == 1e-4


def test_train_step_defaults_to_the_card():
    model = RobotNetSegmentation(backbone="minkunet14A")
    if torch.cuda.is_available():
        make_segmentation_train_step(model, DataConfig(), TrainConfig(), 256)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_segmentation_train_step(model, DataConfig(), TrainConfig(),
                                         256)
