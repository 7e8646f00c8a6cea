"""Metric learning of the port vs the JAX package (CPU, plain twins).

- The criterion on embeddings from seeds: the miner's masks exactly, the
  loss within 1e-6, its gradient against ``jax.grad`` within 1e-5; the
  cases are a batch of four classes, a batch whose classes lie far apart
  (no triple is mined: loss 0, gradient 0) and a batch with repeated
  embeddings (the last two on a 1/16 grid, so that every distance is
  exact on both sides).  No mined triple's hinge is within 1e-6 of 0 (asserted):
  ties take JAX's half gradient by construction, but none is tested.
- ``FeatureNet``'s forward (train mode) against JAX's from the same
  variables: minkunet14A inside the step below, and minkunet34A once at
  B = 2, capacity 256, for its planes; 1e-5.
- One feature step (minkunet14A, B = 4 clouds of two classes, 5 mm
  voxels, capacity 256, every level on k3 tables) against the JAX step
  assembled as ``mrcc_tpu/cli/train_mains.py:348-383`` assembles it, in
  float64 on both sides (in f32 the update sat 2.4e-3 from JAX on one
  CPU, the JAX step's own spread under a 1e-7 input move 1.8e-3: ROADMAP
  C21): loss 1e-5, gradients 1e-4 in relative norm over all parameters,
  the update 1e-3 where the gradient is above the noise (ROADMAP C9).
- ``YCBDataset`` items and batches exactly; ``train_feature_extractor``
  for one epoch on the CPU, and its device default.
- The weight bridge for ``RobotNetVote`` (the ``seg`` scope) and
  ``FeatureNet`` (``final_bn`` beside ``unet``), strict both ways
  (ROADMAP C22): every port tensor takes the JAX leaf at its path bit for
  bit and every leaf is used; a missing or an extra leaf raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrcc_tpu.data.ycb import YCBDataset as JaxYCBDataset
from mrcc_tpu.models import RobotNetVote as JaxVote
from mrcc_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.train import metric_learning as jml
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import TrainState, _set_lr
from mrcc_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mrcc_tpu_torch.cli.train_mains import train_feature_extractor
from mrcc_tpu_torch.data.ycb import YCBDataset
from mrcc_tpu_torch.interop import (jax_path, load_jax_variables,
                                    translate_key)
from mrcc_tpu_torch.models import FeatureNet, RobotNetVote
from mrcc_tpu_torch.sparse import build_hierarchy, voxelize
from mrcc_tpu_torch.train import (TrainConfig,
                                  make_metric_learning_train_step)
from mrcc_tpu_torch.train import metric_learning as ml
from test_torch_train import _batch64, _flat, _randomise, _rel, _tree64


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


Q = 1 / 200.0
CAP = 256
CAPS = (CAP, CAP // 2, CAP // 4, CAP // 8)  # the JAX main's halving
LR = 1e-4


# ------------------------------------------------------------ criterion

def _embeddings(case):
    rng = np.random.default_rng(3)
    if case == "classes":
        labels = np.repeat(np.arange(4), 3)
        emb = rng.normal(size=(12, 16)) * 0.3
    elif case == "apart":  # tight classes 4 apart: nothing is mined
        labels = np.repeat(np.arange(3), 3)
        emb = np.round(rng.normal(size=(9, 16)) * 0.5) / 16
        emb[:, 0] += labels * 4.0
    else:  # repeats within a class and across classes
        labels = np.array([0, 0, 0, 1, 1, 1, 2, 2])
        emb = np.round(rng.normal(size=(8, 16)) * 4) / 16
        emb[1] = emb[0]
        emb[6] = emb[3]
    return emb.astype(np.float32), labels.astype(np.int32)


@pytest.mark.parametrize("case", ["classes", "apart", "repeats"])
def test_criterion_matches_jax(case):
    emb, labels = _embeddings(case)
    je, jl = jnp.asarray(emb), jnp.asarray(labels)
    te, tl = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(labels)
    want_pos, want_neg = jml.multi_similarity_miner(je, jl)
    got_pos, got_neg = ml.multi_similarity_miner(te.detach(), tl)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_neg.numpy(), np.asarray(want_neg))
    # the grid cases (apart, repeats) sit on a 1/16 grid: their distances
    # are exact on both sides, where the formula's f32 cancellation would
    # otherwise show each package's summation order
    # off the diagonal: d_ii is the root of |a|^2 + |a|^2 - 2 a.a, rounding
    # noise in each package's summation order, and no triple reads it
    off = ~np.eye(len(labels), dtype=bool)
    np.testing.assert_allclose(ml.pairwise_dist(te.detach()).numpy()[off],
                               np.asarray(jml.pairwise_dist(je))[off],
                               rtol=1e-6, atol=1e-6)

    want, want_g = jax.value_and_grad(jml.triplet_margin_loss)(je, jl)
    got = ml.triplet_margin_loss(te, tl)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)

    d = np.asarray(jml.pairwise_dist(je))
    w = np.asarray(want_pos)[:, :, None] & np.asarray(want_neg)[:, None, :]
    hinge = d[:, :, None] - d[:, None, :] + 0.05
    assert not (np.abs(hinge[w]) < 1e-6).any()  # no tie
    if case == "apart":
        assert float(got) == 0.0 and not w.any()
        assert not te.grad.any()
    else:
        assert float(got) > 0 and w.any()


def test_criterion_pair():
    loss, miner = ml.get_criterion()
    assert loss is ml.triplet_margin_loss
    assert miner is ml.multi_similarity_miner


# ------------------------------------------------- FeatureNet and a step

def _ycb_batch():
    ds = YCBDataset(num_classes=2, samples_per_class=2, max_points=256,
                    seed=4)
    return ds.collate([ds[i] for i in range(len(ds))])


def feature_step_pair(float64=True, move=0.0):
    """One feature step of each package from the same weights and batch
    (its colours times ``1 + move``), in float64 on both sides unless
    ``float64`` is False, and the JAX f32 embeddings before it."""
    batch = _ycb_batch()
    batch["feats"] = (batch["feats"] * np.float32(1 + move)).astype(
        np.float32)
    jmod = JaxFeatureNet(in_channels=3, out_channels=16,
                         backbone="minkunet14A")
    train_cfg = JaxTrainConfig()
    optimizer = jax_make_optimizer(train_cfg)

    def hierarchy(b):
        vox, _, _ = jax_voxelize(b["points"], b["feats"], b["mask"], Q, CAP)
        return vox, jax_build_hierarchy(vox, 4, capacities=CAPS)

    @jax.jit
    def init(b):
        vox, levels = hierarchy(b)
        return jmod.init(jax.random.PRNGKey(1), vox.feats, levels)

    @jax.jit
    def embed(variables, b):
        vox, levels = hierarchy(b)
        return jmod.apply(variables, vox.feats, levels, train=True,
                          mutable=["batch_stats"])[0]

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomise(init(jb), 2)
    emb = np.asarray(embed(variables, jb))
    jbatch, jvars = batch, variables
    if float64:
        jbatch, jvars = _batch64(batch), _tree64(variables)

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
        return (state.replace(params=params,
                              batch_stats=updates["batch_stats"],
                              opt_state=opt_state),
                {"loss": loss}, grads)

    with jax.enable_x64(float64):
        state = TrainState(params=jvars["params"],
                           batch_stats=jvars["batch_stats"],
                           opt_state=optimizer.init(jvars["params"]))
        new_state, metrics, grads = jax.device_get(jax.jit(step)(
            state, {k: jnp.asarray(v) for k, v in jbatch.items()}, LR))
    port = load_jax_variables(FeatureNet(backbone="minkunet14A"), variables)
    if float64:
        port.double()
    port_step, _ = make_metric_learning_train_step(
        port, YCBDataset(num_classes=1, samples_per_class=1,
                         max_points=256).cfg, TrainConfig(), CAP,
        device="cpu")
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    port_metrics = port_step(jbatch, LR)
    return dict(
        batch=batch, variables=variables, jax_emb=emb,
        step=port_step, jax_loss=float(metrics["loss"]),
        port_loss=float(port_metrics["loss"]),
        jax_params=_flat(new_state.params),
        jax_old=_flat(jvars["params"]),
        jax_stats=_flat(new_state.batch_stats),
        jax_grads=_flat(grads), port=port, before=before)


@functools.lru_cache(maxsize=None)
def _feature_pair():
    """The feature step in float64 on both sides (ROADMAP C21: in f32 a
    ReLU gate at the forward's rounding noise moves the update past
    1e-3)."""
    return feature_step_pair()


def _leaf(flat, model, name, tensor):
    arr = flat[jax_path(model, name)[1]]
    return arr.T if tensor.dim() == 2 else arr


def _port_embed(model, batch, caps=CAPS):
    b = {k: torch.from_numpy(batch[k]) for k in ("points", "feats", "mask")}
    with torch.no_grad():
        vox, _ = voxelize(b["points"], b["feats"], b["mask"], Q, CAP)
        levels = build_hierarchy(vox, 4, capacities=caps)
        return model.train()(vox.feats, levels).numpy()


def test_feature_forward_matches_jax():
    pair = _feature_pair()
    port = load_jax_variables(FeatureNet(backbone="minkunet14A"),
                              pair["variables"])
    got = _port_embed(port, pair["batch"])
    assert got.shape == pair["jax_emb"].shape == (4, 16)
    np.testing.assert_allclose(got, pair["jax_emb"], rtol=1e-5, atol=1e-5)


def test_feature_forward_34a_matches_jax():
    """MinkUNet34A's planes and blocks, B = 2 at capacity 256."""
    batch = {k: v[1:3] for k, v in _ycb_batch().items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmod = JaxFeatureNet(in_channels=3, out_channels=16,
                         backbone="minkunet34A")

    @jax.jit
    def init_and_apply(b):
        vox, _, _ = jax_voxelize(b["points"], b["feats"], b["mask"], Q, CAP)
        levels = jax_build_hierarchy(vox, 4, capacities=CAPS)
        variables = jmod.init(jax.random.PRNGKey(5), vox.feats, levels)
        emb, _ = jmod.apply(variables, vox.feats, levels, train=True,
                            mutable=["batch_stats"])
        return variables, emb

    variables, want = init_and_apply(jb)
    port = load_jax_variables(FeatureNet(), jax.device_get(variables))
    assert len(port.block4) == 6 and port.final.kernel.shape[1:] == (64, 16)
    got = _port_embed(port, batch)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_feature_step_loss_and_route():
    pair = _feature_pair()
    assert pair["jax_loss"] > 0
    assert abs(pair["port_loss"] - pair["jax_loss"]) <= 1e-5 * pair["jax_loss"]
    assert pair["step"].caps == CAPS
    assert pair["step"].k3_tables == (True,) * 5


def test_feature_step_grads():
    pair = _feature_pair()
    port = pair["port"]
    got, want = [], []
    for name, p in port.named_parameters():
        got.append(p.grad.numpy().ravel())
        want.append(_leaf(pair["jax_grads"], port, name, p).ravel())
    assert len(want) == len(pair["jax_grads"])
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-4


def test_feature_step_update_and_statistics():
    """As the segmentation step's update check, but for ``final.bias``: it
    feeds the train-mode ``final_bn``, whose batch mean cancels it, so its
    exact gradient is 0 and both packages give rounding noise (~1e-8
    against a model rms of ~1e-3) that Adam's first step turns into
    +-lr.  That gradient is held near 0 on both sides instead."""
    pair = _feature_pair()
    port = pair["port"]
    rms = np.sqrt(np.mean(np.concatenate(
        [p.grad.numpy().ravel() ** 2 for p in port.parameters()])))
    for name, p in port.named_parameters():
        if name == "final.bias":
            g = _leaf(pair["jax_grads"], port, name, p)
            assert np.abs(g).max() <= 1e-4 * rms
            assert p.grad.abs().max() <= 1e-4 * rms
            continue
        want = (_leaf(pair["jax_params"], port, name, p)
                - _leaf(pair["jax_old"], port, name, p))
        got = (p.detach() - pair["before"][name]).numpy()
        g = _leaf(pair["jax_grads"], port, name, p)
        keep = (g == 0) | (np.abs(g) > 1e-2 * np.sqrt((g ** 2).mean()))
        assert keep.mean() > 0.5, name
        assert _rel(got[keep], want[keep]) <= 1e-3, (name, _rel(got, want))
    for name, buf in port.named_buffers():
        want = pair["jax_stats"][jax_path(port, name)[1]]
        assert _rel(buf.numpy(), want) <= 1e-5, name


# ------------------------------------------------------ data and the main

def test_ycb_items_match_jax():
    port = YCBDataset(num_classes=5, samples_per_class=2, max_points=300,
                      seed=2)
    jax_ds = JaxYCBDataset(num_classes=5, samples_per_class=2,
                           max_points=300, seed=2)
    assert len(port) == len(jax_ds) == 10
    for i in range(len(port)):
        got, want = port[i], jax_ds[i]
        assert got["label"] == want["label"]
        for k in ("points", "feats"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for got, want in zip(port.batches(4, seed=1), jax_ds.batches(4, seed=1)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.cfg.quantization_size == 1 / 200.0


def test_ycb_items_from_files(tmp_path):
    import pickle

    paths = []
    for i, cls in enumerate((3, 1)):
        path = tmp_path / f"o{i}.pickle"
        pts = np.random.default_rng(i).normal(size=(50, 3)) * 0.05
        with open(path, "wb") as f:
            pickle.dump({"points": pts, "label": cls}, f)
        paths.append(str(path))
    port = YCBDataset(files=paths, max_points=64)
    want = JaxYCBDataset(files=paths, max_points=64)
    for k, v in want.collate([want[0], want[1]]).items():
        np.testing.assert_array_equal(port.collate([port[0], port[1]])[k], v)


def test_train_feature_extractor_on_cpu(tmp_path):
    data = YCBDataset(num_classes=2, samples_per_class=4, max_points=256)
    hist = train_feature_extractor(TrainConfig(batch_size=2), epochs=1,
                                   device="cpu", dataset=data,
                                   backbone="minkunet14A", capacity=256,
                                   exp_path=str(tmp_path), exp_name="fe")
    # the batch is max(batch_size, 8): one batch of the eight clouds
    assert len(hist) == 1 and hist[0]["batches"] == 1
    assert np.isfinite(hist[0]["loss"])
    assert (tmp_path / "fe-000000001.ckpt").exists()


def test_train_feature_extractor_defaults_to_the_card(tmp_path):
    data = YCBDataset(num_classes=2, samples_per_class=4, max_points=256)
    args = dict(epochs=1, dataset=data, backbone="minkunet14A",
                capacity=256, exp_path=str(tmp_path))
    if torch.cuda.is_available():
        assert len(train_feature_extractor(**args)) == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            train_feature_extractor(**args)


# ---------------------------------------------------------- weight bridge

def _jax_shapes(jmod, cap=CAP):
    """The JAX module's variables as random arrays of their shapes (traced
    with ``jax.eval_shape``, nothing compiled)."""
    batch = {k: jnp.asarray(v) for k, v in _ycb_batch().items()}

    def init():
        vox, _, _ = jax_voxelize(batch["points"], batch["feats"],
                                 batch["mask"], Q, cap)
        levels = jax_build_hierarchy(vox, 4, capacities=CAPS)
        return jmod.init(jax.random.PRNGKey(0), vox.feats, levels)

    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        jax.eval_shape(init))


def _unfrozen(tree):
    return {k: _unfrozen(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["vote", "featurenet"])
def test_bridge_is_strict_both_ways(kind):
    if kind == "vote":
        jmod, port = (JaxVote(backbone="minkunet14A", num_classes=4),
                      RobotNetVote(backbone="minkunet14A", num_classes=4))
        assert set(_jax_shapes(jmod)["params"]) == {"seg"}
    else:
        jmod, port = JaxFeatureNet(backbone="minkunet14A"), \
            FeatureNet(backbone="minkunet14A")
    variables = _unfrozen(_jax_shapes(jmod))
    load_jax_variables(port, variables)
    a = _flat(variables)
    taken = set()
    for name, tensor in port.state_dict().items():
        coll, path = jax_path(port, name)
        want = a[(coll,) + path]
        got = tensor.numpy()
        np.testing.assert_array_equal(got.T if got.ndim == 2 else got, want)
        taken.add((coll,) + path)
    assert taken == set(a)
    if kind == "featurenet":
        assert ("params", "final_bn", "scale") in a
        assert translate_key("final_bn.bn.weight") == \
            ("params", ("final_bn", "scale"))
        assert translate_key("final.kernel") == \
            ("params", ("unet", "final", "kernel"))
    # a missing leaf, and a leaf no port tensor takes, each raise
    missing = _unfrozen(variables)
    top = missing["params"]
    first = next(iter(top))
    del top[first]
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(port, missing)
    extra = _unfrozen(variables)
    extra["params"]["stray"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(port, extra)
