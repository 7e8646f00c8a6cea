"""Voting and sparse keypoint training of the port vs the JAX package (CPU,
plain twins).

- ``RobotNetVote``'s forward (train mode, batch statistics: random
  running statistics make eval-mode logits of a random net reach 1e9)
  against the JAX module's from the same variables through
  ``load_jax_variables`` (the ``seg`` scope): 1e-5;
- ``pred_center`` against JAX's, with and without an orientation, on
  scores with no tie at the k-th place: 1e-6;
- one vote step (``RobotNetVote``, 2 classes, cross-section labels of EE
  crops) and one keypoint step (``RobotNetSegmentation``, 6 classes, most
  rows ``ignore_label``) against JAX ``make_segmentation_train_step`` (the
  ``"xla"`` route), minkunet14A, B = 2 crops, voxel capacity 512: loss and
  accuracy 1e-5, gradients 1e-4 in relative norm over all parameters, the
  update 1e-3 where the gradient is above the noise (ROADMAP C9);
- the ``train_vote`` and ``train_key_points`` mains for one epoch on the
  CPU, the dense keypoint branch (PointNet2SSG) for one epoch, and the
  mains' device default (the card; without one they raise).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.models import RobotNetSegmentation as JaxSeg
from mrcc_tpu.models import RobotNetVote as JaxVote
from mrcc_tpu.solve.vote import pred_center as jax_pred_center
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu.train.losses import segmentation_loss as jax_segmentation_loss
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import TrainState
from mrcc_tpu.train.trainer import \
    make_segmentation_train_step as jax_make_segmentation_train_step
from mrcc_tpu_torch.cli.train_mains import train_key_points, train_vote
from mrcc_tpu_torch.data.dataset import AliveV2Dataset, DataConfig
from mrcc_tpu_torch.data.dense import AliveV2DenseDataset
from mrcc_tpu_torch.data.synthetic import generate_sample
from mrcc_tpu_torch.interop import jax_path, load_jax_variables
from mrcc_tpu_torch.models import RobotNetSegmentation, RobotNetVote
from mrcc_tpu_torch.solve import pred_center
from mrcc_tpu_torch.sparse import build_hierarchy, voxelize
from mrcc_tpu_torch.train import TrainConfig
from mrcc_tpu_torch.train import make_segmentation_train_step
from test_torch_train import _flat, _randomise, _rel


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


CAP = 512
CAPS = (512, 256, 128, 64)
Q = 0.01
LR = 1e-4
SAMPLE_KW = dict(n_ee=600, n_arm=200, n_bg=200)  # ~400 voxels a crop
HEADS = {"vote": (JaxVote, RobotNetVote, dict(voting_enabled=True), 2),
         "keypoints": (JaxSeg, RobotNetSegmentation,
                       dict(keypoints_enabled=True), 6)}


def _dataset(seed=50, n=2, **kw):
    return AliveV2Dataset(
        samples=[generate_sample(seed=seed + i, **SAMPLE_KW)
                 for i in range(n)],
        cfg=DataConfig(max_points=1024, **kw))


def _batch(kw):
    ds = _dataset(**kw)
    b = ds.collate([ds[0], ds[1]])
    return {k: b[k] for k in ("points", "feats", "mask", "labels")}


def _leaf(flat, model, name, tensor):
    arr = flat[jax_path(model, name)[1]]
    return arr.T if tensor.dim() == 2 else arr  # nn.Linear [out, in]


@functools.lru_cache(maxsize=None)
def _step_pair(head):
    """One step of each package from the same weights and batch, and the
    JAX module's logits before it (train mode: batch statistics; computed
    once per head)."""
    jcls, cls, kw, classes = HEADS[head]
    batch = _batch(kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmod = jcls(backbone="minkunet14A", in_channels=3, num_classes=classes)

    def hierarchy(b):
        vox, _, vlabels = jax_voxelize(b["points"], b["feats"], b["mask"],
                                       Q, CAP, labels=b["labels"])
        return vox, vlabels, jax_build_hierarchy(vox, 4, capacities=CAPS)

    @jax.jit
    def init(b):
        vox, _, levels = hierarchy(b)
        return jmod.init(jax.random.PRNGKey(1), vox.feats, levels)

    variables = _randomise(init(jb), 2)
    step, opt = jax_make_segmentation_train_step(
        jmod, JaxDataConfig(max_points=1024), JaxTrainConfig(conv_impl="xla"),
        CAP)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))

    @jax.jit
    def step_and_grads(state, b):
        new_state, metrics = step(state, b, LR)
        with sparse_impl("xla"):
            vox, vlabels, levels = hierarchy(b)

            def loss_fn(p):
                out, _ = jmod.apply({"params": p,
                                     "batch_stats": state.batch_stats},
                                    vox.feats, levels, train=True,
                                    mutable=["batch_stats"])
                return jax_segmentation_loss(out, vlabels, vox.valid), out

            grads, logits = jax.grad(loss_fn, has_aux=True)(state.params)
            return new_state, metrics, grads, logits

    new_state, metrics, grads, logits = step_and_grads(state, jb)
    port = load_jax_variables(cls(backbone="minkunet14A", in_channels=3,
                                  num_classes=classes), variables)
    port_step, _ = make_segmentation_train_step(
        port, DataConfig(max_points=1024, **kw), TrainConfig(), CAP,
        device="cpu")
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    port_metrics = port_step(batch, LR)
    return dict(
        batch=batch, variables=variables, cls=cls, classes=classes,
        jax_logits=np.asarray(logits),
        jax_metrics={k: float(v) for k, v in metrics.items()},
        port_metrics={k: float(v) for k, v in port_metrics.items()},
        jax_params=_flat(jax.device_get(new_state.params)),
        jax_old=_flat(variables["params"]),
        jax_grads=_flat(jax.device_get(grads)), port=port, before=before)


@pytest.fixture(params=sorted(HEADS))
def step_pair(request):
    return _step_pair(request.param)


def test_vote_forward_matches_jax():
    pair = _step_pair("vote")
    port = load_jax_variables(RobotNetVote(backbone="minkunet14A"),
                              pair["variables"]).train()
    b = {k: torch.from_numpy(v) for k, v in pair["batch"].items()}
    with torch.no_grad():
        vox, _ = voxelize(b["points"], b["feats"], b["mask"], Q, CAP)
        levels = build_hierarchy(vox, 4, capacities=CAPS)
        got = port(vox.feats, levels).numpy()
    valid = vox.valid.numpy()
    assert got.shape == pair["jax_logits"].shape == (2, CAP, 2)
    np.testing.assert_allclose(got[valid], pair["jax_logits"][valid],
                               rtol=1e-5, atol=1e-5)


def test_step_loss_and_accuracy(step_pair):
    for k in ("loss", "accuracy"):
        want, got = step_pair["jax_metrics"][k], step_pair["port_metrics"][k]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (k, got, want)
    labels = step_pair["batch"]["labels"]
    kept = (labels[step_pair["batch"]["mask"]] >= 0).mean()
    # voting labels every point of the crop; keypoints only a few
    assert kept == 1.0 if step_pair["classes"] == 2 else 0 < kept < 0.2


def test_step_grads(step_pair):
    port = step_pair["port"]
    got, want = [], []
    for name, p in port.named_parameters():
        got.append(p.grad.numpy().ravel())
        want.append(_leaf(step_pair["jax_grads"], port, name, p).ravel())
    assert len(want) == len(step_pair["jax_grads"])
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-4


def test_step_update(step_pair):
    port = step_pair["port"]
    for name, p in port.named_parameters():
        want = (_leaf(step_pair["jax_params"], port, name, p)
                - _leaf(step_pair["jax_old"], port, name, p))
        got = (p.detach() - step_pair["before"][name]).numpy()
        g = _leaf(step_pair["jax_grads"], port, name, p)
        keep = (g == 0) | (np.abs(g) > 1e-2 * np.sqrt((g ** 2).mean()))
        assert keep.mean() > 0.5, name
        assert _rel(got[keep], want[keep]) <= 1e-3, (name, _rel(got, want))


@pytest.mark.parametrize("with_q", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pred_center_matches_jax(seed, with_q):
    rng = np.random.default_rng(seed)
    p = 500
    logits = rng.normal(size=(p, 2)).astype(np.float32)
    coords = rng.normal(size=(p, 3)).astype(np.float32)
    mask = rng.random(p) > 0.3
    logits[~mask, 1] += 10.0  # the best scores are padding: masked out
    score = np.sort(logits[mask, 1])[::-1]
    assert score[7] != score[8]  # no tie at the 8th place
    q = rng.normal(size=4).astype(np.float32) if with_q else None
    want = np.asarray(jax_pred_center(
        jnp.asarray(logits), jnp.asarray(coords), jnp.asarray(mask),
        q=None if q is None else jnp.asarray(q)))
    got = pred_center(torch.from_numpy(logits), torch.from_numpy(coords),
                      torch.from_numpy(mask),
                      q=None if q is None else torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


MAINS = [(train_vote, dict(voting_enabled=True)),
         (train_key_points, dict(keypoints_enabled=True))]


@pytest.mark.parametrize("main,kw", MAINS)
def test_mains_run_one_epoch_on_cpu(tmp_path, main, kw):
    hist = main(TrainConfig(batch_size=2), capacity=512, epochs=1,
                device="cpu", data_cfg=DataConfig(max_points=1024),
                dataset=_dataset(seed=60, **kw), backbone="minkunet14A",
                exp_path=str(tmp_path), exp_name="m")
    assert len(hist) == 1 and hist[0]["batches"] == 1
    assert np.isfinite(hist[0]["loss"]) and 0 <= hist[0]["accuracy"] <= 1
    assert (tmp_path / "m-000000001.ckpt").exists()


def test_dense_key_points_raise(tmp_path):
    """The dense branch of ``train_key_points`` (a ``pointnet*`` backbone
    raised until the PointNet2 slice; the test keeps its name): one epoch
    of PointNet2SSG on 256-point FPS samples of two EE crops."""
    ds = AliveV2DenseDataset(
        samples=[generate_sample(seed=60 + i) for i in range(2)],
        cfg=DataConfig(keypoints_enabled=True), num_points=256,
        sampling="farthest")
    hist = train_key_points(TrainConfig(batch_size=2), epochs=1,
                            device="cpu", dataset=ds, backbone="pointnet2",
                            exp_path=str(tmp_path), exp_name="dense")
    assert len(hist) == 1 and hist[0]["batches"] == 1
    assert np.isfinite(hist[0]["loss"]) and hist[0]["loss"] > 0
    assert (tmp_path / "dense-000000001.ckpt").exists()


@pytest.mark.parametrize("main,kw", MAINS)
def test_mains_default_to_the_card(tmp_path, main, kw):
    args = dict(epochs=1, dataset=_dataset(seed=60, **kw),
                data_cfg=DataConfig(max_points=1024), capacity=512,
                backbone="minkunet14A", exp_path=str(tmp_path))
    if torch.cuda.is_available():
        assert len(main(TrainConfig(batch_size=2), **args)) == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            main(TrainConfig(batch_size=2), **args)
