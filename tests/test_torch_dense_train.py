"""Dense training vs the JAX package (CPU): ``AliveV2DenseDataset``, the
dense keypoint step, the keypoint-to-pose step, both mains and C29.

- Dense items and ``collate`` equal the JAX class's for both sampling
  methods (points, features, labels, pose, mask) on the same scenes.
- One dense keypoint step (PointNet2SSG, 6 classes, segmentation CE,
  AdamW) and one keypoint-to-pose step (a frozen PointNet2SSG in eval mode,
  PointNet(7), ``kp_pose_match``), each at B = 2 x 1024, against the JAX
  mains' inline steps rebuilt here from the JAX package's parts, from the
  same weights and with JAX's dropout masks installed in the port's dropout
  modules (read from ``capture_intermediates`` under the steps' key,
  ``PRNGKey(0)``): loss to 1e-5, gradients to 1e-4 in relative norm over
  every parameter, the update to 1e-3 where the gradient is above 1 % of
  its tensor's rms (Adam's first step is ``lr * g / (|g| + eps)``: noise
  where g is; C9), the running statistics to 1e-6.  A bias that feeds a
  train-mode norm (SSG ``conv1.bias``) has an exact gradient of 0: its |g|
  is held under 1e-4 of the gradients' rms instead.  Both steps run in
  float64 on both sides (``jax.enable_x64``, the port's ``.double()``):
  in f32 the dense nets' gradients move by tens of per cent under a 1e-7
  relative change of the input (ROADMAP C31), so two f32 implementations
  cannot meet 1e-4.
- ``train_key_points(backbone="pointnet2")`` and ``train_kp_to_pose``
  (its frozen predictor from the first main's checkpoint) run one epoch
  on the CPU.
- C29: ``select_pose_model`` gives ``PointNet2SSG`` for a ``pointnet*``
  backbone, and ``train_pose`` with it raises, as the JAX pose step fails
  on that model (``TypeError``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.data.dense import AliveV2DenseDataset as JaxDenseDataset
from mrcc_tpu.data.synthetic import generate_sample
from mrcc_tpu.models.pointnet2 import PointNet as JaxPointNet
from mrcc_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from mrcc_tpu.solve import key_point_predictions as jax_kp_predictions
from mrcc_tpu.train.losses import LossConfig as JaxLossConfig
from mrcc_tpu.train.losses import LossType as JaxLossType
from mrcc_tpu.train.losses import get_criterion as jax_get_criterion
from mrcc_tpu.train.losses import segmentation_loss as jax_seg_loss
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mrcc_tpu_torch.cli.train_mains import (PoseModelConfig,
                                            select_pose_model,
                                            train_key_points,
                                            train_kp_to_pose, train_pose)
from mrcc_tpu_torch.data.dataset import DataConfig
from mrcc_tpu_torch.data.dense import AliveV2DenseDataset
from mrcc_tpu_torch.interop import jax_path, load_jax_variables
from mrcc_tpu_torch.models import PointNet, PointNet2SSG
from mrcc_tpu_torch.train import (TrainConfig,
                                  make_dense_key_point_train_step,
                                  make_kp_to_pose_train_step)

DATA = dict(data_type="ee_seg", keypoints_enabled=True, num_of_keypoints=6,
            center_at_origin=True)
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs files in
    parallel workers; torch's default of a thread a core oversubscribes
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n, seed=30):
    return [generate_sample(seed=seed + i, n_ee=1500, n_arm=600, n_bg=900)
            for i in range(n)]


def _datasets(sampling, num_points=1024, n=2):
    samples = _samples(n)
    jax_ds = JaxDenseDataset(samples=[dict(s) for s in samples],
                             cfg=JaxDataConfig(**DATA),
                             num_points=num_points, sampling=sampling)
    port_ds = AliveV2DenseDataset(samples=[dict(s) for s in samples],
                                  cfg=DataConfig(**DATA),
                                  num_points=num_points, sampling=sampling)
    return jax_ds, port_ds


@pytest.mark.parametrize("sampling", ["uniform", "farthest"])
def test_dense_items_and_collate(sampling):
    jax_ds, port_ds = _datasets(sampling)
    items = []
    for i in range(len(port_ds)):
        a, b = jax_ds[i], port_ds[i]
        assert b is not None
        for k in ("points", "feats", "labels", "pose"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        items.append((a, b))
    want = jax_ds.collate([a for a, _ in items])
    got = port_ds.collate([b for _, b in items])
    for k in ("points", "feats", "labels", "mask", "pose", "joint_angles"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a crop under num_points is no item
    small = AliveV2DenseDataset(samples=_samples(1), cfg=DataConfig(**DATA),
                                num_points=4096)
    assert small[0] is None


# ------------------------------------------------------------- the steps


def _fill(shapes, seed, head=None, head_scale=1.0):
    """Random float64 variables of the tree ``shapes`` (LeCun-scaled
    kernels, ``head``'s times ``head_scale``; random norm affines and
    statistics)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            out = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
            if keys[-2] == head:
                out = out * head_scale
        elif keys[-1] == "scale":
            out = 1 + 0.1 * rng.normal(size=s.shape)
        elif keys[-1] == "var":
            out = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            out = 0.1 * rng.normal(size=s.shape)
        return out.astype(np.float64)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _variables(model, x, seed, **kw):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x, jnp.float32)))
    return jax.device_get(_fill(shapes, seed, **kw))


def _dropout_mask(model, variables, x):
    """JAX's keep mask of the dropout of ``model`` under the steps' key."""
    _, inter = model.apply(variables, x, train=True,
                           mutable=["batch_stats", "intermediates"],
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           capture_intermediates=True)
    return np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0


def _jax_update(variables, grads, lr):
    opt = jax_make_optimizer(JaxTrainConfig())
    state = optax.tree_utils.tree_set(opt.init(variables["params"]),
                                      learning_rate=lr)
    upd, _ = opt.update(grads, state, variables["params"])
    return optax.apply_updates(variables["params"], upd)


def _batch64(batch):
    return dict(batch, points=batch["points"].astype(np.float64),
                feats=batch["feats"].astype(np.float64),
                pose=batch["pose"].astype(np.float64))


def _check_step(port, before, loss, want, zero_grad=()):
    """The port's step (``loss``, ``.grad``, parameters and buffers after)
    against the JAX step's ``want``: ``loss``, ``grads``, ``params`` and
    ``batch_stats`` trees."""
    assert abs(loss - want["loss"]) <= 1e-5 * abs(want["loss"])
    flat = {}
    for coll in ("grads", "params", "batch_stats"):
        for path, v in jax.tree_util.tree_flatten_with_path(want[coll])[0]:
            flat[(coll, tuple(p.key for p in path))] = np.asarray(v)
    gd = gn = ud = un = 0.0
    grads = {}
    for name, p in port.named_parameters():
        _, path = jax_path(port, name)
        g_want = flat[("grads", path)]
        if p.dim() == 2:
            g_want = g_want.T
        grads[name] = (p.grad.numpy(), g_want)
    rms = np.sqrt(np.mean(np.concatenate([w.ravel() ** 2
                                          for _, w in grads.values()])))
    for name, p in port.named_parameters():
        g, g_want = grads[name]
        if name in zero_grad:
            assert np.abs(g).max() <= 1e-4 * rms, name
            continue
        gd += float(((g - g_want) ** 2).sum())
        gn += float((g_want ** 2).sum())
        _, path = jax_path(port, name)
        new_want = flat[("params", path)]
        if p.dim() == 2:
            new_want = new_want.T
        keep = (g_want == 0) | (np.abs(g_want) > 1e-2 * np.sqrt(
            np.mean(g_want ** 2)))
        u = (p.detach().numpy() - before[name])[keep]
        u_want = (new_want - before[name])[keep]
        ud += float(((u - u_want) ** 2).sum())
        un += float((u_want ** 2).sum())
    assert np.sqrt(gd / gn) <= 1e-4, np.sqrt(gd / gn)
    assert np.sqrt(ud / un) <= 1e-3, np.sqrt(ud / un)
    for name, buf in port.named_buffers():
        coll, path = jax_path(port, name)
        w = flat[(coll, path)]
        err = np.linalg.norm(buf.numpy() - w) / np.linalg.norm(w)
        assert err <= 1e-6, (name, err)


def _install_mask(module, mask):
    keep = 1.0 - module.rate
    m = torch.from_numpy(mask)
    module.forward = lambda f: torch.where(m, f / keep, 0.0)


def _load64(module, variables):
    """``variables`` (float64) into ``module`` in float64, through the
    bridge's names."""
    load_jax_variables(module, {c: jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), t) for c, t in variables.items()})
    module.double()
    with torch.no_grad():
        for name, t in module.state_dict().items():
            coll, path = jax_path(module, name)
            leaf = variables[coll]
            for k in path:
                leaf = leaf[k]
            leaf = np.asarray(leaf)
            t.copy_(torch.from_numpy(leaf.T.copy() if t.dim() == 2
                                     else leaf))
    return module


@pytest.fixture(scope="module")
def kp_batch():
    _, port_ds = _datasets("farthest")
    return _batch64(port_ds.collate([port_ds[0], port_ds[1]]))


def test_dense_key_point_step(kp_batch):
    batch = kp_batch
    x = np.concatenate([batch["points"], batch["feats"]], axis=-1)
    model = JaxSSG(num_classes=6)
    with jax.enable_x64(True):
        variables = _variables(model, x, 3)
        mask = _dropout_mask(model, variables, x)

        def loss_fn(params):
            (logits, _), upd = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_seg_loss(logits, batch["labels"], batch["mask"],
                                ignore_label=-100), upd

        (loss, upd), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        want = jax.device_get(dict(
            loss=float(loss), grads=grads,
            params=_jax_update(variables, grads, LR),
            batch_stats=upd["batch_stats"]))
    port = _load64(PointNet2SSG(num_classes=6), variables)
    _install_mask(port.drop, mask)
    before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
    step, _ = make_dense_key_point_train_step(port, TrainConfig(),
                                              device="cpu")
    loss = float(step(batch, LR)["loss"])
    _check_step(port, before, loss, want, zero_grad=("conv1.bias",))


def test_kp_to_pose_step():
    _, port_ds = _datasets("uniform")
    batch = _batch64(port_ds.collate([port_ds[0], port_ds[1]]))
    x = np.concatenate([batch["points"], batch["feats"]], axis=-1)
    kp_model, pose_model = JaxSSG(num_classes=6), JaxPointNet(out_channels=7)
    criterion = jax_get_criterion(JaxLossConfig(
        loss_type=JaxLossType.KP_POSE_MATCH))
    with jax.enable_x64(True):
        # the frozen predictor's head scaled so that classes pass 0.75
        kp_vars = _variables(kp_model, x, 4, head="conv2", head_scale=30.0)
        kp_logits, _ = kp_model.apply(kp_vars, x, train=False)
        idx, found, conf = jax.vmap(jax_kp_predictions)(kp_logits,
                                                       batch["mask"])
        coords = jnp.take_along_axis(jnp.asarray(batch["points"]),
                                     idx[..., None], axis=1)
        head_in = jnp.concatenate([coords, conf[..., None]], axis=-1)
        pose_vars = _variables(pose_model, head_in, 5)
        mask = _dropout_mask(pose_model, pose_vars, head_in)

        def loss_fn(params):
            out, upd = pose_model.apply(
                {"params": params, "batch_stats": pose_vars["batch_stats"]},
                head_in, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            return criterion(batch["pose"], out, coords=coords,
                             coords_valid=found, probs=conf), upd

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            pose_vars["params"])
        want = jax.device_get(dict(
            loss=float(loss), grads=grads,
            params=_jax_update(pose_vars, grads, LR),
            batch_stats=upd["batch_stats"]))
        found = np.asarray(found)
    assert found.any() and want["loss"] > 0
    kp = _load64(PointNet2SSG(num_classes=6), kp_vars)
    port = _load64(PointNet(out_channels=7), pose_vars)
    _install_mask(port.drop, mask)
    before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
    step, _ = make_kp_to_pose_train_step(port, kp, TrainConfig(), True,
                                         device="cpu")
    prepared = step.prepare(batch)
    np.testing.assert_array_equal(prepared[2].numpy(), found)
    np.testing.assert_array_equal(prepared[1].numpy(), np.asarray(coords))
    loss = float(step(batch, LR)["loss"])
    assert not any(p.grad is not None for p in kp.parameters())
    _check_step(port, before, loss, want)


# ------------------------------------------------------------- the mains


def test_dense_mains_one_epoch(tmp_path):
    cfg = DataConfig(**DATA)

    def data(sampling):
        return AliveV2DenseDataset(samples=_samples(2), cfg=cfg,
                                   num_points=256, sampling=sampling)

    hist = train_key_points(TrainConfig(batch_size=2), epochs=1,
                            device="cpu", dataset=data("farthest"),
                            backbone="pointnet2",
                            exp_path=str(tmp_path / "kp"), exp_name="kp")
    assert len(hist) == 1 and hist[0]["batches"] == 1
    assert np.isfinite(hist[0]["loss"]) and hist[0]["loss"] > 0
    ckpt = tmp_path / "kp" / "kp-000000001.ckpt"
    assert ckpt.exists()
    hist = train_kp_to_pose(TrainConfig(batch_size=2), epochs=1,
                            device="cpu", dataset=data("uniform"),
                            kp_prediction_checkpoint=str(ckpt),
                            exp_path=str(tmp_path / "pose"))
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert (tmp_path / "pose" / "kp_to_pose-000000001.ckpt").exists()


def test_dense_mains_default_to_the_card(tmp_path):
    ds = AliveV2DenseDataset(samples=_samples(2), cfg=DataConfig(**DATA),
                             num_points=256)
    for main, kw in ((train_key_points, dict(backbone="pointnet2")),
                     (train_kp_to_pose, {})):
        if torch.cuda.is_available():
            assert len(main(TrainConfig(batch_size=2), epochs=1, dataset=ds,
                            exp_path=str(tmp_path), **kw)) == 1
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                main(TrainConfig(batch_size=2), epochs=1, dataset=ds,
                     exp_path=str(tmp_path), **kw)


def test_c29_pointnet_pose_backbone(tmp_path):
    model = select_pose_model(PoseModelConfig(backbone="pointnet2"),
                              DataConfig())
    assert isinstance(model, PointNet2SSG)
    assert model.conv2.out_features == 7
    model = select_pose_model(PoseModelConfig(
        backbone="pointnet2", compute_confidence=True), DataConfig())
    assert model.conv2.out_features == 10
    with pytest.raises(NotImplementedError, match="C29"):
        train_pose(TrainConfig(batch_size=2),
                   PoseModelConfig(backbone="pointnet2"), device="cpu",
                   exp_path=str(tmp_path))
    # the JAX pose step calls model.apply(params, voxel features, levels,
    # joint angles, train=True): PointNet2SSG(x, train) takes the joint
    # angles as ``train`` and refuses the keyword.  (Its state init,
    # model.init(key, features, levels), does not fail: the levels land in
    # ``train``.)
    from mrcc_tpu.data.dataset import AliveV2Dataset as JaxDataset
    from mrcc_tpu.train import LossConfig, Trainer, make_pose_train_step

    jax_model = JaxSSG(num_classes=7)
    data_cfg = dataclasses.replace(JaxDataConfig(**DATA), max_points=2048)
    ds = JaxDataset(samples=_samples(1), cfg=data_cfg)
    step, opt = make_pose_train_step(jax_model, data_cfg, LossConfig(),
                                     JaxTrainConfig(), 512)
    trainer = Trainer(jax_model, ds, step, opt, JaxTrainConfig(),
                      exp_path=str(tmp_path / "jax"))
    with pytest.raises(TypeError, match="train"):
        trainer.fit(epochs=1)
