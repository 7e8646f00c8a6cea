"""Pose training of the port vs the JAX package (CPU, plain twins).

- EE-crop pose items of ``PoseDataset`` against JAX ``AliveV2Dataset``
  over the same samples (crop, WXYZ pose, colour rescue,
  ``voxelize_position``, ``move_ee_to_origin``, the origin shifts, the
  collate): equal to f32 rounding;
- the heads' output postprocessing against JAX ``_finalize_pose_output``
  in train and eval mode;
- one pose step against JAX ``make_pose_train_step`` (the ``"xla"`` route)
  from the same weights, for ``RobotNetEncode`` minkunet14A with the cos2
  criterion and ``RobotNet`` minkunet14A with the pose criterion, on two
  EE crops at voxel capacity 1024: loss and the four distance metrics
  1e-5, gradients 1e-4 in relative norm over all parameters, the update
  1e-3 where the gradient is above the noise (ROADMAP C9, as
  ``tests/test_torch_train.py``);
- ``RobotNet``'s weight bridge, strict both ways: the port's state dict
  goes back through ``mrcc_tpu.train.interop.import_state_dict(strict=
  True)`` into the same flax tree;
- ``select_pose_model``, the ``train_pose`` main on the CPU, and the step's
  device default (the card).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrcc_tpu.data.dataset import AliveV2Dataset
from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.models import RobotNet as JaxRobotNet
from mrcc_tpu.models import RobotNetEncode as JaxEncode
from mrcc_tpu.models.robotnet import \
    _finalize_pose_output as jax_finalize_pose_output
from mrcc_tpu.sparse import build_hierarchy as jax_build_hierarchy
from mrcc_tpu.sparse import voxelize as jax_voxelize
from mrcc_tpu.sparse.impl import sparse_impl
from mrcc_tpu.train.interop import import_state_dict
from mrcc_tpu.train.losses import LossConfig as JaxLossConfig
from mrcc_tpu.train.losses import get_criterion as jax_get_criterion
from mrcc_tpu.train.trainer import TrainConfig as JaxTrainConfig
from mrcc_tpu.train.trainer import TrainState
from mrcc_tpu.train.trainer import \
    make_pose_train_step as jax_make_pose_train_step
from mrcc_tpu_torch.cli.train_mains import (PoseModelConfig, ee_capacity,
                                            select_pose_model, train_pose)
from mrcc_tpu_torch.data.dataset import DataConfig, PoseDataset, pose_item
from mrcc_tpu_torch.data.synthetic import generate_sample
from mrcc_tpu_torch.interop import load_jax_variables
from mrcc_tpu_torch.models import RobotNet, RobotNetEncode
from mrcc_tpu_torch.models.robotnet import _finalize_pose_output
from mrcc_tpu_torch.train import (LossConfig, TrainConfig,
                                  make_pose_train_step)
from test_torch_train import _flat, _jax_leaf, _randomise, _rel

CAP = 1024
CAPS = (1024, 512, 256, 128)
LR = 1e-4
SAMPLE_KW = dict(n_ee=1000, n_arm=200, n_bg=200)
METRICS = ("loss", "dist", "dist_position", "dist_orientation", "angle_diff")


def _samples(n=2, seed=5):
    return [generate_sample(seed=seed + i, **SAMPLE_KW) for i in range(n)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(move_ee_to_origin=True, voxelize_position=True, scale=200.0),
    dict(center_at_origin=False),
    dict(data_type=None, max_points=2048),
])
def test_pose_items_match_jax(kw):
    cfg = DataConfig(**{"max_points": 1024, **kw})
    jcfg = JaxDataConfig(**{"max_points": 1024, **kw})
    samples = _samples()
    jds = AliveV2Dataset(samples=samples, cfg=jcfg)
    items = [pose_item(s, cfg) for s in samples]
    for it, (i, s) in zip(items, enumerate(samples)):
        want = jds[i]
        for k in ("points", "feats", "labels", "pose"):
            np.testing.assert_allclose(it[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_array_equal(it["joint_angles"], s["joint_angles"])
    got, want = PoseDataset(cfg, 2, seed=5, **SAMPLE_KW).collate(items), \
        jds.collate([jds[0], jds[1]])
    for k in ("points", "feats", "labels", "mask", "pose", "joint_angles"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("width,qsize,rot_dims", [(7, 0.0, 4), (10, 0.01, 4),
                                                  (12, 0.0, 6)])
def test_finalize_pose_output_matches_jax(train, width, qsize, rot_dims):
    out = np.random.default_rng(width).normal(size=(3, width)).astype(
        np.float32)
    want = np.asarray(jax_finalize_pose_output(jnp.asarray(out), train,
                                               qsize, rot_dims))
    got = _finalize_pose_output(torch.from_numpy(out), train, qsize,
                                rot_dims).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------ one pose train step

KINDS = {"encode-cos2": (JaxEncode, RobotNetEncode, "cos2"),
         "robotnet-pose": (JaxRobotNet, RobotNet, "pose")}


@functools.lru_cache(maxsize=None)
def _pose_pair(kind):
    """One step of each package from the same weights and batch (computed
    once per kind and shared by the tests below)."""
    jcls, cls, loss_type = KINDS[kind]
    data_cfg = DataConfig(max_points=1024)
    batch = PoseDataset(data_cfg, 2, seed=5, **SAMPLE_KW)
    batch = batch.collate(batch.items)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmod = jcls(backbone="minkunet14A", in_channels=3, out_channels=7)

    @jax.jit
    def init(points, feats, mask):
        vox, _, _ = jax_voxelize(points, feats, mask, 0.01, CAP)
        levels = jax_build_hierarchy(vox, 4, capacities=CAPS)
        return jmod.init(jax.random.PRNGKey(1), vox.feats, levels)

    variables = _randomise(init(jb["points"], jb["feats"], jb["mask"]), 2)
    jloss_cfg = JaxLossConfig(loss_type=loss_type)
    step, opt = jax_make_pose_train_step(
        jmod, JaxDataConfig(max_points=1024), jloss_cfg,
        JaxTrainConfig(conv_impl="xla"), CAP)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))
    criterion = jax_get_criterion(jloss_cfg)

    @jax.jit
    def step_and_grads(state, b):
        new_state, metrics = step(state, b, LR)
        with sparse_impl("xla"):
            vox, _, _ = jax_voxelize(b["points"], b["feats"], b["mask"],
                                     0.01, CAP)
            levels = jax_build_hierarchy(vox, 4, capacities=CAPS)

            def loss_fn(p):
                out, _ = jmod.apply({"params": p,
                                     "batch_stats": state.batch_stats},
                                    vox.feats, levels, train=True,
                                    mutable=["batch_stats"])
                return criterion(b["pose"], out,
                                 coords=vox.coords().astype(jnp.float32),
                                 coords_valid=vox.valid)

            return new_state, metrics, jax.grad(loss_fn)(state.params)

    new_state, metrics, grads = step_and_grads(state, jb)
    port = load_jax_variables(cls(backbone="minkunet14A", in_channels=3,
                                  out_channels=7), variables)
    port_step, _ = make_pose_train_step(port, data_cfg,
                                        LossConfig(loss_type=loss_type),
                                        TrainConfig(), CAP, device="cpu")
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    port_metrics = port_step(batch, LR)
    return dict(
        variables=variables,
        jax_metrics={k: float(v) for k, v in metrics.items()},
        port_metrics={k: float(v) for k, v in port_metrics.items()},
        jax_params=_flat(jax.device_get(new_state.params)),
        jax_old=_flat(variables["params"]),
        jax_grads=_flat(jax.device_get(grads)), port=port, before=before)


@pytest.fixture(params=sorted(KINDS))
def pose_pair(request):
    return _pose_pair(request.param)


def test_pose_step_loss_and_metrics(pose_pair):
    assert set(pose_pair["port_metrics"]) == set(METRICS)
    for k in METRICS:
        want, got = pose_pair["jax_metrics"][k], pose_pair["port_metrics"][k]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (k, got, want)


def test_pose_step_grads(pose_pair):
    got, want = [], []
    for name, p in pose_pair["port"].named_parameters():
        w = _jax_leaf(pose_pair["jax_grads"], name, p)
        got.append(p.grad.numpy().ravel())
        want.append(w.ravel())
    assert len(want) == len(pose_pair["jax_grads"])
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-4


def test_pose_step_update(pose_pair):
    for name, p in pose_pair["port"].named_parameters():
        want = (_jax_leaf(pose_pair["jax_params"], name, p)
                - _jax_leaf(pose_pair["jax_old"], name, p))
        got = (p.detach() - pose_pair["before"][name]).numpy()
        g = _jax_leaf(pose_pair["jax_grads"], name, p)
        keep = (g == 0) | (np.abs(g) > 1e-2 * np.sqrt((g ** 2).mean()))
        assert keep.mean() > 0.5, name
        assert _rel(got[keep], want[keep]) <= 1e-3, (name, _rel(got, want))


def test_robotnet_weight_bridge_is_strict_both_ways():
    variables = _pose_pair("robotnet-pose")["variables"]
    port = load_jax_variables(RobotNet(backbone="minkunet14A"), variables)
    assert not hasattr(port, "final")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = import_state_dict(sd, variables, strict=True)
    flat = lambda t: {p: np.asarray(x) for p, x in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for p in a:
        np.testing.assert_array_equal(a[p], b[p])


def test_select_pose_model():
    data = DataConfig(voxelize_position=True, scale=200.0)
    model = select_pose_model(PoseModelConfig(backbone="minkunet14A"), data)
    assert isinstance(model, RobotNet)
    assert model.pose_regression[2].out_features == 7
    model = select_pose_model(PoseModelConfig(
        backbone="minkunet14A", encode_only=True, compute_confidence=True,
        use_joint_angles=True), data)
    assert isinstance(model, RobotNetEncode)
    assert model.pose_regression[2].out_features == 10
    assert model.quantization_size == 0.005 and model.use_joint_angles
    assert model.pose_regression[0].in_features == 256 + 9
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_pose_model(PoseModelConfig(backbone="pointnet2"), data)
    assert ee_capacity(DataConfig()) == 4096
    assert ee_capacity(DataConfig(max_points=1000)) == 1024


def test_train_pose_main_on_cpu(tmp_path):
    cfg = DataConfig(max_points=1024)
    hist = train_pose(TrainConfig(batch_size=2),
                      PoseModelConfig(backbone="minkunet14A",
                                      encode_only=True, use_joint_angles=True),
                      epochs=1, device="cpu", data_cfg=cfg,
                      dataset=PoseDataset(cfg, 2, seed=1, **SAMPLE_KW),
                      exp_path=str(tmp_path), exp_name="pose")
    assert len(hist) == 1 and hist[0]["batches"] == 1
    assert all(np.isfinite(hist[0][k]) for k in METRICS)


def test_pose_step_defaults_to_the_card():
    model = RobotNetEncode(backbone="minkunet14A")
    args = (model, DataConfig(), LossConfig(), TrainConfig(), 1024)
    if torch.cuda.is_available():
        make_pose_train_step(*args)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_pose_train_step(*args)


def test_loss_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(LossConfig)] == \
        [f.name for f in dataclasses.fields(JaxLossConfig)]
