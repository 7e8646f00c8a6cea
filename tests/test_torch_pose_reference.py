"""The port's pose train step against the benchmark's plain reference
(``mrccbench/reference/robotnet.py``: plain ``torch``, f32, no port code),
on the CPU at a small size: ``RobotNet`` on minkunet14A, B = 2 end-effector
crops, voxel capacity 512, the ``cos2`` criterion, AdamW, one torch thread.

Both start from the same weights drawn from a seed and step on the same
crops (``mrccbench/data/crops.py``), which are laid out as the port's own
``ee_seg`` item and pose collate lay out the same scene.  Compared, each
leaf's gap of norms taken against ``max(its reference norm, the median
leaf's)``:

- the first loss, which no optimizer step has touched;
- each leaf's first gradient norm;
- each parameter's change over three AdamW steps.

The first loss is held tight: f32 rounding leaves gaps under 1e-6 (the
reference's own spread under a 1e-7 relative move of the colours reads
1.3e-6 at this size), while the reference in TF32 reads 1.8e-3, so the test
tells f32 from a lower precision.  The gradient and change tolerances leave
room for a ReLU gate that rounding flips: over eight seeds at this size the
worst leaf read under 1e-6 (gradient) and 1e-4 (change) on seven and
3.7e-3 and 1.0e-2 on one, where a gate in the coarse levels flipped.
"""

import numpy as np
import pytest
import torch

from mrcc_tpu_torch.data.dataset import DataConfig, collate, pose_item
from mrcc_tpu_torch.models import RobotNet
from mrcc_tpu_torch.train import LossConfig, TrainConfig, make_pose_train_step
from mrccbench.data import crops, scenes
from mrccbench.reference import robotnet

CFG = {"backbone": "minkunet14A", "in_channels": 3, "out_channels": 7,
       "head_width": 2048, "voxel_size": 0.01,
       "optimizer": {"lr": 1e-4, "weight_decay": 1e-4,
                     "betas": [0.9, 0.999], "eps": 1e-8}}
MIX = {"voxel_capacity": 512}
SCENE = {"n_ee": 1500, "n_arm": 600, "n_bg": 1000}
B, P, STEPS = 2, 2048, 3
# the first loss: a relative gap; f32 rounding leaves < 1e-6, TF32 1.8e-3
LOSS_TOL = 2e-5
# a leaf's gradient norm: one ReLU gate that rounding flips in a coarse
# level (a few dozen rows) moved every encoder leaf by up to 3.7e-3
GRAD_TOL = 2e-2
# a parameter's change over three AdamW steps: Adam moves each element by
# about lr * sign(g), so an element whose gradient rounding or a flipped
# gate moves near 0 may move either way (1.0e-2 under the flip above);
# leaves whose first gradient is under a thousandth of the median leaf's
# are left out, as in the benchmark's check
CHANGE_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeds(seed):
    return scenes.scene_seeds(seed, B)


def _port_step(weights):
    model = RobotNet(backbone=CFG["backbone"], in_channels=3, out_channels=7)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    assert not unexpected
    assert all(k.endswith(("running_mean", "running_var")) for k in missing)
    opt = CFG["optimizer"]
    step, _ = make_pose_train_step(
        model, DataConfig(data_type="ee_seg", max_points=P, scale=100.0),
        LossConfig(loss_type="cos2"),
        TrainConfig(batch_size=B, lr=opt["lr"],
                    weight_decay=opt["weight_decay"]),
        MIX["voxel_capacity"], device="cpu")
    return model, step


def _readings(seed):
    """``(program, reference)``: first loss, first gradients and the
    change over ``STEPS`` steps, by leaf."""
    weights = robotnet.make_weights(CFG, seed, "cpu")
    batches = [crops.pose_batch(_seeds(seed + i), P, **SCENE)
               for i in range(STEPS)]
    model, step = _port_step(weights)
    lr = CFG["optimizer"]["lr"]
    prepared = step.prepare(batches[0])
    _, loss = step.forward(*prepared)
    step.backward(loss)
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
    step.update(lr)
    for batch in batches[1:]:
        step(batch, lr)
    program = {"loss": float(loss.detach()), "grad": grads,
               "change": {k: p.detach() - weights[k]
                          for k, p in model.named_parameters()}}
    ref = robotnet.PoseReferenceTrainer(CFG, MIX, weights)
    ref_loss, ref_grads = ref.step(batches[0])
    for batch in batches[1:]:
        ref.step(batch)
    reference = {"loss": ref_loss, "grad": ref_grads,
                 "change": {k: ref.params[k].detach() - weights[k]
                            for k in weights}}
    return program, reference


@pytest.fixture(scope="module", params=[2 ** 31 + 25, 2 ** 33 + 7])
def readings(request):
    return _readings(request.param)


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _gaps(got, want, leaves):
    med = float(np.median([want[k] for k in leaves]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in leaves}


def test_the_first_loss_matches_the_reference(readings):
    program, reference = readings
    assert reference["loss"] > 0
    gap = abs(program["loss"] - reference["loss"]) / reference["loss"]
    assert gap <= LOSS_TOL, (program["loss"], reference["loss"])


def test_each_leaf_gradient_norm_matches_the_reference(readings):
    program, reference = readings
    got, want = _norms(program["grad"]), _norms(reference["grad"])
    assert set(got) == set(want)
    gaps = _gaps(got, want, list(want))
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, got[worst], want[worst])


def test_three_adamw_steps_change_each_leaf_as_the_reference(readings):
    program, reference = readings
    grad = _norms(reference["grad"])
    med = float(np.median(list(grad.values())))
    moving = [k for k in grad if grad[k] >= 1e-3 * med]
    assert len(moving) > 0.9 * len(grad)
    got, want = _norms(program["change"]), _norms(reference["change"])
    gaps = _gaps(got, want, moving)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= CHANGE_TOL, (worst, got[worst], want[worst])


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 40 + 11])
def test_the_crop_layout_is_the_program_ee_seg_item_and_collate(seed):
    """The same scene, points, colours, labels and pose through the port's
    ``pose_item`` (``data_type="ee_seg"``, ``center_at_origin``) and
    ``collate`` give the benchmark's batch bit for bit."""
    seeds = _seeds(seed)
    want = crops.pose_batch(seeds, P, **SCENE)
    items = []
    for s in seeds:
        points, rgb, labels = scenes.scene(s, **SCENE)
        wxyz = crops.ee_pose(s)
        sample = {"points": points, "rgb": rgb, "labels": labels,
                  "instance_labels": labels,
                  "pose": np.concatenate([wxyz[:3], wxyz[4:], wxyz[3:4]]),
                  "joint_angles": None}
        items.append(pose_item(sample, DataConfig(
            data_type="ee_seg", max_points=P, center_at_origin=True)))
    got = collate(items, DataConfig(data_type="ee_seg", max_points=P))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = want["mask"].sum(1)
    assert (n == SCENE["n_ee"]).all()
    # the crop is centred on its bounding box, the label with it
    pts = want["points"][0, :n[0]]
    np.testing.assert_allclose(pts.max(0) + pts.min(0), 0, atol=1e-6)


def test_the_weights_fit_the_program_state_dict_by_name_and_shape():
    weights = robotnet.make_weights(CFG, 5, "cpu")
    model = RobotNet(backbone=CFG["backbone"], in_channels=3, out_channels=7)
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    assert all(params[k].shape == weights[k].shape for k in weights)
