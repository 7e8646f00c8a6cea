"""The plain reference of the pose net and of one of its train steps:
RobotNet on the MinkUNet backbone, the ``cos2`` criterion and AdamW, in
float32 with every product as ``torch.mm`` (TF32 off), written from the
original code release's ``model/robotnet.py`` (``RobotNet``: the MinkUNet
without its final conv, ``output_layer`` batch norm and ReLU, a global max
pool, ``pose_regression`` Linear to 2048, LeakyReLU 0.01, Linear to 7) and
``config/default.yaml``'s default ``train.py`` job, with parameters named
as the port's state dict names them (``output_layer.0.bn.*``,
``pose_regression.0.*``, ``pose_regression.2.*``).

The backbone reuses :mod:`.nn`'s convs, products and batch norm and
:mod:`.sparse`'s voxels, levels and maps.  Rows are the valid voxels of the
whole batch, sorted by item (:mod:`.sparse`), so the batch norms run over
every row and the pool takes each item's maximum over its own rows.

Departures from the release, each kept by the port too:

* the pool's empty item reads 0 (MinkowskiEngine drops it);
* with 7 outputs there is no confidence sigmoid, and in train mode no
  quaternion normalisation (the release normalises at eval only);
* ``cos2`` takes the cosine over the whole 7-vector, position included,
  where the release meant the quaternion: the release's own quirk;
* the optimizer is AdamW (the release's "Adam" with weight decay, as the
  JAX package's ``optax.adamw``), as :mod:`.train` steps it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import minkunet, sparse, train as ref_train
from .nn import Precision, batch_norm, conv_down, conv_k3, conv_up, matmul

LEAKY = minkunet.LEAKY
EPS_COS = 1e-6
# the head's products run on one row an item: in a layer plan they sit on
# this level, one past the backbone's levels 0-4, whose rows are the items
ITEMS = 5


def layer_plan(cfg) -> List[Tuple[str, str, int, int, int]]:
    """Every product of the pose net's forward pass, in order (as
    :func:`minkunet.layer_plan`): the U-Net without its final conv and
    head, then ``pose_regression.0`` and ``.2`` as dense products on one
    row an item (level :data:`ITEMS`)."""
    plan = [p for p in minkunet.layer_plan(
        dict(cfg, unet_out_channels=1, num_classes=1))
        if p[0] != "final" and not p[0].startswith("regression")]
    width = unet_width(cfg)
    return plan + [("pose_regression.0", "dense", ITEMS, width,
                    cfg["head_width"]),
                   ("pose_regression.2", "dense", ITEMS, cfg["head_width"],
                    cfg["out_channels"])]


def unet_width(cfg) -> int:
    """Channels a voxel leaves the decoder with (384 for 18D)."""
    return minkunet._blocks(*minkunet.architecture(cfg["backbone"]))[1]


def parameter_spec(cfg):
    """``(name, shape, init)`` of every parameter (inits as
    :func:`minkunet.parameter_spec`); a linear's weight is ``[out, in]``,
    and the output norm comes between the backbone and the head."""
    spec = []
    taps = {"k3": 27, "down": 8, "up": 8, "dense": 1}
    for name, kind, _, cin, cout in layer_plan(cfg):
        if name == "pose_regression.0":
            spec += [("output_layer.0.bn.weight", (cin,), "one"),
                     ("output_layer.0.bn.bias", (cin,), "zero")]
        if name.startswith("pose_regression"):
            spec += [(f"{name}.weight", (cout, cin), "lecun"),
                     (f"{name}.bias", (cout,), "zero")]
            continue
        spec.append((f"{name}.kernel", (taps[kind], cin, cout), "he"))
        norm = minkunet._norm_of(name)
        spec += [(f"{norm}.bn.weight", (cout,), "one"),
                 (f"{norm}.bn.bias", (cout,), "zero")]
    return spec


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, drawn as
    :func:`minkunet.make_weights` draws them: the normal draws in one call
    of a ``torch.Generator`` on ``device``, then scaled leaf by leaf."""
    spec = parameter_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    drawn = [s for s in spec if s[2] in ("he", "lecun")]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in spec:
        if init in ("he", "lecun"):
            n = math.prod(shape)
            std = math.sqrt((2.0 if init == "he" else 1.0) / shape[-1])
            out[name] = (flat[at:at + n].view(shape) * std).clone()
            at += n
        else:
            fill = 1.0 if init == "one" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def backbone(p, feats, levels, octs, prec: Precision):
    """The MinkUNet's decoder output ``[M0, width]``: conv0, the four
    stride-2 encoder stages, the four transpose-conv decoder stages with
    their skips; no final conv."""
    def bn(x, name):
        return batch_norm(x, p[f"{name}.bn.weight"], p[f"{name}.bn.bias"])

    def block(x, name, level):
        out = torch.relu(bn(conv_k3(x, p[f"{name}.conv1.kernel"], level,
                                    prec), f"{name}.norm1"))
        out = bn(conv_k3(out, p[f"{name}.conv2.kernel"], level, prec),
                 f"{name}.norm2")
        res = x
        if f"{name}.downsample.0.kernel" in p:
            res = bn(matmul(x, p[f"{name}.downsample.0.kernel"][0], prec),
                     f"{name}.downsample.1")
        return torch.relu(out + res)

    def stage(x, s, level):
        i = 0
        while f"block{s}.{i}.conv1.kernel" in p:
            x = block(x, f"block{s}.{i}", level)
            i += 1
        return x

    x = torch.relu(bn(conv_k3(feats, p["conv0p1s1.kernel"], levels[0], prec),
                      "bn0"))
    skips = [x]
    for s in (1, 2, 3, 4):
        w = p[f"conv{s}p{1 << (s - 1)}s2.kernel"]
        x = torch.relu(bn(conv_down(x, w, octs[s - 1], levels[s], prec),
                          f"bn{s}"))
        x = stage(x, s, levels[s])
        skips.append(x)
    for s in (4, 5, 6, 7):
        fine = 7 - s
        w = p[f"convtr{s}p{1 << (8 - s)}s2.kernel"]
        x = torch.relu(bn(conv_up(x, w, octs[fine], levels[fine], prec),
                          f"bntr{s}"))
        x = torch.cat([x, skips[fine]], dim=-1)
        x = stage(x, s + 1, levels[fine])
    return x


def item_max(x, level: sparse.Level):
    """Each item's maximum over its rows, ``[B, C]`` (0 for an item with
    no rows): the rows laid out ``[B, most rows, C]`` with -inf padding,
    then ``amax``, whose gradient goes to the arg-max row."""
    b = int(level.count.shape[0])
    first = torch.cumsum(level.count, 0) - level.count
    pos = torch.arange(level.rows, device=x.device) - first[level.item]
    most = max(int(level.count.max()), 1) if b else 1
    dense = x.new_full((b, most, x.shape[-1]), float("-inf"))
    dense = dense.index_put((level.item, pos), x)
    m = dense.amax(dim=1)
    return torch.where(level.count[:, None] > 0, m, 0.0)


def forward(p, feats, levels, octs, prec: Precision):
    """The head's output ``[B, out_channels]`` in train mode."""
    x = backbone(p, feats.to(p["conv0p1s1.kernel"].dtype), levels, octs,
                 prec)
    x = torch.relu(batch_norm(x, p["output_layer.0.bn.weight"],
                              p["output_layer.0.bn.bias"]))
    x = item_max(x, levels[0])
    x = (matmul(x, p["pose_regression.0.weight"].t(), prec)
         + p["pose_regression.0.bias"])
    x = F.leaky_relu(x, LEAKY)
    return (matmul(x, p["pose_regression.2.weight"].t(), prec)
            + p["pose_regression.2.bias"])


def cos2_loss(y, y_pred):
    """``mean over B x 3 of (y[:, :3] - y_pred[:, :3])^2`` plus ``2 *
    mean over B of (1 - cosine of the whole 7-vectors)``, each norm
    clamped at 1e-6 (the release's quirk: the cosine takes the position
    too)."""
    y = y.to(y_pred.dtype)
    pos = ((y[:, :3] - y_pred[:, :3]) ** 2).mean()
    a, b = y[:, :7], y_pred[:, :7]
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(EPS_COS)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(EPS_COS)
    cos = (a * b).sum(-1) / (na * nb)
    return pos + 2.0 * (1.0 - cos).mean()


def prepare(cfg, mix, batch, device):
    """``(levels, octs, feats, pose)`` of a numpy pose batch."""
    t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    cap = mix["voxel_capacity"]
    level0, feats, _ = sparse.voxelize(
        t["points"], t["feats"], t["mask"], t["labels"], cfg["voxel_size"],
        cap)
    levels, octs = sparse.hierarchy(level0, sparse.hierarchy_caps(cap),
                                    t["points"].shape[0])
    return levels, octs, feats, t["pose"]


class PoseReferenceTrainer(ref_train.ReferenceTrainer):
    """Plain AdamW training of the reference pose net from ``weights``
    (the optimizer step of :class:`train.ReferenceTrainer`)."""

    def loss(self, batch):
        device = next(iter(self.params.values())).device
        levels, octs, feats, pose = prepare(self.cfg, self.mix, batch,
                                            device)
        out = forward(self.params, feats, levels, octs, self.prec)
        return cos2_loss(pose, out)


def readings(cfg, mix, weights, batches, precision="float32"):
    """The reference's numbers over ``batches``, as :func:`train.readings`
    gives them for the segmentation net."""
    ref = PoseReferenceTrainer(cfg, mix, weights, precision)
    losses, grad = [], None
    for batch in batches:
        loss, g = ref.step(batch)
        losses.append(loss)
        if grad is None:
            grad = ref_train.leaf_norms(g)
        del g
    change = ref_train.leaf_norms({k: ref.params[k].detach() - weights[k]
                                   for k in weights})
    return {"losses": losses, "grad": grad, "change": change}
