"""The plain reference of the segmentation net: MinkUNet (conv0, four
stride-2 encoder stages of basic blocks, four transpose-conv decoder stages
with skip concatenation, a final 1x1 conv) under the RobotNet segmentation
head (LeakyReLU 0.01, Linear to 1024, LeakyReLU, Linear to the classes),
written from the architecture of the original code release
(MinkowskiEngine's MinkUNet18 family, ``config/default.yaml``'s segmentation
net), with parameters named as in its state dict.

Parameters are a flat ``{name: tensor}``; :func:`parameter_spec` lists
their names, shapes and initial draws, :func:`layer_plan` every product of
the forward pass with its level and widths (for the work counts).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import nn as rnn

PLANES = {
    "A": (32, 64, 128, 256, 128, 128, 96, 96),
    "B": (32, 64, 128, 256, 128, 128, 128, 128),
    "C": (32, 64, 128, 256, 192, 192, 128, 128),
    "D": (32, 64, 128, 256, 384, 384, 384, 384),
}
LAYERS = {"minkunet14": (1,) * 8, "minkunet18": (2,) * 8}
INIT_DIM = 32
LEAKY = 0.01


def architecture(backbone: str):
    """``(planes, layers)`` of a basic-block MinkUNet name such as
    ``minkunet18D`` or ``minkunet14A``."""
    return PLANES[backbone[-1].upper()], LAYERS[backbone[:-1].lower()]


def _blocks(planes, layers):
    """``(name, level, inplanes, planes)`` of every basic block, in forward
    order, and the width entering the final conv."""
    out, inplanes = [], INIT_DIM
    for s in (1, 2, 3, 4):
        for i in range(layers[s - 1]):
            out.append((f"block{s}.{i}", s, inplanes, planes[s - 1]))
            inplanes = planes[s - 1]
    skips = (planes[2], planes[1], planes[0], INIT_DIM)
    for j, s in enumerate((4, 5, 6, 7)):
        inplanes = planes[s] + skips[j]
        for i in range(layers[s]):
            out.append((f"block{s + 1}.{i}", 7 - s, inplanes, planes[s]))
            inplanes = planes[s]
    return out, inplanes


def layer_plan(cfg) -> List[Tuple[str, str, int, int, int]]:
    """Every product of the forward pass, in order: ``(name, kind, level,
    Cin, Cout)`` with kind ``k3`` (on ``level``), ``down`` (``level - 1``
    to ``level``), ``up`` (``level + 1`` to ``level``), ``dense`` (one row
    per voxel of ``level``)."""
    planes, layers = architecture(cfg["backbone"])
    plan = [("conv0p1s1", "k3", 0, cfg["in_channels"], INIT_DIM)]
    blocks, final_in = _blocks(planes, layers)
    width = INIT_DIM
    by_stage = {}
    for name, level, cin, cout in blocks:
        by_stage.setdefault(name.split(".")[0], []).append(
            (name, level, cin, cout))
    for s in (1, 2, 3, 4):
        plan.append((f"conv{s}p{1 << (s - 1)}s2", "down", s, width, width))
        for name, level, cin, cout in by_stage[f"block{s}"]:
            plan += _block_plan(name, level, cin, cout)
            width = cout
    for s in (4, 5, 6, 7):
        plan.append((f"convtr{s}p{1 << (8 - s)}s2", "up", 7 - s, width,
                     planes[s]))
        for name, level, cin, cout in by_stage[f"block{s + 1}"]:
            plan += _block_plan(name, level, cin, cout)
            width = cout
    unet_out = cfg["unet_out_channels"]
    plan += [("final", "dense", 0, final_in, unet_out),
             ("regression.0", "dense", 0, unet_out, cfg["head_width"]),
             ("regression.2", "dense", 0, cfg["head_width"],
              cfg["num_classes"])]
    return plan


def _block_plan(name, level, cin, cout):
    plan = [(f"{name}.conv1", "k3", level, cin, cout),
            (f"{name}.conv2", "k3", level, cout, cout)]
    if cin != cout:
        plan.append((f"{name}.downsample.0", "dense", level, cin, cout))
    return plan


def parameter_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, init)`` of every parameter; init ``he`` (normal, std
    sqrt(2 / Cout), fan-out), ``lecun`` (normal, std sqrt(1 / fan_in)),
    ``one`` or ``zero``."""
    spec = []
    taps = {"k3": 27, "down": 8, "up": 8, "dense": 1}
    for name, kind, _, cin, cout in layer_plan(cfg):
        if name.startswith("regression"):
            spec += [(f"{name}.linear.weight", (cout, cin), "lecun"),
                     (f"{name}.linear.bias", (cout,), "zero")]
            continue
        spec.append((f"{name}.kernel", (taps[kind], cin, cout), "he"))
        if name == "final":
            spec.append(("final.bias", (cout,), "zero"))
            continue
        norm = _norm_of(name)
        spec += [(f"{norm}.bn.weight", (cout,), "one"),
                 (f"{norm}.bn.bias", (cout,), "zero")]
    return spec


def _norm_of(conv_name: str) -> str:
    """The batch norm that follows a conv, by the state dict's names."""
    if conv_name == "conv0p1s1":
        return "bn0"
    if conv_name.startswith("convtr"):
        return "bntr" + conv_name[6]
    if conv_name.startswith("conv"):
        return "bn" + conv_name[4]
    stem, last = conv_name.rsplit(".", 1)
    if last == "0":  # downsample.0 -> downsample.1
        return stem + ".1"
    return f"{stem}.norm{last[-1]}"


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``: the normal draws in one call of a
    ``torch.Generator`` on ``device``, then scaled leaf by leaf."""
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


def forward(p, feats, levels, octs, prec: rnn.Precision):
    """Per-voxel class logits ``[M0, num_classes]``."""
    def bn(x, name):
        return rnn.batch_norm(x, p[f"{name}.bn.weight"], p[f"{name}.bn.bias"])

    def block(x, name, level):
        out = torch.relu(bn(rnn.conv_k3(x, p[f"{name}.conv1.kernel"], level,
                                        prec), f"{name}.norm1"))
        out = bn(rnn.conv_k3(out, p[f"{name}.conv2.kernel"], level, prec),
                 f"{name}.norm2")
        res = x
        if f"{name}.downsample.0.kernel" in p:
            res = bn(rnn.matmul(x, p[f"{name}.downsample.0.kernel"][0], prec),
                     f"{name}.downsample.1")
        return torch.relu(out + res)

    def stage(x, s, level):
        i = 0
        while f"block{s}.{i}.conv1.kernel" in p:
            x = block(x, f"block{s}.{i}", level)
            i += 1
        return x

    x = torch.relu(bn(rnn.conv_k3(feats, p["conv0p1s1.kernel"], levels[0],
                                  prec), "bn0"))
    skips = [x]
    for s in (1, 2, 3, 4):
        w = p[f"conv{s}p{1 << (s - 1)}s2.kernel"]
        x = torch.relu(bn(rnn.conv_down(x, w, octs[s - 1], levels[s], prec),
                          f"bn{s}"))
        x = stage(x, s, levels[s])
        skips.append(x)
    for s in (4, 5, 6, 7):
        fine = 7 - s
        w = p[f"convtr{s}p{1 << (8 - s)}s2.kernel"]
        x = torch.relu(bn(rnn.conv_up(x, w, octs[fine], levels[fine], prec),
                          f"bntr{s}"))
        x = torch.cat([x, skips[fine]], dim=-1)
        x = stage(x, s + 1, levels[fine])
    x = rnn.matmul(x, p["final.kernel"][0], prec) + p["final.bias"]
    x = F.leaky_relu(x, LEAKY)
    for name in ("regression.0", "regression.2"):
        x = (rnn.matmul(x, p[f"{name}.linear.weight"].t(), prec)
             + p[f"{name}.linear.bias"])
        if name == "regression.0":
            x = F.leaky_relu(x, LEAKY)
    return x
