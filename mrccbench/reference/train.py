"""The plain reference of one segmentation train step and the numbers that
decide ``correct`` for a training cell.

A step: voxelize the batch with its labels, build the stride levels and
their maps (:mod:`.sparse`), the net's forward pass in train mode
(:mod:`.minkunet`), the mean cross-entropy over the labelled voxels, its
gradients, and AdamW with decoupled weight decay (``p -= lr * wd * p``,
then Adam's bias-corrected step).

The readings (:func:`compare`), each leaf's gap of norms taken against
``max(the reference's norm of that leaf, the median leaf's)``:

* ``loss``: the largest relative gap of the steps' losses;
* ``loss_first``: the first step's, which no optimizer step has touched
  yet, so it moves with the arithmetic of one forward pass alone;
* ``grad`` and ``grad_median``: the worst and the median leaf's gap of the
  first step's gradient norms, the program's worked out from its optimizer
  state after one step (``exp_avg / (1 - beta1)``);
* ``change``: the worst leaf's gap of the norms of each parameter's change
  over the steps, leaving out leaves whose first gradient in the
  reference is under a thousandth of the median leaf's (AdamW moves such a
  leaf by round-off alone).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from . import minkunet, sparse
from .nn import Precision, cross_entropy

ZERO_GRAD = 1e-3  # of the median leaf's first gradient norm


@dataclasses.dataclass
class Optim:
    lr: float
    weight_decay: float
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8


def prepare(cfg, mix, batch, device):
    """``(levels, octs, feats, labels)`` of a numpy batch."""
    t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    cap = mix["voxel_capacity"]
    level0, feats, labels = sparse.voxelize(
        t["points"], t["feats"], t["mask"], t["labels"], cfg["voxel_size"],
        cap, cfg["ignore_label"])
    levels, octs = sparse.hierarchy(level0, sparse.hierarchy_caps(cap),
                                    t["points"].shape[0])
    return levels, octs, feats, labels


class ReferenceTrainer:
    """Plain AdamW training of the reference net from ``weights``."""

    def __init__(self, cfg, mix, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.cfg, self.mix = cfg, mix
        self.prec = Precision(precision)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.t = 0
        o = cfg["optimizer"]
        self.opt = Optim(lr=o["lr"], weight_decay=o["weight_decay"],
                         betas=tuple(o["betas"]), eps=o["eps"])

    def loss(self, batch):
        levels, octs, feats, labels = prepare(
            self.cfg, self.mix, batch, next(iter(self.params.values())).device)
        logits = minkunet.forward(self.params, feats, levels, octs, self.prec)
        return cross_entropy(logits, labels, self.cfg["ignore_label"])

    def step(self, batch):
        """One step; returns ``(loss, {name: gradient})``."""
        names = list(self.params)
        loss = self.loss(batch)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        o = self.opt
        self.t += 1
        b1, b2 = o.betas
        with torch.no_grad():
            for n, g in zip(names, grads):
                p, m, v = self.params[n], self.m[n], self.v[n]
                p.mul_(1 - o.lr * o.weight_decay)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5).add_(o.eps)
                p.addcdiv_(m, denom, value=-o.lr / (1 - b1 ** self.t))
        return float(loss.detach()), dict(zip(names, grads))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def readings(cfg, mix, weights, batches, precision="float32"):
    """The reference's numbers over ``batches``: ``{"losses", "grad"
    (first step's gradient norm by leaf), "change" (norm of each
    parameter's change over the steps)}``."""
    ref = ReferenceTrainer(cfg, mix, weights, precision)
    losses, grad = [], None
    for batch in batches:
        loss, g = ref.step(batch)
        losses.append(loss)
        if grad is None:
            grad = leaf_norms(g)
        del g
    change = leaf_norms({k: ref.params[k].detach() - weights[k]
                         for k in weights})
    return {"losses": losses, "grad": grad, "change": change}


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _gaps(got: Dict[str, float], want: Dict[str, float], leaves):
    """Each leaf's gap of norms against ``max(its norm, the median
    leaf's)``."""
    med = _median([want[k] for k in leaves])
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in leaves}


def _worst(gaps: Dict[str, float]):
    leaf = max(gaps, key=gaps.__getitem__)
    return gaps[leaf], leaf


def loss_gaps(program, reference):
    """Each step's relative loss gap."""
    return [abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                 reference["losses"])]


def compare(program, reference):
    """``{name: (value, where)}`` of every number :mod:`calibrate` reads;
    a cell compares those its ``limits`` name."""
    steps = loss_gaps(program, reference)
    worst = max(range(len(steps)), key=steps.__getitem__)
    grad = reference["grad"]
    med = _median(list(grad.values()))
    moving = [k for k in grad if grad[k] >= ZERO_GRAD * med]
    grads = _gaps(program["grad"], grad, list(grad))
    return {"loss": (steps[worst], f"step {worst + 1}"),
            "loss_first": (steps[0], "step 1"),
            "grad": _worst(grads),
            "grad_median": (_median(list(grads.values())), "median leaf"),
            "change": _worst(_gaps(program["change"], reference["change"],
                                   moving))}
