"""mfu.train: the whole train step's share of the card's peak, in %: the
model operations of every step in the window (``work/counts.py``: each
sparse conv's and dense product's forward, weight-gradient and, past the
first layer, input-gradient operations, counted from the voxels) over the
window's wall time times the configuration dtype's tensor-core peak
(``work/peaks.py``).  Layer: whole step.  Moves: train_steps_per_s."""

from mrccbench.work import peaks

LAYER = "whole step"
MOVES = "train_steps_per_s"


def read(ctx):
    win = ctx.get("window", {})
    if not win.get("model_ops") or not win.get("seconds"):
        return None
    return 100.0 * win["model_ops"] / (win["seconds"]
                                       * peaks.FLOPS[ctx["dtype"]])
