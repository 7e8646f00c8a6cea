"""mfu.pose: the whole pose train step's share of the card's peak, in %, read
as ``mfu.train`` reads it: the model operations of every step in the window
(``work/counts.py`` over ``reference/robotnet.py``'s plan: the backbone's
convs and dense products over the voxels, the head's two products over the
items; forward, weight gradient and, past the first layer, input gradient)
over the window's wall time times the dtype's tensor-core peak
(``work/peaks.py``).  Layer: whole step.  Moves: train_steps_per_s."""

from mrccbench.harness import registry

LAYER = "whole step"
MOVES = "train_steps_per_s"


def read(ctx):
    return registry.metric("mfu.train").read(ctx)
