"""prepare_idle_ms.pose: the card's idle ms per pose train step while the host
is inside the program's ``mrcc.train.prepare`` spans (the batch's copy to
the card, voxelize, ``build_hierarchy``), over the traced steps
(``harness/stage_idle.py``).  Layer: sparse core.  Moves:
train_steps_per_s."""

from mrccbench.harness import stage_idle

LAYER = "sparse core"
MOVES = "train_steps_per_s"


def read(ctx):
    return stage_idle.stage_idle_ms(ctx.get("trace"), "prepare")
