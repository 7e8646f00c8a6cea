"""forward_idle_ms.pose: the card's idle ms per pose train step while the host
is inside the program's ``mrcc.train.forward`` spans (the pose net in train
mode and the criterion), over the traced steps (``harness/stage_idle.py``).
Layer: models.  Moves: train_steps_per_s."""

from mrccbench.harness import stage_idle

LAYER = "models"
MOVES = "train_steps_per_s"


def read(ctx):
    return stage_idle.stage_idle_ms(ctx.get("trace"), "forward")
