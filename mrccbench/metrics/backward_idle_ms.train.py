"""backward_idle_ms.train: the card's idle ms per train step while the host is
inside the program's ``mrcc.train.backward`` spans (``loss.backward()``: the
autograd Functions and the dW kernels, run on autograd's device thread while
this one waits), over the traced steps (``harness/stage_idle.py``).  Layer:
autograd.  Moves: train_steps_per_s."""

from mrccbench.harness import stage_idle

LAYER = "autograd"
MOVES = "train_steps_per_s"


def read(ctx):
    return stage_idle.stage_idle_ms(ctx.get("trace"), "backward")
