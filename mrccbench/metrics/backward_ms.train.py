"""backward_ms.train: mean ms of the train step's ``backward`` stage (the
autograd Functions of ``ops/conv.py`` and the dW kernels), a synchronised
host-clock span around ``step.backward`` over the traced run's span steps.
Layer: autograd.  Moves: train_steps_per_s."""

LAYER = "autograd"
MOVES = "train_steps_per_s"


def read(ctx):
    spans = ctx.get("spans", {}).get("backward")
    return 1e3 * sum(spans) / len(spans) if spans else None
