"""kernel_launches.train: hand-written kernel launches per train step, the
sum of the program's launch counters (``mrcc_tpu_torch/tracing.py``
``counts(LaunchCounter)``) over the run's steps divided by its
``train_batches`` counter.  None where the program has no such counters.
Layer: kernels.  Moves: train_steps_per_s."""

LAYER = "kernels"
MOVES = "train_steps_per_s"


def read(ctx):
    if not ctx.get("window"):
        return None
    try:
        from mrcc_tpu_torch import tracing
    except ImportError:
        return None
    batches = tracing.counts().get("train_batches")
    if not batches:
        return None
    return sum(tracing.counts(tracing.LaunchCounter).values()) / batches
