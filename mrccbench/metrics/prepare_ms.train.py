"""prepare_ms.train: mean ms of the train step's ``prepare`` stage
(voxelize with labels, ``build_hierarchy``, the k3 tables where the route
takes them), a synchronised host-clock span around ``step.prepare`` over
the traced run's span steps.  Layer: sparse core.  Moves:
train_steps_per_s."""

LAYER = "sparse core"
MOVES = "train_steps_per_s"


def read(ctx):
    spans = ctx.get("spans", {}).get("prepare")
    return 1e3 * sum(spans) / len(spans) if spans else None
