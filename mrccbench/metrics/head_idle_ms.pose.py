"""head_idle_ms.pose: the card's idle ms per pose train step while the host is
inside the program's ``mrcc.models.pose_head`` spans (the output norm and
ReLU, the global pool, the MLP) or its ``mrcc.train.criterion`` spans, the
union of both, over the traced steps (``harness/stage_idle.py``).  None
without a step span or without either span.  Layer: models.  Moves:
train_steps_per_s."""

from mrccbench.harness import profiling, stage_idle

LAYER = "models"
MOVES = "train_steps_per_s"
SPANS = ("mrcc.models.pose_head", "mrcc.train.criterion")


def read(ctx):
    parsed = ctx.get("trace")
    steps = stage_idle.steps(parsed) if parsed else 0
    if not steps:
        return None
    w0, w1 = parsed["window"]
    spans = profiling._union([(max(a, w0), min(b, w1))
                              for n, a, b, _ in parsed["host"]
                              if n in SPANS and b > w0 and a < w1])
    if not spans:
        return None
    idle = stage_idle._overlap_us(stage_idle.idle_intervals(parsed), spans)
    return 1e-3 * idle / steps
