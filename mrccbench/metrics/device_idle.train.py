"""device_idle.train: the share of the traced window, in %, in which no
kernel, copy or memset ran on the card (``torch.profiler``'s timeline, the
union of the device's intervals).  Layer: device.  Moves:
train_steps_per_s."""

from mrccbench.harness import profiling

LAYER = "device"
MOVES = "train_steps_per_s"


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    window = profiling.window_seconds(trace)
    return 100.0 * (1.0 - profiling.busy_seconds(trace) / window)
