"""conv_roofline.train: the sparse convs' share of their roofline over the
traced train steps, in %: the least time of the k3, down and up convs'
forward, input-gradient and weight-gradient work that the steps' voxels
need (``work/counts.py``: operations at the dtype's tensor-core peak or
bytes at the HBM bandwidth, whichever is longer) over the device time of
the hand-written conv kernels, matched by name below.  None where no
kernel matches.  Layer: kernels.  Moves: train_steps_per_s."""

from mrccbench.harness import profiling

LAYER = "kernels"
MOVES = "train_steps_per_s"
# the k3, down and up convs and their dW kernels (csrc/conv_*.cu on
# gather_mma.cuh, list_mma.cuh, hit_lists.cuh, dw_gemm.cuh, q8_mma.cuh,
# q8_quantize.cuh)
KERNELS = ("gather_mma", "resolve_kernel", "list_mma", "child_sum",
           "zero_rows", "hit_lists", "dw_mma", "dw_reduce", "quantize_q8",
           "quantize_w_q8", "act_absmax_q8")


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace.get("conv_least_s"):
        return None
    device = profiling.device_seconds(trace, KERNELS)
    return 100.0 * trace["conv_least_s"] / device if device > 0 else None
