"""conv_roofline.pose: the pose step's sparse convs' share of their roofline
over the traced steps, in %, read as ``conv_roofline.train`` reads it: the
least time of the k3, down and up convs' forward, input-gradient and
weight-gradient work that this cell's voxels need (``work/counts.py`` over
``reference/robotnet.py``'s plan, which has no final conv) over the device
time of the hand-written conv kernels.  Layer: kernels.  Moves:
train_steps_per_s."""

from mrccbench.harness import registry

LAYER = "kernels"
MOVES = "train_steps_per_s"


def read(ctx):
    return registry.metric("conv_roofline.train").read(ctx)
