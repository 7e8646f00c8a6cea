"""Data parallelism over the ranks of a ``torch.distributed`` process group
(``mesh``: the 1-D ``data`` mesh and the train step's global reductions;
``fleet``: process-group bring-up and global arrays)."""

from . import fleet, mesh  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    pad_batch_to,
    replicate,
    shard_batch,
)
