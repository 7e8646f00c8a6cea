"""The work a segmentation net's products need, counted from the voxel
coordinates that the benchmark derives itself (``reference.sparse``), so
that it does not depend on the route the program takes.

A conv's operations are ``2 * hits * Cin * Cout``: hits are the (output
voxel, kernel offset) pairs whose input voxel exists (k3), or the fine
voxels whose parent made the coarser level (down and up).  A dense product
counts ``2 * rows * Cin * Cout`` over the valid voxels.  A conv's bytes are
its input rows read once, its weights, and its output rows written once.
The least time of a conv is ``max(operations / peak, bytes / bandwidth)``.
A train step runs each conv's forward, its weight gradient and, except on
the first layer, whose input needs no gradient, its input gradient: three
(two) times the forward's work, each with the forward's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from . import peaks

TAPS = {"k3": 27, "down": 8, "up": 8, "dense": 1}


@dataclasses.dataclass
class LevelStats:
    """Rows per level, k3 hits per level, and the parent links between
    level ``l`` and ``l + 1`` (``links[l]``)."""

    rows: List[int]
    k3_hits: List[int]
    links: List[int]


def level_stats(levels, octs) -> LevelStats:
    return LevelStats(
        rows=[lv.rows for lv in levels],
        k3_hits=[sum(int(r.numel()) for r, _ in lv.k3) for lv in levels],
        links=[sum(int(f.numel()) for f, _ in maps) for maps in octs])


def _conv_work(kind, level, cin, cout, st: LevelStats, itemsize):
    """``(operations, bytes)`` of one forward product."""
    if kind == "k3":
        hits, rows_in, rows_out = st.k3_hits[level], st.rows[level], \
            st.rows[level]
    elif kind == "down":
        hits = st.links[level - 1]
        rows_in, rows_out = hits, st.rows[level]
    elif kind == "up":
        hits = st.links[level]
        rows_in, rows_out = st.rows[level + 1], st.rows[level]
    else:
        hits = rows_in = rows_out = st.rows[level]
    ops = 2 * hits * cin * cout
    nbytes = itemsize * (rows_in * cin + TAPS[kind] * cin * cout
                         + rows_out * cout)
    return ops, nbytes


def step_work(plan, st: LevelStats, dtype: str, training: bool) -> Dict:
    """``{"model_ops", "conv_least_s"}`` of one forward pass
    (``training``: one train step) of ``plan``
    (``reference.minkunet.layer_plan``)."""
    itemsize = peaks.ITEMSIZE[dtype]
    peak = peaks.FLOPS[dtype]
    model_ops = 0
    least = 0.0
    for i, (_, kind, level, cin, cout) in enumerate(plan):
        ops, nbytes = _conv_work(kind, level, cin, cout, st, itemsize)
        times = (2 if i == 0 else 3) if training else 1
        model_ops += times * ops
        if kind == "dense":
            continue
        least += times * max(ops / peak, nbytes / peaks.HBM_BYTES_PER_S)
    return {"model_ops": model_ops, "conv_least_s": least}
