"""The int8 engine over the f32 table budget vs the JAX int8 engine (CPU).

``conv_impl="pallas-int8"`` with ``compute_dtype="float32"`` and seg
levels of 49152 / 24576 rows: at itemsize 4 the 128-lane tables pass the
TPU's budget only through the streamed route (49152 rows) or lane packing
(24576 rows), so every conv stays in int8 on the JAX engine and on the
port.  The k3 conv of level 0, the down conv into level 1 and the up conv
back are held against the JAX convs under ``"pallas-int8"`` (one cloud;
f32 outputs to 1e-5 relative), routes included
(``test_torch_q8_routes.check_configuration``).
"""

import pytest
import torch

from test_torch_q8_routes import check_configuration


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_int8_f32_levels_over_the_table_budget_match_jax():
    check_configuration(
        dict(seg_voxel_capacity=49152, compute_dtype="float32",
             seg_hierarchy_caps=(24576, 12288, 6144, 3072)), "seg",
        [("k3", 0), ("down", 0), ("up", 0)], [True, True, True], seed=14)
