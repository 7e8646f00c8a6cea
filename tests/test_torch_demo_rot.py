"""The trained demo's rotation trainer against the JAX ``Trainer`` as
``scripts/train_demo_checkpoints.py`` builds it (see
``test_torch_demo.py``): r2's cos2 quaternion head, and r5's continuous 6D
head with the confidence heads and the symmetry-aware loss
(``--rot-6d --confidence --symmetry-loss``), 2 epochs of 2 steps at a tiny
size on the CPU, every epoch metric within ``rtol=1e-4`` (``atol``
1e-6)."""

import pytest

from test_torch_demo import FLAGS, check_histories, fit_pair
from test_torch_demo import _one_thread  # noqa: F401 (one intra-op thread)


@pytest.mark.parametrize("flags", [[], ["--rot-6d", "--confidence",
                                        "--symmetry-loss"]],
                         ids=["cos2", "6d_confidence_symmetry"])
def test_rotation_trainer_matches_jax(flags, tmp_path):
    check_histories(*fit_pair("rotation", FLAGS + flags, tmp_path))
