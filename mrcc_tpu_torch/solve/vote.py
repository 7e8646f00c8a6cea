"""Vote-based EE centre (port of ``mrcc_tpu/solve/vote.py``, after the
reference's ``utils/output.py:45 get_pred_center``): the mean of the
coordinates of the ``top_k`` highest class-1 vote logits, plus a
``[-ee_r, 0, 0]`` offset turned by the orientation where one is given.

The ``top_k`` points are chosen as ``jax.lax.top_k`` chooses them: by
score, the lower index first among equal scores (a stable descending
sort), so a tie at the k-th score averages the same points as the JAX
function.
"""

from __future__ import annotations

import torch

from ..geometry.transform import quat_to_matrix


def pred_center(logits, coords, mask, ee_r=0.03, q=None, top_k=8):
    """EE centre ``[3]`` from per-point vote logits ``[P, C >= 2]`` (class
    1: on the gripper axis' cross-section), coordinates ``[P, 3]`` and
    validity ``[P]``; ``q``: an optional WXYZ orientation ``[4]``."""
    score = torch.where(mask, logits[:, 1],
                        logits.new_tensor(float("-inf")))
    sel = torch.sort(score, descending=True, stable=True).indices[:top_k]
    center = coords[sel].mean(dim=0)
    if q is not None:
        offset = coords.new_tensor([-ee_r, 0.0, 0.0])
        center = center + quat_to_matrix(q) @ offset
    return center
