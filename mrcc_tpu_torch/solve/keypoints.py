"""Keypoint post-processing (port of ``mrcc_tpu/solve/keypoints.py``):
per-class best point above a confidence threshold, then a Kabsch fit of
the canonical keypoints onto the detections."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.kabsch import kabsch_pose

# the reference's measured canonical 6 keypoints of the EE
REFERENCE_KEY_POINTS = np.array([
    [0.01982731, 0.08085986, 0.00321919],
    [0.02171595, -0.08986182, 0.00388430],
    [0.01288678, 0.09103118, 0.06127814],
    [0.02079032, -0.09790908, 0.05609143],
    [-0.00185802, 0.04654205, 0.11564558],
    [0.00241113, -0.04262756, 0.11564558],
], dtype=np.float32)


def key_point_predictions(logits, mask, conf_threshold=0.75):
    """Best point per keypoint class, batched.

    Args: logits [B, P, K]; mask [B, P].
    Returns ``(idx [B, K] int32, found [B, K], conf [B, K])``.  Points of one
    voxel share their logits, so ties are the rule: the first maximal point
    wins, as in ``jnp.argmax``.
    """
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask[..., None], probs, -1.0)
    conf = probs.amax(dim=1)
    idx = torch.argmax(probs, dim=1).to(torch.int32)
    return idx, conf > conf_threshold, conf


def pose_from_key_points(kp_coords, found, min_count=4):
    """Kabsch solve of the canonical keypoints onto detections, batched.

    Args: kp_coords [B, K, 3]; found [B, K].
    Returns ``(pose [B, 7], ok [B])``; ok needs ``min_count`` detections.
    Under 3 detections the weights fall back to uniform so the SVD stays
    finite (the pose is then gated by ``ok``).
    """
    ref = torch.as_tensor(REFERENCE_KEY_POINTS, dtype=kp_coords.dtype,
                          device=kp_coords.device)
    n_found = found.sum(dim=-1)
    w = found.to(kp_coords.dtype)
    w_safe = torch.where((n_found >= 3)[..., None], w, torch.ones_like(w))
    pose = kabsch_pose(ref.expand_as(kp_coords), kp_coords, weights=w_safe)
    return pose, n_found >= min_count
