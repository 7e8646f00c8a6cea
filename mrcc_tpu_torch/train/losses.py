"""Training criteria (port of ``mrcc_tpu/train/losses.py``; the
segmentation criterion — the pose criteria come with the pose trainer)."""

from __future__ import annotations

import torch


def segmentation_loss(logits, labels, valid, ignore_label=-100):
    """Mean cross-entropy over the valid voxels whose label is not
    ``ignore_label`` (``train_segmentation.py`` / ``robotnet_vote.py``);
    0 when there is none.  logits [B, N, C], labels [B, N] int, valid
    [B, N] bool."""
    keep = valid & (labels != ignore_label)
    safe = torch.where(keep, labels, 0).long()
    ll = -torch.log_softmax(logits.float(), dim=-1).gather(
        -1, safe[..., None])[..., 0]
    m = keep.float()
    return (ll * m).sum() / torch.clamp_min(m.sum(), 1.0)
