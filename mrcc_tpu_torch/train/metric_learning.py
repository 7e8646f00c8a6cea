"""Metric-learning criterion: MultiSimilarity mining and the triplet margin
loss (port of ``mrcc_tpu/train/metric_learning.py``, after the reference's
``model/featurenet.py``: pytorch_metric_learning's ``MultiSimilarityMiner``
and ``TripletMarginLoss`` at their defaults, miner epsilon 0.1, margin 0.05,
euclidean distances).

Fixed shapes: the miner gives ``[B, B]`` boolean pair masks, and the loss
averages the hinge over every (anchor, mined positive, mined negative)
triple.  Plain tensor ops; autograd gives the gradient.

Ties take JAX's gradient: ``jnp.maximum`` sends half the gradient to each
side where its arguments are equal, and so does ``torch.maximum`` (not
``clamp_min`` or ``relu``, which send all of it to one side), so the hinge
and the ``1e-12`` floor of the squared distance are ``torch.maximum``
against a tensor.
"""

from __future__ import annotations

import torch


def pairwise_dist(emb):
    """Euclidean distance matrix ``[B, B]`` of embeddings ``[B, D]``, from
    ``|a|^2 + |b|^2 - 2 a.b`` floored at 1e-12 before the root."""
    sq = torch.sum(emb ** 2, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * emb @ emb.T
    return torch.sqrt(torch.maximum(d2, d2.new_tensor(1e-12)))


def multi_similarity_miner(emb, labels, epsilon=0.1):
    """Hard pair mining (Wang et al., CVPR 2019, pml defaults):
    ``(pos_mask, neg_mask)`` ``[B, B]``, the positive pairs farther apart
    than the anchor's nearest negative less ``epsilon``, and the negative
    pairs nearer than its farthest positive plus ``epsilon``."""
    d = pairwise_dist(emb)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    pos_pairs = same & ~eye
    neg_pairs = ~same

    big = d.new_tensor(1e12)
    min_neg = torch.where(neg_pairs, d, big).min(dim=1, keepdim=True).values
    max_pos = torch.where(pos_pairs, d, -big).max(dim=1, keepdim=True).values

    pos_mask = pos_pairs & (d > min_neg - epsilon)
    neg_mask = neg_pairs & (d < max_pos + epsilon)
    return pos_mask, neg_mask


def triplet_margin_loss(emb, labels, margin=0.05, epsilon=0.1):
    """Mean of ``max(d_ap - d_an + margin, 0)`` over the mined triples; 0
    where none is mined."""
    d = pairwise_dist(emb)
    pos_mask, neg_mask = multi_similarity_miner(emb, labels, epsilon)
    hinge = torch.maximum(d[:, :, None] - d[:, None, :] + margin,
                          d.new_tensor(0.0))
    w = (pos_mask[:, :, None] & neg_mask[:, None, :]).to(d.dtype)
    total = torch.sum(hinge * w)
    return total / torch.clamp_min(torch.sum(w), 1.0)


def get_criterion():
    """``(loss_fn, miner_fn)`` (``featurenet.py:30 get_criterion``)."""
    return triplet_margin_loss, multi_similarity_miner
