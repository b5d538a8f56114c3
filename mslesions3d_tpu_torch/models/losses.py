"""MultiBox loss: localization L1 + confidence cross-entropy, batched.

Counterpart of ``mslesions3d_tpu/models/losses.py``:

* loc loss = plain L1 averaged over the positive priors' 6 coordinates;
* conf loss = cross entropy over every prior, the ignore band (-1) zeroed,
  summed and divided by the number of positives; hard-negative mining (the
  positives plus the ``neg_pos_ratio`` x n_pos hardest negatives of each
  image) and the softmax focal loss are options;
* ``batch_mask`` drops padded batch rows from both terms;
* under a data mesh (``mesh``) both terms divide by the global batch's
  positives, so each rank's terms are its share of the global loss: summed
  over the ranks they are the loss of the global batch, and so are the
  gradients.

Ground truth arrives padded (B, M, 6) / (B, M) with a validity mask.
"""

from __future__ import annotations

import torch

from ..ops.boxes import center_to_corner
from ..parallel.collectives import all_reduce_sum
from ..ops.matching import match_priors_batch


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE with integer labels (already clamped >= 0), in float32."""
    logits = logits.float()
    log_z = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return log_z - true_logit


def multibox_loss(predicted_locs, predicted_scores, gt_boxes, gt_labels, gt_mask,
                  priors_center, threshold_lo: float, threshold_hi: float = 0.0,
                  batch_mask=None, *, soft: bool = False, neg_pos_ratio: int = 3,
                  hard_negative_mining: bool = False, focal_gamma: float = 0.0,
                  focal_alpha: float = 0.25, mesh=None):
    """Returns (conf_loss, loc_loss), float32 scalars.

    focal_gamma > 0 switches the confidence term to the softmax focal loss
    FL = -alpha_t (1 - p_t)^gamma log(p_t), alpha_t = focal_alpha on positives
    and 1 - focal_alpha elsewhere.
    """
    if batch_mask is not None:
        gt_mask = gt_mask & batch_mask[:, None]
    priors_corner = center_to_corner(priors_center)
    with torch.no_grad():
        loc_targets, cls_targets = match_priors_batch(
            gt_boxes, gt_labels, gt_mask, priors_corner, priors_center,
            threshold_lo, threshold_hi, soft=soft,
        )

    positive = cls_targets > 0  # (B, P)
    (n_positives,) = all_reduce_sum([positive.sum()], mesh)

    diff = (predicted_locs.float() - loc_targets).abs()
    loc_loss = (diff * positive[..., None]).sum() / torch.clamp(n_positives * 6, min=1)

    ce = _cross_entropy(predicted_scores, cls_targets.clamp(min=0))  # (B, P)
    if focal_gamma > 0.0:
        p_t = torch.exp(-ce)
        alpha_t = torch.where(positive, focal_alpha, 1.0 - focal_alpha)
        ce = alpha_t * (1.0 - p_t) ** focal_gamma * ce
    ce = torch.where(cls_targets < 0, 0.0, ce)
    if batch_mask is not None:
        ce = torch.where(batch_mask[:, None], ce, 0.0)

    if hard_negative_mining:
        neg_ce = torch.where(positive, 0.0, ce).detach()
        # stable, as jnp.argsort: the zeroed positives tie
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
        n_hard = neg_pos_ratio * positive.sum(dim=1, keepdim=True)
        hard_neg = (ranks < n_hard) & ~positive
        conf_sum = torch.where(positive | hard_neg, ce, 0.0).sum()
    else:
        conf_sum = ce.sum()

    conf_loss = conf_sum / torch.clamp(n_positives, min=1).float()
    return conf_loss, loc_loss


def multibox_loss_from_config(config, predicted_locs, predicted_scores, gt_boxes, gt_labels,
                              gt_mask, priors_center, batch_mask=None,
                              hard_negative_mining: bool = False, mesh=None):
    """multibox_loss with the config's thresholds and focal options."""
    if config.soft_matching:
        (lo, hi), soft = config.threshold, True
    else:
        lo, hi, soft = config.threshold[0], 0.0, False
    return multibox_loss(
        predicted_locs, predicted_scores, gt_boxes, gt_labels, gt_mask, priors_center,
        lo, hi, batch_mask, soft=soft, hard_negative_mining=hard_negative_mining,
        focal_gamma=config.focal_gamma, focal_alpha=config.focal_alpha, mesh=mesh,
    )
