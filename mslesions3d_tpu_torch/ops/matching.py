"""MultiBox prior <-> ground-truth matching as one batched tensor program.

Counterpart of ``mslesions3d_tpu/ops/matching.py``. Ground truth arrives
padded:

    gt_boxes  (B, M, 6)  corner form, fractional, padded with zeros
    gt_labels (B, M)     int class ids, padded with 0
    gt_mask   (B, M)     True for real objects

For every image at once:
  1. per prior, the max-overlap object (the first on ties, as ``jnp.argmax``);
  2. per object, the max-overlap prior;
  3. each valid object is forced onto its best prior with overlap 1; where
     objects collide on a prior the highest object index wins. A masked max
     decides this, not a scatter, whose order with duplicate indices is
     undefined on CUDA;
  4. hard threshold: overlap < t -> background (0); soft thresholds
     [lo, hi): overlap < lo -> 0, lo <= overlap < hi -> ignore (-1).

An image with no valid object gets zero regression targets and background
labels everywhere.
"""

from __future__ import annotations

import torch

from .boxes import corner_to_center, encode_boxes, pairwise_iou

IGNORE_LABEL = -1


def match_priors_batch(gt_boxes, gt_labels, gt_mask, priors_corner, priors_center,
                       threshold_lo: float, threshold_hi: float = 0.0, soft: bool = False):
    """Match priors to ground truth; returns (loc_targets (B, P, 6), cls_targets (B, P))."""
    num_objects, num_priors = gt_boxes.shape[1], priors_corner.shape[0]
    device = gt_boxes.device
    overlap = pairwise_iou(gt_boxes, priors_corner)  # (B, M, P)
    overlap = torch.where(gt_mask[..., None], overlap, -1.0)

    overlap_for_prior = overlap.amax(dim=1)  # (B, P)
    object_for_prior = overlap.argmax(dim=1)  # first maximum, as jnp.argmax
    prior_for_object = overlap.argmax(dim=2)  # (B, M)

    forced = (prior_for_object[..., None] == torch.arange(num_priors, device=device)) \
        & gt_mask[..., None]  # (B, M, P)
    object_ids = torch.arange(num_objects, device=device)[:, None]
    forced_object = torch.where(forced, object_ids, -1).amax(dim=1)  # (B, P)
    is_forced = forced_object >= 0
    object_for_prior = torch.where(is_forced, forced_object, object_for_prior)
    overlap_for_prior = torch.where(is_forced, 1.0, overlap_for_prior)

    labels = torch.gather(gt_labels, 1, object_for_prior)
    labels = torch.where(overlap_for_prior < threshold_lo, 0, labels)
    if soft:
        in_band = (overlap_for_prior >= threshold_lo) & (overlap_for_prior < threshold_hi)
        labels = torch.where(in_band, IGNORE_LABEL, labels)

    # a padded (zero-size) box would put -inf through the log; it is only
    # gathered when no object is valid, and then everything is zeroed below
    matched = torch.gather(gt_boxes, 1, object_for_prior[..., None].expand(-1, -1, 6))
    matched_valid = torch.gather(gt_mask, 1, object_for_prior)
    safe = torch.where(matched_valid[..., None], matched, priors_corner)
    loc_targets = encode_boxes(corner_to_center(safe), priors_center)

    any_valid = gt_mask.any(dim=1)
    loc_targets = torch.where(any_valid[:, None, None], loc_targets, 0.0)
    cls_targets = torch.where(any_valid[:, None], labels, 0)
    return loc_targets, cls_targets


def match_priors_single(gt_boxes, gt_labels, gt_mask, priors_corner, priors_center,
                        threshold_lo: float, threshold_hi: float = 0.0, soft: bool = False):
    """One image: gt_boxes (M, 6), gt_labels (M,), gt_mask (M,) -> ((P, 6), (P,))."""
    loc, cls = match_priors_batch(gt_boxes[None], gt_labels[None], gt_mask[None],
                                  priors_corner, priors_center, threshold_lo,
                                  threshold_hi, soft)
    return loc[0], cls[0]
