"""Box decode + greedy 3D NMS + top-k with static shapes.

Counterpart of ``mslesions3d_tpu/ops/nms.py``:

  softmax -> decode -> per (image, class): top-K candidates (K = min(10*top_k,
  n_priors)) -> exact greedy NMS -> global top-k across classes per image.

Outputs are padded to ``top_k`` with a count; :func:`detections_to_lists`
gives the reference's ragged lists with the background placeholder.

Greedy order: candidates are visited in decreasing score order and a kept box
suppresses every later box with IoU > max_overlap, as in the reference's
sequential loop. On CUDA tensors the NMS step is the CUDA kernel
(:func:`..kernels.nms.greedy_nms_cuda`); on CPU tensors it is the plain
fixpoint :func:`greedy_nms`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.nms import greedy_nms, greedy_nms_cuda
from .boxes import center_to_corner, decode_boxes, pairwise_iou

__all__ = [
    "NEG_INF", "greedy_nms", "greedy_nms_sequential", "nms_candidates",
    "select_detections", "detect_objects", "detections_to_lists",
]

NEG_INF = -1e30


def greedy_nms_sequential(boxes_corner: torch.Tensor, valid: torch.Tensor,
                          max_overlap: float) -> torch.Tensor:
    """Greedy NMS as the literal K-step loop in score order: the oracle.

    boxes_corner: (K, 6) sorted by decreasing score; valid: (K,) bool.
    """
    k = boxes_corner.shape[0]
    iou = pairwise_iou(boxes_corner, boxes_corner)  # (K, K)
    suppress = torch.zeros((k,), dtype=torch.bool, device=boxes_corner.device)
    for i in range(k):
        if valid[i] and not suppress[i]:
            row = iou[i] > max_overlap
            row[i] = False
            suppress |= row
    return valid & ~suppress


def top_k_stable(scores: torch.Tensor, k: int):
    """The ``k`` largest entries of each row of ``scores`` (N, M) and their
    indices, in decreasing order; equal scores go to the lower index, as
    ``lax.top_k`` has it, on any device (``torch.topk`` orders ties its own
    way on each)."""
    values, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def nms_candidates(predicted_locs, predicted_scores, priors_center, *, n_classes: int,
                   min_score: float, top_k: int):
    """Decode and pick the top-K candidates of every (image, class) row.

    predicted_locs (B, P, 6), predicted_scores (B, P, n_classes) raw logits,
    priors_center (P, 6). Returns (boxes (N, K, 6) corner form, scores (N, K),
    valid (N, K)) with N = B * (n_classes - 1), rows in (image, class) order
    and candidates in decreasing score order.
    """
    b, num_priors, _ = predicted_scores.shape
    cm = n_classes - 1
    k = min(10 * top_k, num_priors)
    probs = torch.softmax(predicted_scores.float(), dim=-1)  # (B, P, C)
    decoded = center_to_corner(decode_boxes(predicted_locs.float(), priors_center.float()))

    cls_scores = probs[:, :, 1:].transpose(1, 2).reshape(b * cm, num_priors)
    cand_scores, cand_idx = top_k_stable(cls_scores, k)  # (N, K)
    image = torch.arange(b, device=decoded.device).repeat_interleave(cm)[:, None]
    cand_boxes = decoded[image, cand_idx]  # (N, K, 6)
    return cand_boxes, cand_scores, cand_scores > min_score


def select_detections(cand_boxes, cand_scores, keep, *, n_classes: int, top_k: int) -> dict:
    """Global top-k of the kept candidates per image, padded with zeros.

    Returns boxes (B, top_k, 6) corner form, labels (B, top_k) int32, scores
    (B, top_k) float32 and count (B,) int32.
    """
    cm = n_classes - 1
    n, k = cand_scores.shape
    b = n // cm
    kept_scores = torch.where(keep, cand_scores, NEG_INF)
    labels = torch.arange(1, n_classes, dtype=torch.int32, device=cand_scores.device)
    flat_scores = kept_scores.reshape(b, cm * k)
    flat_boxes = cand_boxes.reshape(b, cm * k, 6)
    flat_labels = labels[None, :, None].expand(b, cm, k).reshape(b, cm * k)

    best_scores, best_idx = top_k_stable(flat_scores, min(top_k, cm * k))
    sel_valid = best_scores > NEG_INF / 2
    picked_boxes = torch.gather(flat_boxes, 1, best_idx[..., None].expand(-1, -1, 6))
    picked_labels = torch.gather(flat_labels, 1, best_idx)
    return {
        "boxes": torch.where(sel_valid[..., None], picked_boxes, 0.0),
        "labels": torch.where(sel_valid, picked_labels, 0),
        "scores": torch.where(sel_valid, best_scores, 0.0),
        "count": sel_valid.sum(-1, dtype=torch.int32),
    }


def detect_objects(predicted_locs, predicted_scores, priors_center, *, n_classes: int,
                   min_score: float, max_overlap: float, top_k: int) -> dict:
    """Batched decode + per-class NMS + global top-k, on the inputs' device.

    All (image, class) candidate sets form one (B*(C-1), K) batch, so the NMS
    kernel sees a single launch. Returns dict with boxes (B, top_k, 6),
    labels (B, top_k), scores (B, top_k) and count (B,).
    """
    boxes, scores, valid = nms_candidates(
        predicted_locs, predicted_scores, priors_center,
        n_classes=n_classes, min_score=min_score, top_k=top_k,
    )
    keep = greedy_nms_cuda(boxes.contiguous(), valid, max_overlap)
    return select_detections(boxes, scores, keep, n_classes=n_classes, top_k=top_k)


def detections_to_lists(detections):
    """Padded detections -> the reference's ragged per-image numpy lists.

    Images with zero detections get the background placeholder
    ([0,0,0,1,1,1], label 0, score 0), as in the reference.
    Returns (boxes_list, labels_list, scores_list).
    """
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    boxes, labels, scores, count = (
        host(detections[key]) for key in ("boxes", "labels", "scores", "count")
    )
    boxes_list, labels_list, scores_list = [], [], []
    for i in range(boxes.shape[0]):
        n = int(count[i])
        if n == 0:
            boxes_list.append(np.array([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], dtype=np.float32))
            labels_list.append(np.array([0], dtype=np.int64))
            scores_list.append(np.array([0.0], dtype=np.float32))
        else:
            boxes_list.append(boxes[i, :n].astype(np.float32))
            labels_list.append(labels[i, :n].astype(np.int64))
            scores_list.append(scores[i, :n].astype(np.float32))
    return boxes_list, labels_list, scores_list
