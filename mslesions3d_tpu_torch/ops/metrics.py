"""Lesion-level detection metrics: VOC 11-point mAP, precision/recall/F1.

The port's own numpy copy of ``mslesions3d_tpu/ops/metrics.py`` (host code:
the sequential greedy TP/FP assignment, score-ordered, one detection per
GT, is the definition of the metric). Feed it the lists of
``ops.nms.detections_to_lists``, as the trainer scores validation.

API mirrors `calculate_mAP(..., return_detail=True)`: inputs are per-image
lists of detection boxes/labels/scores and GT boxes/labels/difficulties, all
corner-form fractional.
"""

from __future__ import annotations

import numpy as np

from ..utils.labels import rev_label_map


def to_jsonable(value):
    """Recursively convert a metrics detail structure to JSON-serializable
    types (numpy arrays/scalars -> lists/floats; dict keys -> str)."""
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    return value


def _volume(box):
    return (box[3] - box[0]) * (box[4] - box[1]) * (box[5] - box[2])


def _pairwise_iou_np(set_1: np.ndarray, set_2: np.ndarray) -> np.ndarray:
    lower = np.maximum(set_1[:, None, :3], set_2[None, :, :3])
    upper = np.minimum(set_1[:, None, 3:], set_2[None, :, 3:])
    dims = np.clip(upper - lower, 0.0, None)
    inter = dims[..., 0] * dims[..., 1] * dims[..., 2]
    vol_1 = np.prod(set_1[:, 3:] - set_1[:, :3], axis=-1)
    vol_2 = np.prod(set_2[:, 3:] - set_2[:, :3], axis=-1)
    union = vol_1[:, None] + vol_2[None, :] - inter
    return inter / union


def compute_metrics_per_class(
    det_class_images: np.ndarray,
    det_class_boxes: np.ndarray,
    det_class_scores: np.ndarray,
    true_class_images: np.ndarray,
    true_class_boxes: np.ndarray,
    true_class_difficulties: np.ndarray,
    min_overlap: float,
):
    """Greedy score-ordered TP/FP assignment for one class.

    Mirrors reference utils.py:157-239: detections sorted by decreasing
    score; a detection is TP iff its max-IoU GT (same image, same class)
    exceeds min_overlap, is not difficult, and was not already detected.
    """
    n_objects = true_class_boxes.shape[0]
    detected = np.zeros(n_objects, dtype=np.uint8)

    order = np.argsort(-det_class_scores, kind="stable")
    det_class_scores = det_class_scores[order]
    det_class_images = det_class_images[order]
    det_class_boxes = det_class_boxes[order]

    n_det = det_class_boxes.shape[0]
    true_positives = np.zeros(n_det, dtype=np.float32)
    false_positives = np.zeros(n_det, dtype=np.float32)

    for d in range(n_det):
        img = det_class_images[d]
        in_image = true_class_images == img
        object_boxes = true_class_boxes[in_image]
        object_difficulties = true_class_difficulties[in_image]
        if object_boxes.shape[0] == 0:
            false_positives[d] = 1
            continue

        overlaps = _pairwise_iou_np(det_class_boxes[d : d + 1], object_boxes)[0]
        ind = int(np.argmax(overlaps))
        max_overlap = overlaps[ind]
        original_ind = np.flatnonzero(in_image)[ind]

        if max_overlap > min_overlap:
            if not object_difficulties[ind]:
                if detected[original_ind] == 0:
                    true_positives[d] = 1
                    detected[original_ind] = 1
                else:
                    false_positives[d] = 1
            # difficult matches are neither TP nor FP (ignored)
        else:
            false_positives[d] = 1

    easy = ~true_class_difficulties.astype(bool)
    easy_volumes = np.array(
        [_volume(b) for i, b in enumerate(true_class_boxes) if easy[i]], dtype=np.float32
    )
    found_volumes = easy_volumes[detected[easy] == 1] if easy_volumes.size else easy_volumes
    not_found_volumes = easy_volumes[detected[easy] == 0] if easy_volumes.size else easy_volumes
    # NOTE: the reference indexes volumes of easy objects with the detected
    # flags of *all* objects (utils.py:230-233); with no difficult objects
    # (the only case it exercises) the two agree.

    return (
        true_positives,
        false_positives,
        detected,
        det_class_scores,
        found_volumes,
        not_found_volumes,
    )


def calculate_mAP(
    det_boxes,
    det_labels,
    det_scores,
    true_boxes,
    true_labels,
    true_difficulties,
    n_classes: int = 2,
    min_overlap: float = 0.5,
    return_detail: bool = False,
):
    """VOC-style 11-point mAP plus precision/recall/F1 detail dict.

    All inputs are per-image lists of numpy arrays. ``n_classes`` includes
    background (reference derives it from the global label_map;
    utils.py:260).
    """
    lengths = {len(det_boxes), len(det_labels), len(det_scores), len(true_boxes),
               len(true_labels), len(true_difficulties)}
    if len(lengths) != 1:
        raise ValueError("calculate_mAP: the six per-image lists differ in length")

    def flatten(list_of_arrays, width=None):
        arrs = [np.asarray(a) for a in list_of_arrays]
        images = np.concatenate(
            [np.full(a.shape[0], i, dtype=np.int64) for i, a in enumerate(arrs)]
        ) if arrs else np.zeros(0, dtype=np.int64)
        if width is None:
            flat = np.concatenate(arrs) if arrs else np.zeros(0)
        else:
            flat = (
                np.concatenate([a.reshape(-1, width) for a in arrs])
                if arrs
                else np.zeros((0, width))
            )
        return images, flat

    true_images, true_boxes_f = flatten(true_boxes, width=6)
    _, true_labels_f = flatten(true_labels)
    _, true_difficulties_f = flatten(true_difficulties)
    det_images, det_boxes_f = flatten(det_boxes, width=6)
    _, det_labels_f = flatten(det_labels)
    _, det_scores_f = flatten(det_scores)

    average_precisions = np.zeros(n_classes - 1, dtype=np.float32)
    detail = {
        "TP": {},
        "FP": {},
        "detected": {},
        "found_volumes": {},
        "not_found_volumes": {},
        "sorted_scores": {},
        "recall": {},
        "precision": {},
        "f1_score": {},
    }
    n_easy_objects = {}  # per class: GT count excluding difficult objects

    for c in range(1, n_classes):
        true_sel = true_labels_f == c
        t_images = true_images[true_sel]
        t_boxes = true_boxes_f[true_sel]
        t_diff = true_difficulties_f[true_sel]
        n_easy_objects[c] = int((~t_diff.astype(bool)).sum())

        det_sel = det_labels_f == c
        d_images = det_images[det_sel]
        d_boxes = det_boxes_f[det_sel]
        d_scores = det_scores_f[det_sel]
        if d_boxes.shape[0] == 0:
            # a detection-less class still has well-defined metrics: AP=0,
            # recall/precision 0, every easy GT volume not found (the
            # reference skipped these entries entirely, so its n_true_boxes
            # could misreport for multi-class; documented deviation)
            easy = ~t_diff.astype(bool)
            detail["TP"][c] = np.zeros(0, np.float32)
            detail["FP"][c] = np.zeros(0, np.float32)
            detail["detected"][c] = np.zeros(t_boxes.shape[0], np.uint8)
            detail["found_volumes"][c] = np.zeros(0, np.float32)
            detail["not_found_volumes"][c] = np.array(
                [_volume(b) for i, b in enumerate(t_boxes) if easy[i]], np.float32
            )
            detail["sorted_scores"][c] = np.zeros(0, np.float32)
            detail["recall"][c] = 0.0
            detail["precision"][c] = 0.0
            detail["f1_score"][c] = 0.0
            continue

        tp, fp, detected, sorted_scores, found_vol, not_found_vol = compute_metrics_per_class(
            d_images, d_boxes, d_scores, t_images, t_boxes, t_diff, min_overlap
        )

        detail["TP"][c] = tp
        detail["FP"][c] = fp
        detail["detected"][c] = detected
        detail["found_volumes"][c] = found_vol
        detail["not_found_volumes"][c] = not_found_vol
        detail["sorted_scores"][c] = sorted_scores

        false_negatives = 1 - detected
        tp_sum = tp.sum()
        detail["recall"][c] = float(tp_sum / (tp_sum + false_negatives.sum())) if (tp_sum + false_negatives.sum()) else 0.0
        detail["precision"][c] = float(tp_sum / (tp_sum + fp.sum())) if (tp_sum + fp.sum()) else 0.0
        pr, rc = detail["precision"][c], detail["recall"][c]
        detail["f1_score"][c] = float(2 * pr * rc / (pr + rc)) if (pr + rc) else 0.0

        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        cum_precision = cum_tp / (cum_tp + cum_fp + 1e-10)
        cum_recall = cum_tp / n_easy_objects[c] if n_easy_objects[c] else np.zeros_like(cum_tp)

        recall_thresholds = np.arange(0.0, 1.1, 0.1)
        precisions = np.zeros(len(recall_thresholds), dtype=np.float32)
        for i, t in enumerate(recall_thresholds):
            above = cum_recall >= t
            precisions[i] = cum_precision[above].max() if above.any() else 0.0
        average_precisions[c - 1] = precisions.mean()

    mean_average_precision = float(average_precisions.mean())
    aps = {rev_label_map.get(c + 1, str(c + 1)): float(v) for c, v in enumerate(average_precisions)}

    if n_classes == 2:
        # Binary case collapses the per-class dicts to scalars
        # (utils.py:359-380); the per-class defaults above make this branch
        # well-defined even with zero detections.
        result_detail = {
            "APs": aps[list(aps.keys())[0]],
            "mAP": mean_average_precision,
            "precision": detail["precision"][1],
            "recall": detail["recall"][1],
            "f1_score": detail["f1_score"][1],
            "sorted_det_scores": detail["sorted_scores"],
            "TP": detail["TP"][1],
            "FP": detail["FP"][1],
            "n_true_boxes": int(detail["detected"][1].shape[0]),
            "found_boxes_volumes_per_class": detail["found_volumes"][1],
            "not_found_boxes_volumes_per_class": detail["not_found_volumes"][1],
        }
    else:
        result_detail = {
            "APs": aps,
            "mAP": mean_average_precision,
            "precision": detail["precision"],
            "recall": detail["recall"],
            "f1_score": detail["f1_score"],
            "sorted_det_scores": detail["sorted_scores"],
            "TP": detail["TP"],
            "FP": detail["FP"],
            "n_true_boxes": {c: int(v.shape[0]) for c, v in detail["detected"].items()},
            "found_boxes_volumes_per_class": detail["found_volumes"],
            "not_found_boxes_volumes_per_class": detail["not_found_volumes"],
        }

    if not return_detail:
        return aps, mean_average_precision
    return result_detail
