"""Segmentation <-> bounding-box conversion.

The port's own copy of ``mslesions3d_tpu/data/boxes_from_seg.py`` (host
numpy and scipy; the same boxes in every mode).

boxes_from_segmentation: host-side connected-component labeling (scipy) with
the reference's three modes (lesions3d/utils.py:398-513):

  * "instances": label values grouped into classes by (min, max) threshold
    ranges;
  * "binary":    connected components of the nonzero mask, all class 1;
  * "classes":   per-class connected components with the +c*1000 instance-id
    offset trick.

Boxes are fractional corner-form with the reference's inclusive-max-index
normalization (box = [min_idx, max_idx] / image_size, utils.py:500), and
zero-volume boxes are dropped (utils.py:476-481). scipy.ndimage.find_objects
replaces the reference's per-label np.where scan — same result, linear time.

segmentation_from_boxes: vectorized wireframe painter replacing the
reference's per-face slicing loops (utils.py:516-617) — renders box edges
(faces of the axis-aligned box) into instance-id and class-label volumes.
"""

from __future__ import annotations

import numpy as np


class _LazyNdimage:
    """Defers the ~0.4 s scipy.ndimage import until a host transform runs.

    Package import sits on the startup path of every CLI and test process;
    paths that never derive boxes on the host never touch ndimage.
    """

    def __getattr__(self, name):
        from scipy import ndimage

        return getattr(ndimage, name)


ndimage = _LazyNdimage()


def _boxes_from_labelled(seg: np.ndarray, thresholds) -> tuple[list, list]:
    """Boxes for each instance id grouped into classes by threshold ranges.

    Mirrors _from_instances (utils.py:485-513): classes are assigned by the
    position of the matching (min, max) range; max index is inclusive.
    """
    labels = np.unique(seg)
    labels = labels[labels != 0]
    max_label = int(labels.max()) if labels.size else 0
    slices = ndimage.find_objects(seg.astype(np.int64), max_label=max_label)

    gt_boxes, gt_labels = [], []
    for c, (min_value, max_value) in enumerate(thresholds):
        for lab in labels[(labels >= min_value) & (labels < max_value)]:
            sl = slices[int(lab) - 1]
            if sl is None:
                continue
            # NOTE: find_objects gives half-open slices; the reference records
            # inclusive max indices (max(x) not max(x)+1, utils.py:500).
            gt_boxes.append(
                [sl[0].start, sl[1].start, sl[2].start,
                 sl[0].stop - 1, sl[1].stop - 1, sl[2].stop - 1]
            )
            gt_labels.append(c + 1)
    return gt_boxes, gt_labels


def boxes_from_segmentation(
    seg: np.ndarray,
    segmentation_mode: str = "instances",
    thresholds=None,
    classes=None,
    n_classes: int | None = None,
):
    """Derive (boxes (N,6) fractional corner-form, labels (N,)) from a seg volume."""
    seg = np.squeeze(np.asarray(seg))
    assert seg.ndim == 3, f"expected 3D segmentation, got shape {seg.shape}"
    image_size = seg.shape

    if n_classes is not None and not classes:
        classes = list(range(1, n_classes + 1))

    if segmentation_mode == "instances":
        assert thresholds, "instances mode requires thresholds"
        gt_boxes, gt_labels = _boxes_from_labelled(seg, thresholds)
    elif segmentation_mode == "binary":
        connected, _ = ndimage.label(seg)
        gt_boxes, gt_labels = _boxes_from_labelled(connected, [(1, np.inf)])
    elif segmentation_mode == "classes":
        assert classes, "classes mode requires classes or n_classes"
        seg_instanced = np.zeros_like(seg, dtype=np.int64)
        thresholds = []
        for c in classes:
            class_mask = seg == c
            class_cc, _ = ndimage.label(class_mask)
            seg_instanced = np.where(class_mask, class_cc + c * 1000, seg_instanced)
            thresholds.append((c * 1000, (c + 1) * 1000))
        gt_boxes, gt_labels = _boxes_from_labelled(seg_instanced, thresholds)
    else:
        raise ValueError(f"Unknown segmentation_mode={segmentation_mode}")

    if not gt_boxes:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)

    boxes = np.asarray(gt_boxes, np.float32) / np.asarray(image_size * 2, np.float32)
    labels = np.asarray(gt_labels, np.int64)

    # Drop zero-volume boxes (utils.py:476-481).
    dims = boxes[:, 3:] - boxes[:, :3]
    keep = (dims[:, 0] * dims[:, 1] * dims[:, 2]) != 0.0
    return boxes[keep], labels[keep]


def _paint_wireframe(volume: np.ndarray, lo, hi, value):
    """Paint the 6 faces' edge planes of box [lo, hi] (voxel coords) with value.

    Face-painting layout matches the reference (utils.py:581-598): the two
    bounding planes along each axis over the open interval of the other two.
    """
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    volume[x0, y0:y1, z0:z1] = value
    volume[x1, y0:y1, z0:z1] = value
    volume[x0:x1, y0, z0:z1] = value
    volume[x0:x1, y1, z0:z1] = value
    volume[x0:x1, y0:y1, z0] = value
    volume[x0:x1, y0:y1, z1] = value


def segmentation_from_boxes(
    boxes: np.ndarray,  # (N, 6) fractional corner form
    labels: np.ndarray,  # (N,)
    shape: tuple,
):
    """Render boxes as voxel wireframes.

    Returns (instances, classes) volumes of ``shape``: instances hold box
    index + 1, classes hold the class label (parity:
    make_segmentation_from_bboxes, utils.py:516-617; background label 0 is
    skipped).
    """
    instances = np.zeros(shape, np.float32)
    class_map = np.zeros(shape, np.float32)
    boxes = np.asarray(boxes, np.float32)
    labels = np.asarray(labels)
    size = np.asarray(shape * 2, np.float32)

    for j in range(boxes.shape[0]):
        label = int(labels[j])
        if label == 0:
            continue
        b = np.clip(boxes[j], 0.0, 1.0) * size
        b = b.astype(int)
        lo = np.maximum(b[:3], 0)
        hi = np.minimum(b[3:], np.asarray(shape) - 1)
        if np.any(hi < lo):
            continue
        _paint_wireframe(class_map, lo, hi, label)
        _paint_wireframe(instances, lo, hi, j + 1)
    return instances, class_map
