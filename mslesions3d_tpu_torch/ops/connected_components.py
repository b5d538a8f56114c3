"""3D connected-component labelling and component boxes on the device.

Counterpart of ``mslesions3d_tpu/ops/connected_components.py``, the device
replacement of the host's ``scipy.ndimage.label`` in the seg -> boxes
transform (lesions3d/utils.py:446). Min-label propagation with pointer
jumping:

  1. every foreground voxel starts labelled with its own linear index;
  2. each sweep takes the minimum label over the 6-neighbourhood (masked to
     the foreground), then jumps each label to the label its root holds,
     which compresses paths;
  3. sweeps repeat until nothing changes.

A component's label is then its smallest linear index (its root), so the
labels are deterministic and equal the JAX package's exactly. Boxes come
from per-component min / max reductions, padded to ``max_objects``: the
padded ground-truth layout the train step takes. 6-connectivity matches
scipy's default structuring element. The loop reads one flag from the
device per sweep to know when to stop.
"""

from __future__ import annotations

import numpy as np
import torch

INF = int(np.iinfo(np.int32).max)


def _neighbor_min(labels: torch.Tensor) -> torch.Tensor:
    """Min over the 6-neighbourhood (face-adjacent), INF beyond the edges."""
    out = labels
    for axis in range(3):
        n = labels.shape[axis]
        edge = torch.full_like(labels.narrow(axis, 0, 1), INF)
        fwd = torch.cat([labels.narrow(axis, 1, n - 1), edge], dim=axis)
        bwd = torch.cat([edge, labels.narrow(axis, 0, n - 1)], dim=axis)
        out = torch.minimum(out, torch.minimum(fwd, bwd))
    return out


def connected_components_3d(mask: torch.Tensor) -> torch.Tensor:
    """Label a boolean (D, H, W) mask on its device: int32 labels, each the
    root linear index of its component, INF outside the foreground."""
    shape = mask.shape
    n = shape[0] * shape[1] * shape[2]
    linear = torch.arange(n, dtype=torch.int64, device=mask.device).reshape(shape)
    labels = torch.where(mask, linear, INF)
    while True:
        prop = torch.where(mask, _neighbor_min(labels), INF)
        # pointer jump: adopt the label of the current root
        flat = prop.reshape(-1)
        jumped = torch.where(prop == INF, INF, flat[prop.clamp(0, n - 1)])
        new = torch.minimum(prop, jumped)
        if not bool((new != labels).any()):
            return new.to(torch.int32)
        labels = new


def component_boxes(labels: torch.Tensor, max_objects: int = 16):
    """Boxes of the first ``max_objects`` components by root order.

    Returns (boxes (max_objects, 6) float32 fractional corner form with the
    reference's inclusive-max normalisation, valid (max_objects,) bool);
    zero-volume boxes (one voxel thick on some axis) are not valid
    (lesions3d/utils.py:476-481).
    """
    shape = labels.shape
    n = shape[0] * shape[1] * shape[2]
    dev = labels.device
    flat = labels.reshape(-1).long()
    linear = torch.arange(n, dtype=torch.int64, device=dev)
    is_root = (flat == linear) & (flat != INF)
    # the smallest max_objects root ids, ascending, INF-padded
    neg = torch.topk(torch.where(is_root, -linear, -INF), min(max_objects, n)).values
    root_ids = torch.full((max_objects,), INF, dtype=torch.int64, device=dev)
    root_ids[: neg.shape[0]] = -neg
    valid = root_ids < INF

    coords = torch.stack(torch.meshgrid(*(torch.arange(s, device=dev) for s in shape),
                                        indexing="ij"), dim=-1).reshape(-1, 3)
    slot = torch.searchsorted(root_ids, flat).clamp(max=max_objects - 1)
    member = (root_ids[slot] == flat) & (flat != INF)
    slot = torch.where(member, slot, max_objects)  # non-members to a spare row
    big = torch.tensor(shape, device=dev)
    lo = big.repeat(max_objects + 1, 1).scatter_reduce(
        0, slot[:, None].expand(-1, 3), coords, "amin")
    hi = torch.full((max_objects + 1, 3), -1, dtype=coords.dtype, device=dev).scatter_reduce(
        0, slot[:, None].expand(-1, 3), coords, "amax")
    corners = torch.cat([lo, hi], dim=1)[:max_objects]
    # x the float32 reciprocal, which is what XLA makes of the JAX
    # package's division by this constant: the boxes equal its bit for bit
    inv_size = 1.0 / torch.tensor(tuple(shape) * 2, dtype=torch.float32, device=dev)
    boxes = torch.where(valid[:, None], corners.float() * inv_size, 0.0)
    # zero volume from the voxel extents: the JAX package tests the product
    # of its float32 extents, which XLA's fused multiply-adds can leave a
    # hair above 0 for a one-voxel-thick component
    nonzero = (corners[:, 3:] > corners[:, :3]).all(dim=1)
    return boxes, valid & nonzero


def boxes_from_segmentation_device(seg: torch.Tensor, n_classes: int = 1,
                                   max_objects: int = 16):
    """"classes"-mode seg -> boxes on the segmentation's device
    (lesions3d/utils.py:450-468): for each class c in 1..n_classes, the
    connected components of (seg == c) each give one box labelled c.
    Returns (boxes (n_classes x max_objects, 6), labels int32, valid); see
    :func:`compact_device_boxes`."""
    all_boxes, all_labels, all_valid = [], [], []
    for c in range(1, n_classes + 1):
        boxes, valid = component_boxes(connected_components_3d(seg == c), max_objects)
        all_boxes.append(boxes)
        all_labels.append(torch.full((max_objects,), c, dtype=torch.int32, device=seg.device))
        all_valid.append(valid)
    return torch.cat(all_boxes), torch.cat(all_labels), torch.cat(all_valid)


def compact_device_boxes(boxes, labels, valid):
    """The valid entries as host numpy arrays (boxes, labels)."""
    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    v = host(valid)
    return host(boxes)[v], host(labels)[v]
