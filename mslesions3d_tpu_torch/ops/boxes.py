"""3D box geometry on torch tensors.

Counterpart of ``mslesions3d_tpu/ops/boxes.py``, with the same conventions:

* Corner form:  (x_min, y_min, z_min, x_max, y_max, z_max), fractional [0, 1].
* Center form:  (c_x, c_y, c_z, w, h, d).
* Every function broadcasts over leading axes; the box axis is the trailing
  axis of size 6.

The operation order of :func:`pairwise_iou` is the contract that the CUDA NMS
kernel (``csrc/nms.cu``) reproduces bit for bit: per axis
``max(min(hi) - max(lo), 0)``, the product of the three axes, then
``(vol_1 + vol_2) - inter`` and ``inter / union``.
"""

from __future__ import annotations

import torch

CENTER_VARIANCE = 10.0
SIZE_VARIANCE = 5.0


def center_to_corner(boxes_cwhd: torch.Tensor) -> torch.Tensor:
    """Center-size -> corner coordinates."""
    centers = boxes_cwhd[..., :3]
    half = boxes_cwhd[..., 3:] / 2.0
    return torch.cat([centers - half, centers + half], dim=-1)


def corner_to_center(boxes_xyz: torch.Tensor) -> torch.Tensor:
    """Corner -> center-size coordinates."""
    lo = boxes_xyz[..., :3]
    hi = boxes_xyz[..., 3:]
    return torch.cat([(hi + lo) / 2.0, hi - lo], dim=-1)


def encode_boxes(boxes_cwhd: torch.Tensor, priors_cwhd: torch.Tensor) -> torch.Tensor:
    """Center-form boxes as regression offsets w.r.t. priors.

    g_center = (center - prior_center) / (prior_size / 10)
    g_size   = log(size / prior_size) * 5
    """
    g_center = (boxes_cwhd[..., :3] - priors_cwhd[..., :3]) / (
        priors_cwhd[..., 3:] / CENTER_VARIANCE
    )
    g_size = torch.log(boxes_cwhd[..., 3:] / priors_cwhd[..., 3:]) * SIZE_VARIANCE
    return torch.cat([g_center, g_size], dim=-1)


def decode_boxes(offsets: torch.Tensor, priors_cwhd: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`; returns center-form boxes."""
    centers = offsets[..., :3] * priors_cwhd[..., 3:] / CENTER_VARIANCE + priors_cwhd[..., :3]
    sizes = torch.exp(offsets[..., 3:] / SIZE_VARIANCE) * priors_cwhd[..., 3:]
    return torch.cat([centers, sizes], dim=-1)


def box_volume(boxes_xyz: torch.Tensor) -> torch.Tensor:
    """Volume of corner-form boxes; shape (..., 6) -> (...)."""
    dims = boxes_xyz[..., 3:] - boxes_xyz[..., :3]
    return dims[..., 0] * dims[..., 1] * dims[..., 2]


def pairwise_intersection(set_1: torch.Tensor, set_2: torch.Tensor) -> torch.Tensor:
    """Intersection volume of every box pair.

    set_1: (..., n1, 6) corner form; set_2: (..., n2, 6). Returns (..., n1, n2).
    """
    lower = torch.maximum(set_1[..., :, None, :3], set_2[..., None, :, :3])
    upper = torch.minimum(set_1[..., :, None, 3:], set_2[..., None, :, 3:])
    dims = torch.clamp(upper - lower, min=0.0)
    return dims[..., 0] * dims[..., 1] * dims[..., 2]


def pairwise_iou(set_1: torch.Tensor, set_2: torch.Tensor) -> torch.Tensor:
    """Jaccard overlap (IoU) of every box pair; shapes as in pairwise_intersection.

    A pair of empty boxes gives 0/0 = NaN, which compares false against any
    threshold, so such a pair never suppresses in NMS.
    """
    inter = pairwise_intersection(set_1, set_2)
    vol_1 = box_volume(set_1)
    vol_2 = box_volume(set_2)
    union = vol_1[..., :, None] + vol_2[..., None, :] - inter
    return inter / union
