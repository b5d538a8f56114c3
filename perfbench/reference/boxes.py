"""Priors, box coding and greedy NMS, written out in plain PyTorch.

Conventions of the reference repository (lesions3d/utils.py): corner boxes
(x0, y0, z0, x1, y1, z1) and center boxes (cx, cy, cz, w, h, d), fractions
of the volume; offsets scaled by 10 (centres) and 5 (log sizes).
"""

from __future__ import annotations

import torch

CENTER_VARIANCE = 10.0
SIZE_VARIANCE = 5.0


def fmap_dims(cfg: dict, plan: list) -> dict:
    """{layer: (d, h, w)} of every tower layer (3^3 convs, padding 1)."""
    dims, out = list(cfg["input_size"]), {}
    for i, (_, _, _, stride) in enumerate(plan):
        dims = [(d - 1) // s + 1 for d, s in zip(dims, stride)]
        out[i] = tuple(dims)
    return out


def priors(cfg: dict, plan: list, device="cpu") -> torch.Tensor:
    """Center-form priors (P, 6), clamped to [0, 1]: for each feature layer
    in ascending order, each voxel (i, j, k) of its map, a box of the layer's
    scale per aspect ratio and, for a ratio of 1, boxes of scale s + s / n for
    n = 1 .. boxes_per_location - 1. Centres are ((j + .5) / dim1,
    (i + .5) / dim0, (k + .5) / dim2), as the reference repository has them."""
    layers = sorted(int(k) for k in cfg["aspect_ratios"])
    size0 = cfg["input_size"][0]
    lo, hi = cfg["min_object_size"] / size0, cfg["max_object_size"] / size0
    n = len(layers)
    scales = {layer: lo + (hi - lo) * i / (n - 1) if n > 1 else lo
              for i, layer in enumerate(layers)}
    if cfg.get("scales"):
        scales = {int(k): float(v) for k, v in cfg["scales"].items()}
    dims = fmap_dims(cfg, plan)
    rows = []
    for layer in layers:
        d0, d1, d2 = dims[layer]
        s = scales[layer]
        sizes = []
        for ratio in cfg["aspect_ratios"][str(layer)]:
            sizes.append(s)
            if float(ratio) == 1.0:
                sizes.extend(s + s / div for div in range(1, int(cfg["boxes_per_location"])))
        for i in range(d0):
            for j in range(d1):
                for k in range(d2):
                    c = ((j + 0.5) / d1, (i + 0.5) / d0, (k + 0.5) / d2)
                    rows.extend((*c, z, z, z) for z in sizes)
    return torch.tensor(rows, dtype=torch.float64).clamp(0.0, 1.0).float().to(device)


def decode(locs: torch.Tensor, priors_c: torch.Tensor) -> torch.Tensor:
    """Offsets (..., 6) -> center-form boxes."""
    centers = priors_c[..., :3] + locs[..., :3] * priors_c[..., 3:] / CENTER_VARIANCE
    sizes = priors_c[..., 3:] * torch.exp(locs[..., 3:] / SIZE_VARIANCE)
    return torch.cat([centers, sizes], -1)


def encode(boxes_c: torch.Tensor, priors_c: torch.Tensor) -> torch.Tensor:
    return torch.cat([(boxes_c[..., :3] - priors_c[..., :3]) / (priors_c[..., 3:] / CENTER_VARIANCE),
                      torch.log(boxes_c[..., 3:] / priors_c[..., 3:]) * SIZE_VARIANCE], -1)


def to_corner(boxes_c: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes_c[..., :3] - boxes_c[..., 3:] / 2, boxes_c[..., :3] + boxes_c[..., 3:] / 2],
                     -1)


def to_center(boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([(boxes[..., :3] + boxes[..., 3:]) / 2, boxes[..., 3:] - boxes[..., :3]], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every pair of corner boxes: (..., n, 6) x (..., m, 6) -> (..., n, m)."""
    lo = torch.maximum(a[..., :, None, :3], b[..., None, :, :3])
    hi = torch.minimum(a[..., :, None, 3:], b[..., None, :, 3:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    va = (a[..., 3:] - a[..., :3]).prod(-1)
    vb = (b[..., 3:] - b[..., :3]).prod(-1)
    return inter / (va[..., :, None] + vb[..., None, :] - inter)


def detect(locs: torch.Tensor, logits: torch.Tensor, priors_c: torch.Tensor, *, min_score: float,
           max_overlap: float, top_k: int) -> list:
    """One volume's detections as the reference repository's detect_objects
    finds them: per class (background excluded) the candidates above
    ``min_score`` among the 10 x top_k best, greedy NMS in score order (a
    kept box suppresses every later one with IoU > max_overlap), then the
    top_k of all kept boxes. Returns [(box corner (6,), label, score)]."""
    probs = torch.softmax(logits.float(), -1)
    boxes = to_corner(decode(locs.float(), priors_c))
    k = min(10 * top_k, priors_c.shape[0])
    kept = []
    for c in range(1, probs.shape[-1]):
        order = torch.argsort(-probs[:, c], stable=True)[:k]
        order = order[probs[order, c] > min_score]
        cand = boxes[order]
        over = iou(cand, cand) > max_overlap
        suppressed = torch.zeros(len(order), dtype=torch.bool)
        over_host = over.cpu()
        for i in range(len(order)):
            if not suppressed[i]:
                kept.append((cand[i], c, float(probs[order[i], c])))
                suppressed |= over_host[i]
    kept.sort(key=lambda d: -d[2])
    return kept[:top_k]
