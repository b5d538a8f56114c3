"""Inputs from the seed, made on the device: the reference repository's
artificial dataset (lesions3d/generate_artificial_dataset.py) in torch.

Each volume is uniform noise in [0, 1) with ``n + 1`` filled cubes, n drawn
from [objects[0], objects[1]), each cube of a side drawn from
[object_size[0], object_size[1]) at a corner drawn from [0, side - size),
brightened by 0.4 and clipped to 1. Each cube's box is [first, last voxel]
/ side per axis (corner form, fractions); cubes that touch keep a box each.
Volumes are normalised to zero mean and unit deviation over their nonzero
voxels, as the training pipeline normalises them.
"""

from __future__ import annotations

import torch


def make_volumes(n: int, size, objects, object_size, seed: int, device) -> dict:
    """{"image" (n, D, H, W, 1) float32, "boxes" (n, M, 6), "labels" (n, M)
    int64 (1 for a lesion), "box_mask" (n, M) bool}, M = objects[1]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    size = tuple(int(s) for s in size)
    m = int(objects[1])
    image = torch.rand((n, *size), generator=gen, device=device)
    counts = torch.randint(int(objects[0]), int(objects[1]), (n,), generator=gen,
                           device=device) + 1
    sides = torch.randint(int(object_size[0]), int(object_size[1]), (n, m), generator=gen,
                          device=device)
    u = torch.rand((n, m, 3), generator=gen, device=device)
    span = torch.tensor(size, device=device) - sides[..., None]
    corners = torch.floor(u * span).long()
    mask = torch.arange(m, device=device)[None, :] < counts[:, None]
    corners_h, sides_h, mask_h = corners.tolist(), sides.tolist(), mask.tolist()
    for i in range(n):
        for j in range(m):
            if mask_h[i][j]:
                (a, b, c), s = corners_h[i][j], sides_h[i][j]
                block = image[i, a:a + s, b:b + s, c:c + s]
                block.copy_((block + 0.4).clamp(max=1.0))
    extent = torch.tensor(size, dtype=torch.float32, device=device)
    lo = corners.float() / extent
    hi = (corners + sides[..., None] - 1).float() / extent
    boxes = torch.where(mask[..., None], torch.cat([lo, hi], -1), 0.0)
    flat = image.view(n, -1)
    nz = flat != 0
    count = nz.sum(1, keepdim=True).clamp(min=1)
    mean = torch.where(nz, flat, 0.0).sum(1, keepdim=True) / count
    var = torch.where(nz, (flat - mean) ** 2, 0.0).sum(1, keepdim=True) / count
    flat = torch.where(nz, (flat - mean) / var.sqrt().clamp(min=1e-8), flat)
    return {"image": flat.view(n, *size, 1), "boxes": boxes,
            "labels": mask.long(), "box_mask": mask}
