"""Patch sampling on the device, for training on full-resolution volumes.

Counterpart of ``mslesions3d_tpu/data/patches.py``. Batches carry whole
volumes; each train step crops a fresh ``config.input_size`` patch per
sample on the volumes' device, lesion-biased: with probability
``pos_fraction`` (and at least one real box) the patch holds a uniformly
chosen ground-truth box's centre, with a uniform jitter; otherwise its
start is uniform over the volume. Boxes are re-mapped to the patch frame:
those whose centre falls outside it are masked out, the rest clipped.
Validation takes a deterministic crop centred on the mean of the real box
centres, so the monitored loss repeats from epoch to epoch.

As with ``data/augment.py``, the random draws are apart from the function
that uses them: :func:`draw_patch_params` draws every sample's box choice,
jitter, uniform start and positive switch from an explicit
``torch.Generator``, and :func:`patch_starts_from_draws` turns given draws
into starts. Nothing here syncs with the host.
"""

from __future__ import annotations

import torch

from .augment import device_constant


def draw_patch_params(generator: torch.Generator, batch: int) -> dict:
    """Every sample's draws, uniform in [0, 1) on the generator's device:
    ``choice`` (B,) picks the box, ``jitter`` (B, 3) places its centre in
    the patch, ``uniform`` (B, 3) is the start of a uniform patch and
    ``positive`` (B,) is compared with ``pos_fraction``."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return {"choice": u(batch), "jitter": u(batch, 3), "uniform": u(batch, 3),
            "positive": u(batch)}


def patch_starts_from_draws(draws: dict, vol_shape, patch, boxes, box_mask,
                            pos_fraction: float = 0.7) -> torch.Tensor:
    """Start voxels (B, 3) int64 from given draws.

    ``boxes`` (B, M, 6) fractional corner form over the full volume,
    ``box_mask`` (B, M). The box is drawn over the real boxes alone, as
    ``jax.random.choice`` with p: the first box whose cumulative share
    reaches total x (1 - choice). A positive start lies in [lo, hi) per
    axis with lo = clip(centre - patch + 1) and hi = clip(centre), so the
    patch holds the centre; both clips are to [0, volume - patch].
    """
    vol = device_constant(vol_shape, torch.float32, boxes)
    pat = device_constant(patch, torch.float32, boxes)
    max_start = vol - pat
    probs = box_mask.float()
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1.0)
    cdf = torch.cumsum(probs, dim=-1)
    r = cdf[:, -1:] * (1.0 - draws["choice"][:, None])
    idx = torch.searchsorted(cdf.contiguous(), r.contiguous()).clamp(max=boxes.shape[1] - 1)
    chosen = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 6))[:, 0]  # (B, 6)
    center = (chosen[:, :3] + chosen[:, 3:]) * 0.5 * vol
    lo = torch.minimum(torch.clamp(center - pat + 1.0, min=0.0), max_start)
    hi = torch.minimum(torch.clamp(center, min=0.0), max_start)
    pos_start = lo + draws["jitter"] * torch.clamp(hi - lo, min=0.0)
    uni_start = draws["uniform"] * max_start
    take_pos = (draws["positive"] < pos_fraction) & box_mask.any(-1)
    start = torch.where(take_pos[:, None], pos_start, uni_start)
    return torch.floor(start).long()


def sample_patch_starts(generator: torch.Generator, vol_shape, patch, boxes, box_mask,
                        pos_fraction: float = 0.7, global_batch: int | None = None,
                        rows=None) -> torch.Tensor:
    """Random lesion-biased starts (B, 3): :func:`draw_patch_params`, then
    :func:`patch_starts_from_draws`. With ``global_batch`` and ``rows`` (a
    data-parallel rank: slices of the global batch) the draws are the global
    batch's, and the boxes' samples are its ``rows``."""
    draws = draw_patch_params(generator, boxes.shape[0] if global_batch is None else global_batch)
    if rows is not None:
        draws = {k: torch.cat([v[s] for s in rows]) for k, v in draws.items()}
    return patch_starts_from_draws(draws, vol_shape, patch, boxes, box_mask, pos_fraction)


def deterministic_patch_starts(vol_shape, patch, boxes, box_mask) -> torch.Tensor:
    """Starts (B, 3) of a patch centred on the mean of the real box centres
    (the volume's centre when a sample has none): validation's crop."""
    vol = device_constant(vol_shape, torch.float32, boxes)
    pat = device_constant(patch, torch.float32, boxes)
    centers = (boxes[..., :3] + boxes[..., 3:]) * 0.5
    w = box_mask.float()
    n = torch.clamp(w.sum(1, keepdim=True), min=1.0)
    mean_c = (centers * w[..., None]).sum(1) / n
    mean_c = torch.where(box_mask.any(1, keepdim=True), mean_c, 0.5)
    start = torch.minimum(torch.clamp(mean_c * vol - pat * 0.5, min=0.0), vol - pat)
    return torch.floor(start).long()


def crop_patches(volumes: torch.Tensor, starts: torch.Tensor, patch,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """(V, D, H, W, C) volumes -> (B, *patch, C) crops at ``starts`` (B, 3),
    as one gather. Crop b comes from volume ``rows[b]`` (default b). Starts
    are clamped into the volume, as ``dynamic_slice`` clamps them."""
    dev = volumes.device
    if rows is None:
        rows = torch.arange(starts.shape[0], device=dev)
    limit = device_constant([s - p for s, p in zip(volumes.shape[1:4], patch)], torch.int64,
                            volumes)
    starts = torch.minimum(torch.clamp(starts.to(dev).long(), min=0), limit)
    axes = [starts[:, a, None] + torch.arange(p, device=dev) for a, p in enumerate(patch)]
    return volumes[rows.to(dev)[:, None, None, None], axes[0][:, :, None, None],
                   axes[1][:, None, :, None], axes[2][:, None, None, :]]


def boxes_to_patch(boxes, box_mask, starts, vol_shape, patch):
    """Full-volume fractional boxes -> patch-fractional boxes and mask.

    A box stays when its centre lies in the patch; it is translated and
    rescaled to the patch frame and clipped to [0, 1], and masked if that
    leaves it degenerate. Masked slots are zeroed.
    """
    dev = boxes.device
    vol = device_constant(vol_shape, torch.float32, boxes)
    pat = device_constant(patch, torch.float32, boxes)
    off = starts.to(dev).float()[:, None, :]
    lo = (boxes[..., :3] * vol - off) / pat
    hi = (boxes[..., 3:] * vol - off) / pat
    center = (lo + hi) * 0.5
    inside = ((center >= 0.0) & (center < 1.0)).all(-1)
    out = torch.clamp(torch.cat([lo, hi], dim=-1), 0.0, 1.0)
    degenerate = (out[..., 3:] <= out[..., :3]).any(-1)
    new_mask = box_mask & inside & ~degenerate
    return torch.where(new_mask[..., None], out, 0.0), new_mask
