"""Device-side random augmentation: box-aware flips, rot90, warps, intensity.

Counterpart of ``mslesions3d_tpu/data/augment.py``. Images (B, D, H, W, C)
and their corner-form fractional boxes (B, M, 6) are transformed together on
the images' device:

  * rot90 in a plane of equal dims (first, a conditional transpose);
  * one composed separable resample for flips, affine scale + translation,
    isotropic zoom about the centre and per-axis grid distortion: each axis
    is a dense linear-interpolation matrix applied as a batched float32
    matmul. Flips give exact permutation matrices, so a flips-only
    configuration flips exactly;
  * intensity shift and scale.

The random parameters are drawn apart from the transform:
:func:`draw_augment_params` draws every sample's Bernoulli switches and
values from an explicit ``torch.Generator``, and :func:`apply_augment`
applies given parameters. As in the JAX package every branch is computed
and blended by its switch, so the same parameters give the same result
whatever was drawn.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip_axes: tuple = ()  # e.g. (0, 1, 2)
    flip_prob: float = 0.5
    rot90_planes: tuple = ()  # e.g. ((1, 2), (0, 1), (0, 2))
    rot90_prob: float = 0.5
    affine_prob: float = 0.0  # reference "translate"/"scale" -> affine
    translate_range: float = 3.0  # voxels
    scale_range: float = 0.15
    zoom_prob: float = 0.0  # isotropic zoom, keep_size
    min_zoom: float = 0.9
    max_zoom: float = 1.1
    grid_distort_prob: float = 0.0
    grid_distort_cells: int = 5
    grid_distort_limit: float = 0.03
    shift_intensity: float = 0.0  # offsets
    shift_prob: float = 1.0
    scale_intensity: float = 0.0  # factors
    scale_prob: float = 1.0

    KNOWN_NAMES = frozenset({
        "flip", "rotate90", "rotate90d", "translate", "scale", "affine",
        "zoom", "griddistortion", "shiftintensity", "scaleintensity",
    })

    @staticmethod
    def from_names(names) -> "AugmentConfig":
        """Build from reference-style augmentation names; unknown names raise."""
        names = set(names or ())
        unknown = names - AugmentConfig.KNOWN_NAMES
        if unknown:
            raise ValueError(
                f"unknown augmentation name(s) {sorted(unknown)}; "
                f"known: {sorted(AugmentConfig.KNOWN_NAMES)}"
            )
        kwargs = {}
        if "flip" in names:
            kwargs["flip_axes"] = (0, 1, 2)
        if "rotate90" in names or "rotate90d" in names:
            kwargs["rot90_planes"] = ((1, 2), (0, 1), (0, 2))
        if "translate" in names or "scale" in names or "affine" in names:
            kwargs["affine_prob"] = 0.7
        if "zoom" in names:
            kwargs["zoom_prob"] = 0.1
        if "griddistortion" in names:
            kwargs["grid_distort_prob"] = 0.1
        if "shiftintensity" in names:
            kwargs["shift_intensity"] = 0.1
        if "scaleintensity" in names:
            kwargs["scale_intensity"] = 0.1
        return AugmentConfig(**kwargs)

    @property
    def identity(self) -> bool:
        return (
            not self.flip_axes
            and not self.rot90_planes
            and self.affine_prob == 0.0
            and self.zoom_prob == 0.0
            and self.grid_distort_prob == 0.0
            and self.shift_intensity == 0.0
            and self.scale_intensity == 0.0
        )

    @property
    def warps(self) -> bool:
        return self.affine_prob > 0.0 or self.zoom_prob > 0.0 or self.grid_distort_prob > 0.0


def _flip_boxes(boxes, axis: int, inv_size: float):
    """Boxes under a flip of spatial ``axis``. Boxes use the inclusive
    max-index convention, so index i -> S-1-i maps a corner to 1 - old - 1/S,
    evaluated as (1 - 1/S) - old: XLA folds the JAX package's constants so."""
    out = boxes.clone()
    out[..., axis] = (1.0 - inv_size) - boxes[..., axis + 3]
    out[..., axis + 3] = (1.0 - inv_size) - boxes[..., axis]
    return out


def _rot90_boxes(boxes, a: int, b: int, inv_size: float):
    """Boxes under rot90(img, 1, (a, b)): new_a = (1 - 1/S) - old_b, new_b = old_a."""
    out = boxes.clone()
    out[..., a] = (1.0 - inv_size) - boxes[..., b + 3]
    out[..., a + 3] = (1.0 - inv_size) - boxes[..., b]
    out[..., b] = boxes[..., a]
    out[..., b + 3] = boxes[..., a + 3]
    return out


def _axis_interp_matrix(coords, in_size: int):
    """Dense 1-D linear-interpolation matrices (..., out, in): W @ x samples x
    at the fractional positions ``coords`` (..., out), edge-clamped."""
    taps = torch.arange(in_size, dtype=torch.float32, device=coords.device)
    w = torch.clamp(1.0 - (coords[..., :, None] - taps).abs(), min=0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-8)


def separable_resample(images, axis_coords):
    """Resample (B, D, H, W, C) at separable per-axis coords (three (B, S)
    tensors), one float32 batched matmul per axis; returns float32."""
    out = images.float()
    for ax, coords in enumerate(axis_coords):
        w = _axis_interp_matrix(coords.float(), out.shape[ax + 1])  # (B, S_out, S_in)
        moved = out.movedim(ax + 1, 1)
        rest = moved.shape[2:]
        res = torch.bmm(w, moved.reshape(moved.shape[0], moved.shape[1], -1))
        out = res.reshape(res.shape[0], res.shape[1], *rest).movedim(1, ax + 1)
    return out


def _interp(x, xp, fp):
    """``jnp.interp`` batched over the leading axis: x (B, N), xp and fp (B, K),
    xp increasing; values outside xp clamp to fp's ends."""
    k = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(), right=True), 1, k - 1)
    x0, x1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = x1 - x0
    flat = dx.abs() <= torch.finfo(torch.float32).eps * torch.finfo(torch.float32).eps
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def device_constant(values: tuple, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor on ``like``'s device, copied there once: a copy
    from host memory each step would wait for the card's queue, and a CUDA
    graph cannot capture one. Callers read it and never write it. Where
    ``like`` is a tensor subclass (the fake tensors of ``torch.export``'s
    trace) it is made afresh, so that the trace records it and no tensor of
    a trace is kept."""
    if type(like) is not torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=like.device)
    return _cached_constant(tuple(values), dtype, like.device)


@functools.cache
def _cached_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _bernoulli(generator, b, p, device):
    return torch.rand((b,), generator=generator, device=device) < p


def _uniform(generator, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def draw_augment_params(config: AugmentConfig, batch: int, spatial_shape,
                        generator: torch.Generator) -> dict:
    """Every sample's random switches and values, on the generator's device.

    Keys (present when the branch is on): ``rot90`` (B, n_planes) for the
    planes of equal dims; ``distort`` (B,) and ``deltas`` (B, 3, cells);
    ``zoom`` (B,) and ``z`` (B,); ``affine`` (B,), ``t`` and ``s`` (B, 3);
    ``flip`` (B, n_axes); ``shift`` (B,) and ``offset`` (B,); ``scale`` (B,)
    and ``factor`` (B,).
    """
    dev = generator.device
    params = {}
    planes = [(a, b) for a, b in config.rot90_planes if spatial_shape[a] == spatial_shape[b]]
    if planes:
        params["rot90"] = torch.stack(
            [_bernoulli(generator, batch, config.rot90_prob, dev) for _ in planes], dim=1)
    if config.grid_distort_prob > 0.0:
        params["distort"] = _bernoulli(generator, batch, config.grid_distort_prob, dev)
        lim = config.grid_distort_limit
        params["deltas"] = _uniform(generator, (batch, 3, config.grid_distort_cells),
                                    -lim, lim, dev)
    if config.zoom_prob > 0.0:
        params["zoom"] = _bernoulli(generator, batch, config.zoom_prob, dev)
        params["z"] = _uniform(generator, (batch,), config.min_zoom, config.max_zoom, dev)
    if config.affine_prob > 0.0:
        params["affine"] = _bernoulli(generator, batch, config.affine_prob, dev)
        tr, sr = config.translate_range, config.scale_range
        params["t"] = _uniform(generator, (batch, 3), -tr, tr, dev)
        params["s"] = 1.0 + _uniform(generator, (batch, 3), -sr, sr, dev)
    if config.flip_axes:
        params["flip"] = torch.stack(
            [_bernoulli(generator, batch, config.flip_prob, dev) for _ in config.flip_axes],
            dim=1)
    if config.shift_intensity > 0.0:
        params["shift"] = _bernoulli(generator, batch, config.shift_prob, dev)
        params["offset"] = _uniform(generator, (batch,), -config.shift_intensity,
                                    config.shift_intensity, dev)
    if config.scale_intensity > 0.0:
        params["scale"] = _bernoulli(generator, batch, config.scale_prob, dev)
        params["factor"] = _uniform(generator, (batch,), -config.scale_intensity,
                                    config.scale_intensity, dev)
    return params


def apply_augment(images, boxes, params: dict, config: AugmentConfig):
    """Apply drawn parameters to images (B, D, H, W, C) and boxes (B, M, 6).

    Image-op order: rot90, then flip -> affine -> zoom -> distort as one
    resample (the output -> input coordinate map evaluated innermost last),
    then intensity; boxes take the forward maps in image-op order.
    """
    dev = images.device
    params = {k: v.to(dev) for k, v in params.items()}
    spatial = images.shape[1:4]
    shape = device_constant(spatial, torch.float32, images)

    planes = [(a, b) for a, b in config.rot90_planes if spatial[a] == spatial[b]]
    for j, (a, b) in enumerate(planes):
        do = params["rot90"][:, j]
        images = torch.where(do.view(-1, 1, 1, 1, 1),
                             torch.rot90(images, 1, dims=(a + 1, b + 1)), images)
        boxes = torch.where(do.view(-1, 1, 1), _rot90_boxes(boxes, a, b, 1.0 / spatial[a]),
                            boxes)

    if config.flip_axes or config.warps:
        n = images.shape[0]
        coords = [torch.arange(s, dtype=torch.float32, device=dev).expand(n, s)
                  for s in spatial]
        center = (shape - 1.0) / 2.0
        if config.grid_distort_prob > 0.0:
            cells = config.grid_distort_cells
            deltas = torch.where(params["distort"].view(-1, 1, 1), params["deltas"], 0.0)
            knots = []
            for ax in range(3):
                size = float(spatial[ax])
                widths = (size / cells) * (1.0 + deltas[:, ax])
                knots_in = torch.cat([torch.zeros((n, 1), device=dev),
                                      torch.cumsum(widths, dim=1)], dim=1)
                knots_in = knots_in * (size / knots_in[:, -1:])
                knots_out = torch.linspace(0.0, size, cells + 1, device=dev).expand(n, -1)
                knots.append((knots_in, knots_out))
                coords[ax] = _interp(coords[ax], knots_out, knots_in)
        if config.zoom_prob > 0.0:
            z = torch.where(params["zoom"], params["z"], 1.0)[:, None]
            coords = [center[ax] + (coords[ax] - center[ax]) / z for ax in range(3)]
        if config.affine_prob > 0.0:
            do = params["affine"][:, None]
            t = torch.where(do, params["t"], 0.0)
            s = torch.where(do, params["s"], 1.0)
            coords = [(coords[ax] - center[ax] - t[:, ax:ax + 1]) / s[:, ax:ax + 1] + center[ax]
                      for ax in range(3)]
        for j, axis in enumerate(config.flip_axes):
            do = params["flip"][:, j:j + 1]
            coords[axis] = torch.where(do, (float(spatial[axis]) - 1.0) - coords[axis],
                                       coords[axis])

        images = separable_resample(images, coords).to(images.dtype)

        for j, axis in enumerate(config.flip_axes):
            do = params["flip"][:, j].view(-1, 1, 1)
            boxes = torch.where(do, _flip_boxes(boxes, axis, 1.0 / spatial[axis]), boxes)
        if config.affine_prob > 0.0:
            s3, t3 = s[:, None, :], t[:, None, :]
            lo = s3 * (boxes[..., :3] * shape - center) + center + t3
            hi = s3 * (boxes[..., 3:] * shape - center) + center + t3
            boxes = torch.cat([lo / shape, hi / shape], dim=-1)
        if config.zoom_prob > 0.0:
            z3 = z[:, :, None]
            lo = center + (boxes[..., :3] * shape - center) * z3
            hi = center + (boxes[..., 3:] * shape - center) * z3
            boxes = torch.cat([lo / shape, hi / shape], dim=-1)
        if config.grid_distort_prob > 0.0:
            cols = []
            for ax in range(3):
                size = float(spatial[ax])
                knots_in, knots_out = knots[ax]
                cols.append((_interp(boxes[..., ax] * size, knots_in, knots_out) / size,
                             _interp(boxes[..., ax + 3] * size, knots_in, knots_out) / size))
            boxes = torch.stack([cols[0][0], cols[1][0], cols[2][0],
                                 cols[0][1], cols[1][1], cols[2][1]], dim=-1)

    if config.shift_intensity > 0.0:
        off = torch.where(params["shift"], params["offset"], 0.0)
        images = images + off.view(-1, 1, 1, 1, 1).to(images.dtype)
    if config.scale_intensity > 0.0:
        fac = torch.where(params["scale"], params["factor"], 0.0)
        images = images * (1.0 + fac).view(-1, 1, 1, 1, 1).to(images.dtype)
    return images, boxes


def augment_batch(generator: torch.Generator, images, boxes, config: AugmentConfig,
                  global_batch: int | None = None, rows=None):
    """Draw each sample's parameters from ``generator`` and apply them. With
    ``global_batch`` and ``rows`` (a data-parallel rank: slices of the global
    batch) the parameters are drawn for the global batch and the images are
    its ``rows``."""
    params = draw_augment_params(config, images.shape[0] if global_batch is None else global_batch,
                                 images.shape[1:4], generator)
    if rows is not None:
        params = {k: torch.cat([v[s] for s in rows]) for k, v in params.items()}
    return apply_augment(images, boxes, params, config)


def augment_sample(generator: torch.Generator, img, boxes, config: AugmentConfig):
    """One (D, H, W, C) image and its (M, 6) boxes."""
    images, boxes = augment_batch(generator, img[None], boxes[None], config)
    return images[0], boxes[0]
