"""Host-side preprocessing transforms (numpy/scipy) with a declarative registry.

The port's own copy of ``mslesions3d_tpu/data/transforms.py``; the same
functions, registry names and ``transform_meta`` records.

Replaces the reference's MONAI transform pipeline (lesions3d/datasets.py:
99-122, 195-236): load -> orient -> resample -> crop-foreground -> normalize
-> pad/crop -> seg->boxes. These run once per volume on the host (cached by
the datamodule); random augmentations run on the device (augment.py).

Transforms operate on a sample dict with keys: img (D,H,W) or (D,H,W,C),
seg (D,H,W), affine (4,4), pixdim, subject, and after box generation:
boxes (N,6) fractional corner-form + labels (N,).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .boxes_from_seg import _LazyNdimage, boxes_from_segmentation

# scipy.ndimage costs ~0.4 s at import; only zoom() needs it.
ndimage = _LazyNdimage()

# ---------------------------------------------------------------------------
# orientation


_AXCODE_DIRS = {"R": (0, 1), "L": (0, -1), "A": (1, 1), "P": (1, -1), "S": (2, 1), "I": (2, -1)}


def io_orientation(affine: np.ndarray):
    """(axis, direction) per volume axis from the affine (nibabel-style)."""
    rzs = affine[:3, :3]
    out = []
    used = set()
    for col in range(3):
        vec = rzs[:, col]
        order = np.argsort(-np.abs(vec))
        axis = next(int(a) for a in order if int(a) not in used)
        used.add(axis)
        out.append((axis, 1 if vec[axis] >= 0 else -1))
    return out


def orient_to_axcodes(img, seg, affine, axcodes: str = "LPI"):
    """Reorder/flip volume axes so axis i points along axcodes[i].

    Parity: MONAI Orientationd (datasets.py:201). Works on 3D volumes.
    Returns (img, seg, affine, perm, flips): perm maps new axis i to the
    original axis perm[i] (per-axis metadata like pixdim must be permuted
    with it) and flips[i] says whether new axis i was reversed — together
    they define the inverse map back to the on-disk grid.
    """
    targets = [_AXCODE_DIRS[c] for c in axcodes]
    current = io_orientation(affine)

    perm = []
    flips = []
    for t_axis, t_dir in targets:
        src = next(i for i, (a, _) in enumerate(current) if a == t_axis)
        perm.append(src)
        flips.append(current[src][1] != t_dir)

    def apply(vol):
        if vol is None:
            return None
        # spatial perm; trailing (channel) axes pass through untouched
        full_perm = list(perm) + list(range(3, vol.ndim))
        v = np.transpose(vol, full_perm)
        for ax, f in enumerate(flips):
            if f:
                v = np.flip(v, axis=ax)
        return np.ascontiguousarray(v)

    # update affine: permutation + flips
    new_affine = affine.copy()
    shape = img.shape[:3]
    pa = np.zeros((4, 4))
    pa[3, 3] = 1
    for new_ax, src in enumerate(perm):
        sign = -1 if flips[new_ax] else 1
        pa[src, new_ax] = sign
        if flips[new_ax]:
            new_affine[:3, 3] += affine[:3, src] * (np.asarray(shape)[src] - 1)
    new_affine[:3, :3] = affine[:3, :3] @ pa[:3, :3]
    return apply(img), apply(seg), new_affine, perm, flips


# ---------------------------------------------------------------------------
# individual transforms


def t_spacing(sample, pixdim=(1.0, 1.0, 1.0), mode=("bilinear", "nearest")):
    """Resample to target voxel spacing (MONAI Spacingd; datasets.py:202)."""
    cur = np.asarray(sample.get("pixdim", (1.0, 1.0, 1.0)), np.float64)
    target = np.asarray(pixdim, np.float64)
    zoom = cur / target
    if np.allclose(zoom, 1.0):
        return sample
    orders = {"bilinear": 1, "nearest": 0}
    sample.setdefault("transform_meta", []).append({"op": "zoom", "zoom": list(zoom)})
    img_zoom = list(zoom) + [1.0] * (sample["img"].ndim - 3)
    sample["img"] = ndimage.zoom(sample["img"], img_zoom, order=orders[mode[0]])
    if sample.get("seg") is not None:
        sample["seg"] = ndimage.zoom(sample["seg"], zoom, order=orders[mode[1]])
    sample["pixdim"] = tuple(target)
    return sample


def t_orientation(sample, axcodes="LPI"):
    pre_shape = list(sample["img"].shape[:3])
    img, seg, affine, perm, flips = orient_to_axcodes(
        sample["img"], sample.get("seg"), sample.get("affine", np.eye(4)), axcodes
    )
    sample.setdefault("transform_meta", []).append(
        {"op": "orient", "perm": list(perm), "flips": [bool(f) for f in flips],
         "orig_shape": pre_shape}
    )
    sample["img"], sample["affine"] = img, affine
    if seg is not None:
        sample["seg"] = seg
    if "pixdim" in sample and sample["pixdim"] is not None:
        # per-axis spacing must follow the axis permutation: t_spacing would
        # otherwise zoom the reoriented volume by the wrong per-axis factors
        # (anisotropic sagittal/coronal acquisitions). MONAI's Spacingd reads
        # spacing from the post-Orientationd affine and is immune.
        pixdim = np.asarray(sample["pixdim"], np.float64)
        sample["pixdim"] = tuple(float(pixdim[p]) for p in perm)
    return sample


def t_crop_foreground(sample, margin=5, source_key="img"):
    """Crop to the nonzero bounding box of source_key plus margin (datasets.py:203).

    Records the crop offset in sample["transform_meta"] so predictions can be
    inverse-mapped to the original space (reference predict.py:284-304 uses
    MONAI inverse transforms for this).
    """
    src = sample[source_key]
    src = src if src.ndim == 3 else src.max(axis=tuple(range(3, src.ndim)))
    nz = np.nonzero(src > 0)
    if len(nz[0]) == 0:
        return sample
    lo = [max(int(n.min()) - margin, 0) for n in nz]
    hi = [min(int(n.max()) + 1 + margin, s) for n, s in zip(nz, src.shape)]
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    sample.setdefault("transform_meta", []).append(
        {"op": "crop", "offset": lo, "orig_shape": list(src.shape)}
    )
    sample["img"] = sample["img"][sl]
    if sample.get("seg") is not None:
        sample["seg"] = sample["seg"][sl]
    return sample


def t_normalize_intensity(sample, nonzero=True):
    """Zero-mean/unit-std over (nonzero) voxels (MONAI NormalizeIntensityd).

    4-D (D,H,W,C) multi-contrast images normalize per channel — each
    contrast is an independently-scaled acquisition (matches the native
    loader's msl_nifti_load normalize path).
    """
    img = sample["img"].astype(np.float32)

    def _norm(vol):
        if nonzero:
            mask = vol != 0
            vals = vol[mask]
            if vals.size:
                vol[mask] = (vals - vals.mean()) / max(vals.std(), 1e-8)
            return vol
        return (vol - vol.mean()) / max(vol.std(), 1e-8)

    if img.ndim == 4:
        for c in range(img.shape[-1]):
            img[..., c] = _norm(img[..., c])
    else:
        img = _norm(img)
    sample["img"] = img
    return sample


def t_resize_with_pad_or_crop(sample, spatial_size, mode="replicate"):
    """Symmetric center pad/crop to spatial_size (MONAI ResizeWithPadOrCropd).

    Records per-axis shifts in sample["transform_meta"] for inverse mapping:
    final_voxel = orig_voxel + shift (shift >= 0 when padding, < 0 when
    cropping).
    """
    pad_mode = {"replicate": "edge", "constant": "constant"}[mode]
    shifts = []
    for ax, target in enumerate(spatial_size):
        cur = sample["img"].shape[ax]
        shifts.append((target - cur) // 2 if cur < target else -((cur - target) // 2))
    sample.setdefault("transform_meta", []).append(
        {"op": "pad_or_crop", "shift": shifts,
         "orig_shape": list(sample["img"].shape[:3])}
    )

    def fix(vol, is_seg):
        for ax, target in enumerate(spatial_size):
            cur = vol.shape[ax]
            if cur > target:
                start = (cur - target) // 2
                sl = [slice(None)] * vol.ndim
                sl[ax] = slice(start, start + target)
                vol = vol[tuple(sl)]
            elif cur < target:
                before = (target - cur) // 2
                after = target - cur - before
                pads = [(0, 0)] * vol.ndim
                pads[ax] = (before, after)
                vol = np.pad(vol, pads, mode="constant" if is_seg else pad_mode)
        return vol

    sample["img"] = fix(sample["img"], False)
    if sample.get("seg") is not None:
        sample["seg"] = fix(sample["seg"], True)
    return sample


def t_bounding_boxes_generator(sample, segmentation_mode="instances", thresholds=None,
                               classes=None, n_classes=None):
    boxes, labels = boxes_from_segmentation(
        sample["seg"], segmentation_mode, thresholds, classes, n_classes
    )
    sample["boxes"] = boxes
    sample["labels"] = labels
    return sample


def t_scale_intensity(sample, minv=0.0, maxv=1.0):
    img = sample["img"].astype(np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo) * (maxv - minv) + minv
    sample["img"] = img
    return sample


def t_printer(sample, prefix: str = "", keys=None):
    """Pipeline debug printer (reference Printer, utils.py:721-732).

    Insert anywhere in a compose to dump what flows through: array keys get
    shape/dtype/value-range, boxes/labels get counts, everything else its
    repr. Returns the sample unchanged.
    """
    parts = []
    for k, v in sample.items():
        if keys is not None and k not in keys:
            continue
        if isinstance(v, np.ndarray):
            rng = f" [{v.min():.3g}, {v.max():.3g}]" if v.size else ""
            parts.append(f"{k}: {v.dtype}{list(v.shape)}{rng}")
        elif k == "transform_meta":
            parts.append(f"{k}: {[m['op'] for m in v]}")
        else:
            parts.append(f"{k}: {v!r}")
    print(f"[printer]{' ' + prefix if prefix else ''} " + " | ".join(parts),
          flush=True)
    return sample


def t_show_image(sample, out_dir=".", axis: int = 0, keys=("img", "seg")):
    """Save mid-volume slices as PNGs (reference ShowImage, utils.py:688-718).

    The reference pops up a matplotlib window per sample; headless hosts
    get the same view written to <out_dir>/<subject>_<key>_ax<axis>.png
    (.npy when matplotlib is not installed). Returns the sample unchanged.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    subject = str(sample.get("subject", "sample")).replace("/", "_")
    for key in keys:
        vol = sample.get(key)
        if vol is None:
            continue
        vol3 = vol if vol.ndim == 3 else vol[..., 0]
        sl = [slice(None)] * 3
        sl[axis] = vol3.shape[axis] // 2
        plane = np.asarray(vol3[tuple(sl)], np.float32)
        stem = out / f"{subject}_{key}_ax{axis}"
        try:
            import matplotlib
        except ImportError:
            np.save(stem.with_suffix(".npy"), plane)
            continue
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax_ = plt.subplots(figsize=(4, 4))
        ax_.imshow(plane, cmap="gray")
        ax_.set_title(f"{subject} {key} axis {axis}")
        ax_.axis("off")
        fig.savefig(stem.with_suffix(".png"), dpi=100, bbox_inches="tight")
        plt.close(fig)
    return sample


# Names mirror the reference registry (datasets.py:99-122). Random
# augmentations (flip/rotate90/zoom/affine/shift/scale intensity) run on the
# device (augment.py) and are configured by name through AugmentConfig.
HOST_TRANSFORMS = {
    "orientation": t_orientation,
    "spacing": t_spacing,
    "crop_foreground": t_crop_foreground,
    "normalizeintensity": t_normalize_intensity,
    "resize_with_pad_or_crop": t_resize_with_pad_or_crop,
    "bounding_boxes_generator": t_bounding_boxes_generator,
    "scale_intensity": t_scale_intensity,
    "printer": t_printer,
    "show_image": t_show_image,
}


def get_transform_from_name(name: str, **kwargs):
    fn = HOST_TRANSFORMS[name]
    return lambda sample: fn(sample, **kwargs)


def inverse_map_boxes(boxes_frac: np.ndarray, final_shape, transform_meta,
                      pixdim_zoom=None):
    """Map fractional boxes in final (network) space back to original voxels.

    Walks the recorded transform_meta backwards (pad/crop shift, foreground
    crop offset, spacing zoom, orientation permutation+flips) and finally
    undoes an extra resampling if pixdim_zoom (original_spacing -> 1mm zoom
    factors) is given. Returns voxel-space corner boxes in the ORIGINAL
    on-disk image grid. This is the box-level inverse of the reference's
    MONAI inverse-transform save path (predict.py:284-304).
    """
    boxes = np.asarray(boxes_frac, np.float64) * np.asarray(tuple(final_shape) * 2)
    for meta in reversed(transform_meta or []):
        if meta["op"] == "pad_or_crop":
            shift = np.asarray(meta["shift"], np.float64)
            boxes[:, :3] -= shift
            boxes[:, 3:] -= shift
        elif meta["op"] == "crop":
            offset = np.asarray(meta["offset"], np.float64)
            boxes[:, :3] += offset
            boxes[:, 3:] += offset
        elif meta["op"] == "zoom":
            zoom = np.asarray(meta["zoom"], np.float64)
            boxes[:, :3] /= zoom
            boxes[:, 3:] /= zoom
        elif meta["op"] == "orient":
            # oriented axis i came from disk axis perm[i] (flipped if
            # flips[i]); undo flips in oriented space (continuous corner
            # coords: lo/hi swap under x -> S - x), then scatter columns
            # back to their disk axes
            perm = meta["perm"]
            flips = meta["flips"]
            orig_shape = np.asarray(meta["orig_shape"], np.float64)
            out = np.empty_like(boxes)
            for i in range(3):
                lo, hi = boxes[:, i], boxes[:, i + 3]
                if flips[i]:
                    size = orig_shape[perm[i]]
                    lo, hi = size - hi, size - lo
                out[:, perm[i]] = lo
                out[:, perm[i] + 3] = hi
            boxes = out
    if pixdim_zoom is not None:
        zoom = np.asarray(pixdim_zoom, np.float64)  # orig -> resampled factor
        boxes[:, :3] /= zoom
        boxes[:, 3:] /= zoom
    return boxes


def compose(transforms):
    def run(sample):
        for t in transforms:
            sample = t(sample)
        return sample

    return run
