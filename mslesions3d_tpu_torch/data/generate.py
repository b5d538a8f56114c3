"""Synthetic "artificial dataset" generator: random cubes / hollow boxes in noise.

The port's own copy of ``mslesions3d_tpu/data/generate.py``, with the same
draws from ``RandomState(seed + idx)``: it writes the same volumes and
masks. Run it as ``python -m mslesions3d_tpu_torch.data.generate``.

Parity target: lesions3d/generate_artificial_dataset.py. Same distributions
and per-image seeding (seed + idx), same on-disk layout
(<out>/<subdir>/images/sub-XXXX_image.nii.gz, labels/sub-XXXX_seg.nii.gz)
so the datamodule and CI-parity path match the reference.

Class 0 = filled cube (mask value 1); class 1 = hollow box shell of
``object_width`` (mask value 2). The reference's shell carving zeroes the
inner slice across the WHOLE first dimension (gen:91-94), leaving shells
open-ended along dim 0; reproduce with legacy_shell_bug=True (default
False = correct closed shells).
"""

from __future__ import annotations

import argparse
import multiprocessing
from pathlib import Path

import numpy as np

from .nifti import save_nifti

# Per-contrast additive object intensity (multi-contrast mode): channel 0
# FLAIR-like (lesions bright), channel 1 T1-like (lesions dark), channel 2
# T2-like (bright, weaker contrast) — cycled for n_contrasts > 3. Shared
# geometry across channels (one segmentation), per-channel intensity profile
# (BASELINE.json config #5: FLAIR+T1+T2 3-channel volumes).
CONTRAST_DELTAS = (0.4, -0.3, 0.25)


def generate_image(
    image_dir,
    seg_dir,
    idx: int,
    n_classes: int = 1,
    image_size=(250, 300, 300),
    object_size=(10, 32),
    num_objects=(2, 5),
    object_width: int = 4,
    noise: bool = True,
    box_noise: bool = False,
    seed: int = 0,
    legacy_shell_bug: bool = False,
    n_contrasts: int = 1,
):
    rng = np.random.RandomState(seed + idx)
    image_size = tuple(image_size)
    dim = len(image_size)

    if n_contrasts > 1:
        return _generate_multicontrast(
            image_dir, seg_dir, idx, rng, n_classes, image_size, object_size,
            num_objects, object_width, noise, box_noise, legacy_shell_bug,
            n_contrasts,
        )

    data = rng.rand(*image_size) if noise else np.zeros(image_size)
    mask = np.zeros_like(data)

    n_objects = rng.randint(*num_objects)
    for _ in range(n_objects + 1):  # reference draws n_objects + 1 (gen:73)
        selected_size = rng.randint(object_size[0], object_size[1])
        selected_class = rng.randint(0, n_classes)
        top_left = [rng.randint(0, image_size[i] - selected_size) for i in range(dim)]

        slicing = tuple(slice(tp, tp + selected_size) for tp in top_left)
        intensity = 1.0 if not box_noise else rng.uniform(0.5, 1.0)

        if selected_class == 0:
            data[slicing] = data[slicing] + 0.4 if noise else intensity
            data = data.clip(0, 1)
            mask[slicing] = 1
        elif selected_class == 1:
            inner = [
                slice(tp + object_width, tp + selected_size - object_width)
                for tp in top_left
            ]
            if legacy_shell_bug and dim == 3:
                inner[0] = slice(0, image_size[0])
            object_mask = np.zeros_like(mask, dtype=bool)
            object_mask[slicing] = True
            object_mask[tuple(inner)] = False
            data[object_mask] = data[object_mask] + 0.4 if noise else intensity
            data = data.clip(0, 1)
            mask[object_mask] = 2
        else:
            raise NotImplementedError(f"class {selected_class} not supported")

    affine = np.eye(4)
    save_nifti(Path(image_dir) / f"sub-{str(idx).zfill(4)}_image.nii.gz",
               data.astype(np.float32), affine)
    save_nifti(Path(seg_dir) / f"sub-{str(idx).zfill(4)}_seg.nii.gz",
               mask.astype(np.float32), affine)


def _generate_multicontrast(
    image_dir, seg_dir, idx, rng, n_classes, image_size, object_size,
    num_objects, object_width, noise, box_noise, legacy_shell_bug,
    n_contrasts,
):
    """Multi-contrast variant: one 4-D (D,H,W,C) image, shared segmentation.

    NEW capability beyond the reference generator (which is single-contrast,
    gen:63-111): the same objects appear in every channel with the
    per-channel intensity profile CONTRAST_DELTAS. The RNG stream differs
    from the single-contrast mode (C channels of background noise are drawn
    up front), so multi-contrast datasets are their own seeded family.
    """
    dim = len(image_size)
    deltas = [CONTRAST_DELTAS[c % len(CONTRAST_DELTAS)] for c in range(n_contrasts)]

    data = (rng.rand(*image_size, n_contrasts) if noise
            else np.zeros((*image_size, n_contrasts)))
    mask = np.zeros(image_size)

    n_objects = rng.randint(*num_objects)
    for _ in range(n_objects + 1):  # reference draws n_objects + 1 (gen:73)
        selected_size = rng.randint(object_size[0], object_size[1])
        selected_class = rng.randint(0, n_classes)
        top_left = [rng.randint(0, image_size[i] - selected_size) for i in range(dim)]
        intensity = 1.0 if not box_noise else rng.uniform(0.5, 1.0)

        if selected_class == 0:
            object_mask = np.zeros(image_size, dtype=bool)
            object_mask[tuple(slice(tp, tp + selected_size) for tp in top_left)] = True
            mask_value = 1
        elif selected_class == 1:
            inner = [
                slice(tp + object_width, tp + selected_size - object_width)
                for tp in top_left
            ]
            if legacy_shell_bug and dim == 3:
                inner[0] = slice(0, image_size[0])
            object_mask = np.zeros(image_size, dtype=bool)
            object_mask[tuple(slice(tp, tp + selected_size) for tp in top_left)] = True
            object_mask[tuple(inner)] = False
            mask_value = 2
        else:
            raise NotImplementedError(f"class {selected_class} not supported")

        for c, delta in enumerate(deltas):
            ch = data[..., c]
            if noise:
                ch[object_mask] = ch[object_mask] + delta
            else:
                # no-noise mode: per-channel magnitude of the base intensity,
                # darker channels (negative delta) at reduced level
                ch[object_mask] = intensity * abs(delta) / max(abs(deltas[0]), 1e-8)
        data = data.clip(0, 1)
        mask[object_mask] = mask_value

    affine = np.eye(4)
    save_nifti(Path(image_dir) / f"sub-{str(idx).zfill(4)}_image.nii.gz",
               data.astype(np.float32), affine)
    save_nifti(Path(seg_dir) / f"sub-{str(idx).zfill(4)}_seg.nii.gz",
               mask.astype(np.float32), affine)


def generate_dataset(
    output_dir,
    num_images: int = 500,
    n_classes: int = 1,
    image_size=(250, 300, 300),
    object_size=(10, 32),
    num_objects=(2, 5),
    object_width: int = 4,
    noise: bool = True,
    box_noise: bool = False,
    seed: int = 0,
    num_processes: int = 1,
    subdir: str | None = None,
    legacy_shell_bug: bool = False,
    n_contrasts: int = 1,
):
    """Fan out image generation over a process pool (gen:114-124).

    Default subdir follows n_classes (multiple_objects/{one,double}_class) —
    the reference hardcodes one_class even for two classes (gen:51-52), which
    would strand a two-class dataset where no datamodule looks for it.
    """
    if subdir is None:
        subdir = "multiple_objects/" + ("one_class" if n_classes == 1 else "double_class")
    root = Path(output_dir) / subdir
    image_dir = root / "images"
    seg_dir = root / "labels"
    image_dir.mkdir(parents=True, exist_ok=True)
    seg_dir.mkdir(parents=True, exist_ok=True)

    args = [
        (image_dir, seg_dir, i, n_classes, image_size, object_size, num_objects,
         object_width, noise, box_noise, seed, legacy_shell_bug, n_contrasts)
        for i in range(num_images)
    ]
    if num_processes <= 1:
        for a in args:
            generate_image(*a)
    else:
        with multiprocessing.get_context("spawn").Pool(processes=num_processes) as pool:
            pool.starmap(generate_image, args)
    return root


def main(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--n_classes", type=int, default=1)
    p.add_argument("--image_size", type=int, nargs="+", default=[250, 300, 300])
    p.add_argument("--object_size", type=int, nargs="+", default=[10, 32])
    p.add_argument("--num_objects", type=int, nargs="+", default=[2, 5])
    p.add_argument("--object_width", type=int, default=4)
    p.add_argument("--num_processes", type=int, default=8)
    p.add_argument("--num_images", type=int, default=500)
    p.add_argument("--noise", type=int, default=1)
    p.add_argument("--box_noise", type=int, default=0)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--legacy_shell_bug", type=int, default=0)
    p.add_argument("--n_contrasts", type=int, default=1,
                   help="channels per image; >1 writes 4-D multi-contrast volumes")
    args = p.parse_args(argv)

    print(f"Random seed set at {args.random_seed}")
    generate_dataset(
        args.output_dir,
        num_images=args.num_images,
        n_classes=args.n_classes,
        image_size=tuple(args.image_size),
        object_size=tuple(sorted(args.object_size)),
        num_objects=tuple(args.num_objects),
        object_width=args.object_width,
        noise=bool(args.noise),
        box_noise=bool(args.box_noise),
        seed=args.random_seed,
        num_processes=args.num_processes,
        legacy_shell_bug=bool(args.legacy_shell_bug),
        n_contrasts=args.n_contrasts,
    )


if __name__ == "__main__":
    main()
