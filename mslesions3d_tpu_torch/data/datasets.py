"""Data modules: synthetic cubes dataset and BIDS MS-lesion dataset.

Counterpart of ``mslesions3d_tpu/data/datasets.py``. Plain-Python modules
that yield padded, static-shape batches: ragged per-image box lists become
(B, MAX_OBJECTS, 6) + validity masks, so a batch is a few fixed-shape
arrays that the trainer copies to the card or gathers there by index.

Both modules share the reference's split discipline: an 80/20 split with
random_state=970205 (datasets.py:274-279, 448-449), optional 4-fold
k-fold, plus the subject / percentage / random-subject debug modes. The
splits are numpy reproductions of sklearn's ``train_test_split`` and
``KFold(shuffle=True)`` (:func:`train_test_split`, :func:`kfold_split`):
the same subjects for a seed, without sklearn.

The synthetic volumes are read by the native loader (``native/``: gzip
inflate, the float32 cast and the nonzero normalisation in one C++ call),
as the JAX package reads them; the BIDS volumes by the pure-Python NIfTI
loader and ``t_normalize_intensity``, which are also the native loader's
plain version.

The LesionsDataModule keeps the reference's BIDS path logic
(datasets.py:238-259) and preprocessing pipeline (datasets.py:195-236); it
also lifts the one-sequence limitation (datasets.py:155-156) — multiple
input sequences stack as channels.
"""

from __future__ import annotations

import math
import os
import re
import warnings
from pathlib import Path

import numpy as np
import torch

from ..native import load_nifti_fast
from ..ops.connected_components import boxes_from_segmentation_device, compact_device_boxes
from ..train.state import resolve_device
from .boxes_from_seg import boxes_from_segmentation
from .nifti import load_nifti
from .transforms import (
    t_crop_foreground,
    t_normalize_intensity,
    t_orientation,
    t_resize_with_pad_or_crop,
    t_spacing,
)

EXCLUDED_SUBJECTS = [("BASEL_INSIDER_OK", "085")]  # datasets.py:45
DEFAULT_SEED = 970205


def train_test_split(items: list, seed: int, train_size: float = 0.8,
                     test_size: float = 0.2) -> tuple[list, list]:
    """sklearn's ``train_test_split(items, train_size, test_size,
    random_state=seed)``: one permutation of ``RandomState(seed)``; the test
    set is its first ceil(test_size n) entries and the train set the next
    floor(train_size n), both in permutation order."""
    n = len(items)
    n_test, n_train = math.ceil(test_size * n), math.floor(train_size * n)
    if n_train == 0 or n_test == 0:
        raise ValueError(f"a split of {n} subjects at {train_size}/{test_size} leaves a set "
                         "empty")
    perm = np.random.RandomState(seed).permutation(n)
    return ([items[i] for i in perm[n_test:n_test + n_train]],
            [items[i] for i in perm[:n_test]])


def kfold_split(n: int, n_splits: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """sklearn's ``KFold(n_splits, shuffle=True, random_state=seed).split``
    of n items: ``arange(n)`` shuffled by ``RandomState(seed)``, folds of
    n // n_splits, one more for each of the first n % n_splits; each fold's
    train and test indices sorted."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"{n_splits} folds of {n} items")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def pad_objects(boxes: np.ndarray, labels: np.ndarray, max_objects: int):
    """Pad ragged (N,6)/(N,) GT to (max_objects, ...) + mask."""
    n = boxes.shape[0]
    if n > max_objects:
        warnings.warn(f"truncating {n} objects to max_objects={max_objects}")
        boxes, labels, n = boxes[:max_objects], labels[:max_objects], max_objects
    out_boxes = np.zeros((max_objects, 6), np.float32)
    out_labels = np.zeros((max_objects,), np.int32)
    mask = np.zeros((max_objects,), bool)
    out_boxes[:n] = boxes
    out_labels[:n] = labels
    mask[:n] = True
    return out_boxes, out_labels, mask


class _BaseDataModule:
    """Shared batching/splitting machinery."""

    def __init__(self, batch_size=8, max_objects=16, random_state=DEFAULT_SEED,
                 percentage=1.0, subject=None, cache=True):
        self.batch_size = batch_size
        self.max_objects = max_objects
        self.random_state = random_state
        self.percentage = percentage
        self.subject = subject
        self.cache = cache
        self._cache = {}
        self.subjects_list: list = []

    # -- split ------------------------------------------------------------
    def _split(self):
        if self.subject is not None:
            return [self.subject], [self.subject]
        if self.percentage == -1:
            rng = np.random.default_rng(self.random_state)
            pick = self.subjects_list[rng.integers(0, len(self.subjects_list))]
            print("Picked subject", pick)
            return [pick], [pick]
        return train_test_split(self.subjects_list, self.random_state)

    def setup(self, stage=None):
        self.trainsubs, self.testsubs = self._split()

    # -- sample loading ----------------------------------------------------
    def _load_sample(self, subject):  # pragma: no cover - overridden
        raise NotImplementedError

    def get_sample(self, subject):
        if self.cache and subject in self._cache:
            return self._cache[subject]
        sample = self._load_sample(subject)
        if self.cache:
            self._cache[subject] = sample
        return sample

    # -- batching ----------------------------------------------------------
    def _make_batch(self, subjects):
        imgs, boxes, labels, masks, batch_mask, subs = [], [], [], [], [], []
        for s in subjects:
            sample = self.get_sample(s)
            img = sample["img"]
            if img.ndim == 3:
                img = img[..., None]
            imgs.append(img.astype(np.float32))
            b, l, m = pad_objects(sample["boxes"], sample["labels"], self.max_objects)
            boxes.append(b)
            labels.append(l)
            masks.append(m)
            batch_mask.append(True)
            subs.append(s)
        # pad partial batches to the static batch size
        while len(imgs) < self.batch_size:
            imgs.append(np.zeros_like(imgs[0]))
            boxes.append(np.zeros((self.max_objects, 6), np.float32))
            labels.append(np.zeros((self.max_objects,), np.int32))
            masks.append(np.zeros((self.max_objects,), bool))
            batch_mask.append(False)
            subs.append(None)
        return {
            "image": np.stack(imgs),
            "boxes": np.stack(boxes),
            "labels": np.stack(labels),
            "box_mask": np.stack(masks),
            "batch_mask": np.asarray(batch_mask),
            "subjects": subs,
        }

    def _iter(self, subjects, shuffle=False, seed=0, drop_partial=False):
        order = list(subjects)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i : i + self.batch_size]
            if drop_partial and len(chunk) < self.batch_size:
                return
            yield self._make_batch(chunk)

    def train_batches(self, epoch: int = 0, drop_partial: bool = True):
        yield from self._iter(self.trainsubs, shuffle=True,
                              seed=(self.random_state or 0) + epoch,
                              drop_partial=drop_partial and len(self.trainsubs) >= self.batch_size)

    def val_batches(self):
        yield from self._iter(self.testsubs)

    test_batches = val_batches

    def predict_batches(self, subset="train"):
        subjects = {
            "train": self.trainsubs,
            "validation": self.testsubs,
            "test": self.testsubs,
            "all": list(self.subjects_list),
        }[subset]
        yield from self._iter(subjects)

    def steps_per_epoch(self, drop_partial: bool = True):
        n = len(self.trainsubs)
        if drop_partial and n >= self.batch_size:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def materialize(self, subjects) -> dict:
        """Stack a subject list into one contiguous array set.

        Returns {"image": (N,D,H,W,C), "boxes": (N,M,6), "labels": (N,M),
        "box_mask": (N,M)} plus the subject list. This is the host half of
        the device-resident dataset: the trainer copies these arrays to the
        card once and gathers batches there by index, so volumes cross the
        host link once per run instead of once per step.
        """
        imgs, boxes, labels, masks = [], [], [], []
        for s in subjects:
            sample = self.get_sample(s)
            img = sample["img"]
            if img.ndim == 3:
                img = img[..., None]
            imgs.append(img.astype(np.float32))
            b, l, m = pad_objects(sample["boxes"], sample["labels"], self.max_objects)
            boxes.append(b)
            labels.append(l)
            masks.append(m)
        return {
            "image": np.stack(imgs),
            "boxes": np.stack(boxes),
            "labels": np.stack(labels),
            "box_mask": np.stack(masks),
            "subjects": list(subjects),
        }


class SyntheticDataModule(_BaseDataModule):
    """Artificial-dataset module (reference ExampleDataset, datasets.py:359-485).

    Layout: <data_dir>/<images|labels>/sub-XXXX_{image,seg}.nii.gz, optionally
    nested under multiple_objects/{one,double}_class/<dataset_name> like the
    reference's directory scheme.

    ``device_boxes`` derives each sample's boxes with the connected-
    components labelling of ``ops/connected_components.py`` on ``device``
    (the card unless the caller asks for the CPU) instead of the host's
    scipy labelling; the boxes are the same set.
    """

    def __init__(self, data_dir, dataset_name=None, n_classes=1, objects="multiple",
                 percentage=1.0, batch_size=8, random_state=DEFAULT_SEED,
                 cache=True, subject=None, max_objects=16, channels=None,
                 device_boxes=False, device="cuda"):
        super().__init__(batch_size, max_objects, random_state, percentage, subject, cache)
        if n_classes not in (1, 2):
            raise ValueError(f"SyntheticDataModule: n_classes={n_classes}; 1 or 2")
        self.n_classes = n_classes
        self.device_boxes = device_boxes
        self.device = device
        # channel subset of multi-contrast (4-D) volumes, e.g. (0,) for a
        # FLAIR-only ablation of a FLAIR+T1+T2 dataset; None = all channels
        self.channels = tuple(channels) if channels is not None else None

        root = Path(data_dir)
        if objects == "multiple" and (root / "multiple_objects").exists():
            root = root / "multiple_objects"
        cls_dir = "one_class" if n_classes == 1 else "double_class"
        if (root / cls_dir).exists():
            root = root / cls_dir
        if dataset_name is not None:
            root = root / dataset_name
        self.data_dir = root

        # subject id = everything between "sub-" and the "_image" suffix —
        # no fixed width, so >9,999 images or non-numeric ids don't collide
        sub_re = re.compile(r"sub-(.+?)_image\b")
        self.subjects_list = sorted(
            m.group(1)
            for s in (self.data_dir / "images").iterdir()
            if (m := sub_re.search(s.name))
        )
        if percentage > 0:
            self.subjects_list = self.subjects_list[: int(percentage * len(self.subjects_list))]

    def _boxes_on_device(self, seg):
        """seg -> (boxes, labels) by the connected-components labelling on
        ``self.device``, as the host path's dtypes."""
        seg3 = seg[..., 0] if seg.ndim == 4 else seg
        boxes, labels, valid = boxes_from_segmentation_device(
            torch.from_numpy(np.ascontiguousarray(seg3)).to(resolve_device(self.device)),
            n_classes=self.n_classes, max_objects=self.max_objects)
        boxes, labels = compact_device_boxes(boxes, labels, valid)
        return boxes, labels.astype(np.int64)

    def _load_sample(self, subject):
        # the native loader: gzip decode, float32 cast and the nonzero
        # normalisation (datasets.py:397-407) in one call; the JAX package's
        # sample on that path, the generator's identity affine included
        img, _ = load_nifti_fast(self.data_dir / "images" / f"sub-{subject}_image.nii.gz",
                                 normalize=True)
        seg, _ = load_nifti_fast(self.data_dir / "labels" / f"sub-{subject}_seg.nii.gz")
        sample = {"img": img, "seg": seg, "affine": np.eye(4), "subject": subject}
        if self.device_boxes:
            sample["boxes"], sample["labels"] = self._boxes_on_device(sample["seg"])
        else:
            sample["boxes"], sample["labels"] = boxes_from_segmentation(
                sample["seg"], "classes", n_classes=self.n_classes)
        if self.channels is not None and sample["img"].ndim == 4:
            sample["img"] = np.ascontiguousarray(sample["img"][..., self.channels])
        return sample


def stats_foreground(datamodule, subjects=None, verbose: bool = False):
    """Survey segmentation shapes and voxel spacings over a datamodule.

    The reference's ``stats_foreground`` (datasets.py:338-355): iterates the
    dataset and returns (all_shapes, all_pixdims), one entry a subject
    (``subjects``, or every subject of the datamodule). A sample without a
    recorded pixdim (synthetic data, identity affine) reports (1.0, 1.0, 1.0).
    """
    all_shapes, all_pixdims = [], []
    for s in (subjects if subjects is not None else datamodule.subjects_list):
        sample = datamodule.get_sample(s)
        shape = tuple(np.asarray(sample["seg"]).squeeze().shape)
        if verbose:
            print(shape)
        all_shapes.append(shape)
        pixdim = sample.get("pixdim")
        all_pixdims.append(tuple(float(x) for x in pixdim[:3])
                           if pixdim is not None else (1.0, 1.0, 1.0))
    return all_shapes, all_pixdims


class LesionsDataModule(_BaseDataModule):
    """BIDS-layout MS lesion dataset (reference LesionsDataModule, datasets.py:125-335)."""

    def __init__(self, data_dir, centers=("CHUV_RIM_OK", "BASEL_INSIDER_OK"),
                 fold=None, input_images=("FLAIR",), segmentation="labeled_lesions",
                 classes=("lesion",), registration="T2star", skullstripped=True,
                 subject=None, batch_size=8, percentage=1.0,
                 random_state=DEFAULT_SEED, cache=False, max_objects=64,
                 spatial_size=(250, 300, 300)):
        super().__init__(batch_size, max_objects, random_state, percentage, subject, cache)
        self.data_dir = Path(data_dir)
        self.centers = centers
        self.registration = registration
        self.skullstripped = skullstripped
        self.input_images = tuple(input_images)
        self.segmentation = segmentation
        self.classes = classes
        self.n_classes = len(classes)
        self.fold = fold
        self.spatial_size = tuple(spatial_size)

        self.segmentation_mode = "instances" if "labeled" in segmentation else "classes"
        if self.segmentation_mode == "classes":
            self.thresholds = None
        elif self.n_classes == 1:
            self.thresholds = [(1, np.inf)]
        else:
            # per-class instance-id bands (c*1000 scheme), open-ended last
            # band; the reference only defines n_classes <= 2
            # (datasets.py:169-172)
            self.thresholds = [
                (c * 1000, (c + 1) * 1000 if c < self.n_classes else np.inf)
                for c in range(1, self.n_classes + 1)
            ]

        self.subjects_list = []
        for c in centers:
            dd = self._center_dir(c)
            if not dd.exists():
                continue
            for s in sorted(os.listdir(dd)):
                if "sub-" in s:
                    self.subjects_list.append((c, s.replace("sub-", "")))
        self.subjects_list = [x for x in self.subjects_list if x not in EXCLUDED_SUBJECTS]
        if percentage > 0:
            self.subjects_list = self.subjects_list[: int(percentage * len(self.subjects_list))]

    def _center_dir(self, center) -> Path:
        dd = self.data_dir / center
        if self.registration is not None:
            dd = dd / "derivatives" / "registrations" / f"registrations_to_{self.registration}"
        return dd

    def _sequence_path(self, center, subject, img_name) -> Path:
        """BIDS path logic parity (datasets.py:245-259)."""
        base = self._center_dir(center)
        if img_name in ("FLAIR", "acq-phase_T2star", "acq-mag_T2star"):
            if not self.skullstripped:
                return base / f"sub-{subject}" / "ses-01" / "anat" / \
                    f"sub-{subject}_ses-01_{img_name}.nii.gz"
            return base / "derivatives" / "skullstripped" / f"sub-{subject}" / "ses-01" / \
                f"sub-{subject}_ses-01_{img_name}.nii.gz"
        return base / "derivatives" / "lesionmasks" / f"sub-{subject}" / "ses-01" / \
            f"sub-{subject}_ses-01_{img_name}.nii.gz"

    def setup(self, stage=None):
        super().setup(stage)
        if self.fold is not None and stage != "all":
            train_idx, val_idx = kfold_split(len(self.trainsubs), 4, self.random_state)[self.fold]
            subs = list(self.trainsubs)
            self.trainsubs = [subs[i] for i in train_idx]
            self.testsubs = [subs[i] for i in val_idx]

    def _load_sample(self, subject):
        center, sub = subject
        volumes = []
        affine = None
        pixdim = None
        for seq in self.input_images:
            im = load_nifti(self._sequence_path(center, sub, seq))
            volumes.append(im.data.astype(np.float32))
            affine, pixdim = im.affine, im.pixdim
        seg_im = load_nifti(self._sequence_path(center, sub, self.segmentation))

        sample = {
            "img": volumes[0] if len(volumes) == 1 else np.stack(volumes, axis=-1),
            "seg": seg_im.data,
            "affine": affine,
            "pixdim": pixdim,
            "subject": f"{center}/{sub}",
            # on-disk geometry, kept for original-space prediction export
            "orig_affine": np.array(affine, np.float64),
            "orig_shape": tuple(volumes[0].shape[:3]),
        }
        # pipeline parity (datasets.py:195-236): orient LPI -> 1mm spacing ->
        # crop foreground margin 5 -> normalize nonzero -> pad/crop -> boxes
        sample = t_orientation(sample, axcodes="LPI")
        sample = t_spacing(sample, (1.0, 1.0, 1.0))
        sample = t_crop_foreground(sample, margin=5)
        sample = t_normalize_intensity(sample, nonzero=True)
        sample = t_resize_with_pad_or_crop(sample, self.spatial_size, mode="replicate")
        boxes, labels = boxes_from_segmentation(
            sample["seg"], self.segmentation_mode, self.thresholds,
            n_classes=self.n_classes,
        )
        sample["boxes"], sample["labels"] = boxes, labels
        return sample
