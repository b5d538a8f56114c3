"""Data: the NIfTI and synthetic pipeline on the host, augmentation on the device.

The generator is ``python -m mslesions3d_tpu_torch.data.generate`` (not
imported here, so that running it as a module imports it once)."""

from .augment import AugmentConfig, apply_augment, augment_batch, draw_augment_params
from .datasets import LesionsDataModule, SyntheticDataModule, pad_objects, stats_foreground
from .nifti import load_nifti, save_nifti
from .prefetch import prefetch_batches

__all__ = [
    "AugmentConfig", "apply_augment", "augment_batch", "draw_augment_params",
    "LesionsDataModule", "SyntheticDataModule", "pad_objects", "stats_foreground",
    "load_nifti", "save_nifti", "prefetch_batches",
]
