"""Data on the device: augmentation."""

from .augment import AugmentConfig, apply_augment, augment_batch, draw_augment_params

__all__ = ["AugmentConfig", "apply_augment", "augment_batch", "draw_augment_params"]
