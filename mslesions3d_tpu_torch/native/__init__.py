"""The host's native NIfTI loader (``native.py``, ``nifti_loader.cc``)."""

from .native import available, build, load_nifti_fast

__all__ = ["available", "build", "load_nifti_fast"]
