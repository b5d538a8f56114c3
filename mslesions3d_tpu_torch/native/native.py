"""ctypes bindings of the native NIfTI loader (counterpart of
``mslesions3d_tpu/native/native.py``).

``nifti_loader.cc`` does gzip inflate (zlib), header parse, the Fortran->C
transpose, the float32 cast and the optional nonzero normalisation (per
channel for 4-D volumes) in one call, with a per-thread cache of the last
file inflated, keyed by path, mtime and size. g++ builds it at first use
into ``build/native/`` at the root of the checkout
(``kernels.build.build_library``: hashed by source, flags and compiler
version, renamed into place atomically); nothing is written into the
package. Unlike the JAX package, which falls back to its Python loader on
any error, the port has one path: a failed build raises with the
compiler's output, and a file the loader cannot read raises its error code.
The Python loader (``data/nifti.py`` with ``t_normalize_intensity``) is the
loader's plain version and ``LesionsDataModule``'s loader.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..kernels.build import BUILD_ROOT, build_library

SOURCE = Path(__file__).resolve().parent / "nifti_loader.cc"
BUILD_DIR = BUILD_ROOT / "native"
# the JAX package's flags (native.py), so the two libraries decode alike
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz",)


def build() -> tuple[Path, str]:
    """Compile the loader if needed; returns (library path, g++'s log)."""
    return build_library(SOURCE, "g++", GXX_FLAGS, BUILD_DIR, LIBS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name in ("msl_nifti_shape", "msl_nifti_shape4"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float)]
        fn.restype = ctypes.c_int
    lib.msl_nifti_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, ctypes.c_int]
    lib.msl_nifti_load.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True once the loader is built and loaded (it builds at the first
    call); a failed build raises with g++'s output rather than answer False."""
    return _library() is not None


def load_nifti_fast(path, normalize: bool = False):
    """A 3-D or 4-D NIfTI volume as a float32 C-order array, decoded natively.

    4-D (multi-contrast) volumes come back channels-last (D, H, W, C), 3-D
    ones 3-D. ``normalize`` applies the nonzero mean / std normalisation,
    per channel for 4-D (MONAI's ``NormalizeIntensityd(nonzero=True)``).
    Returns (data, pixdim), a zero pixdim read as 1.0; raises RuntimeError
    with the loader's code when it cannot read the file.
    """
    lib = _library()
    path_b = str(path).encode()
    shape = (ctypes.c_int * 4)()
    pixdim = (ctypes.c_float * 3)()
    rc = lib.msl_nifti_shape4(path_b, shape, pixdim)
    if rc != 0:
        raise RuntimeError(f"msl_nifti_shape4 failed with code {rc} for {path}")
    dims = (shape[0], shape[1], shape[2]) if shape[3] == 1 else tuple(shape)
    out = np.empty(dims, dtype=np.float32)
    rc = lib.msl_nifti_load(path_b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            out.size, 1 if normalize else 0)
    if rc != 0:
        raise RuntimeError(f"msl_nifti_load failed with code {rc} for {path}")
    return out, tuple(float(p) or 1.0 for p in pixdim)
