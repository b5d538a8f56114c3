"""Minimal self-contained NIfTI-1 I/O (pure numpy + gzip; no nibabel).

The port's own copy of ``mslesions3d_tpu/data/nifti.py``: files written by
either package read back equal in the other.

Supports the subset the framework needs: single-file .nii / .nii.gz, scalar
3D/4D volumes, sform/qform affines, data scaling. Write path emits fp32/uint8
/int16 volumes with an sform affine (magic "n+1").

Reference behavior replaced: nibabel load/save used via MONAI LoadImaged and
nib.save (lesions3d/datasets.py:101, generate_artificial_dataset.py:107-111,
predict.py:225-226).
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray
    affine: np.ndarray  # (4, 4)
    pixdim: tuple = (1.0, 1.0, 1.0)

    @property
    def shape(self):
        return self.data.shape


def _quaternion_to_rotation(b, c, d):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def load_nifti(path) -> NiftiImage:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        raw = f.read()

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != HEADER_SIZE:
        if struct.unpack_from(">i", raw, 0)[0] == HEADER_SIZE:
            raise NotImplementedError("big-endian NIfTI not supported")
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    qform_code, sform_code = struct.unpack_from("<2h", raw, 252)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype])

    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        srow = np.array(struct.unpack_from("<12f", raw, 280)).reshape(3, 4)
        affine = np.vstack([srow, [0, 0, 0, 1]])
    elif qform_code > 0:
        b, c, d = struct.unpack_from("<3f", raw, 256)
        ox, oy, oz = struct.unpack_from("<3f", raw, 268)
        rot = _quaternion_to_rotation(b, c, d)
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        scale = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine = np.eye(4)
        affine[:3, :3] = rot * scale
        affine[:3, 3] = (ox, oy, oz)
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    return NiftiImage(
        data=np.ascontiguousarray(data),
        affine=affine,
        pixdim=tuple(abs(p) or 1.0 for p in pixdim[1:4]),
    )


def save_nifti(path, data: np.ndarray, affine: np.ndarray | None = None):
    path = Path(path)
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float64)

    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    # voxel sizes from the affine column norms
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    pixdim = [1.0] + [float(z) for z in zooms] + [1.0] * (7 - 3)

    header = bytearray(HEADER_SIZE)
    struct.pack_into("<i", header, 0, HEADER_SIZE)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, datatype)
    struct.pack_into("<h", header, 72, bitpix)
    struct.pack_into("<8f", header, 76, *pixdim)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", header, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", header, 252, 0, 1)  # qform=0, sform=1
    struct.pack_into("<12f", header, 280, *affine[:3, :4].reshape(-1))
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz":
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
