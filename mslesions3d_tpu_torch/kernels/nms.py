"""Exact batched greedy 3D NMS: the CUDA kernel K1 and its plain version.

:func:`greedy_nms_cuda` replaces ``mslesions3d_tpu/kernels/nms.py::
greedy_nms_pallas`` (body ``_nms_kernel``). For each row n of candidates,
sorted by decreasing score, it returns keep[n, i] = valid[n, i] and no kept
j < i has IoU(j, i) > max_overlap: the reference's sequential suppression.

The kernel (``csrc/nms.cu``) is bounded on the card by the IoU of every
candidate pair below the row's last valid index, and by the greedy walk's
chain of dependent steps. Its design: a first launch spreads the pair work
over every SM and writes a bitmask of 64-bit words (bit i of row j: IoU(j,
i) > t and j < i), and each diagonal 64x64 block once more transposed,
skipping the blocks past the last valid candidate as the TPU kernel does; a
second launch walks each row with one block, a 64-candidate word at a time:
one warp's ballots resolve the greedy order inside the word, then four
warps OR the kept rows into the later words, rows that were staged into
shared memory while the words before resolved. The TPU design's bf16 KxK
matrix in fast memory does not fit a block's shared memory at K = 1000; the
bitmask is 8x smaller, and the walk holds only three words' rows at a
time. The source has the details.

:func:`greedy_nms` is the plain version: the same function as a fixpoint
over a boolean suppression matrix, on any leading batch shape. The wrapper
uses it for CPU tensors only; on a CUDA tensor it launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.boxes import pairwise_iou
from .build import load_library

# The walking warp holds one 64-candidate word of the removed bitset per
# lane: 32 words, 2048 candidates.
MAX_K = 32 * 64


def mask_words(k: int) -> int:
    """Words of 64 bits per mask row: ceil(k / 64), rounded up to even so
    that every row starts on 16 bytes for the walk's copies."""
    return -(-k // 128) * 2


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, max_overlap: float) -> torch.Tensor:
    """Plain exact greedy NMS by fixpoint iteration; returns the keep mask.

    boxes (..., K, 6) float32 corner form, sorted by decreasing score within
    each row; valid (..., K) bool. The greedy keep set is the unique fixpoint
    of keep[i] = valid[i] and not any_{j<i}(keep[j] and IoU(j, i) > t);
    iterating from keep = valid reaches it in at most the depth of the
    longest suppression chain.
    """
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)  # (..., K, K), [j, i]
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)  # j < i
    suppresses = (iou > max_overlap) & upper
    keep = valid
    while True:
        hit = (keep[..., :, None] & suppresses).any(dim=-2)  # a kept j suppresses i
        new = valid & ~hit
        if torch.equal(new, keep):
            return keep
        keep = new


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("nms")
    lib.msl_greedy_nms.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.msl_greedy_nms.restype = ctypes.c_int
    lib.msl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def greedy_nms_cuda(boxes: torch.Tensor, valid: torch.Tensor, max_overlap: float) -> torch.Tensor:
    """Batched exact greedy NMS: boxes (N, K, 6) float32, valid (N, K) bool -> keep (N, K).

    On CUDA tensors this launches the kernel on the current stream, without
    synchronising, and counts the launch in ``greedy_nms_cuda.launches``. On
    CPU tensors it returns :func:`greedy_nms`. Anything else raises.
    """
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return greedy_nms(boxes, valid, max_overlap)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(
            f"greedy_nms_cuda: boxes on {boxes.device} and valid on {valid.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if boxes.dim() != 3 or boxes.shape[2] != 6 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"greedy_nms_cuda: expected boxes (N, K, 6) and valid (N, K), got "
            f"{tuple(boxes.shape)} and {tuple(valid.shape)}"
        )
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(
            f"greedy_nms_cuda: expected float32 boxes and bool valid, got "
            f"{boxes.dtype} and {valid.dtype}"
        )
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_nms_cuda: boxes and valid must be contiguous")
    n, k = valid.shape
    if k > MAX_K:
        raise ValueError(
            f"greedy_nms_cuda: K={k} candidates are {-(-k // 64)} words of 64, more than "
            f"the 32 lanes of the walking warp hold; K must be <= {MAX_K} (lower top_k)"
        )
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    nwp = mask_words(k)
    # the mask rows (n, k, nwp), then the transposed diagonal blocks (n, nwp, 64)
    scratch = torch.empty(n * nwp * (k + 64), dtype=torch.int64, device=boxes.device)
    lib = _library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msl_greedy_nms(
            boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
            scratch[n * k * nwp:].data_ptr(), keep.data_ptr(),
            n, k, float(max_overlap), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"greedy_nms_cuda: launch failed: {lib.msl_cuda_error_string(err).decode()}"
        )
    greedy_nms_cuda.launches += 1
    return keep


greedy_nms_cuda.launches = 0
