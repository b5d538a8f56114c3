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
bitmask is 8x smaller, and the walk holds only a few words' rows at a time.
:func:`plan_nms` picks the walk from K: up to 2048 candidates the "warp"
walk keeps the removed bitset in one warp's lanes; past that the "wide"
walk keeps it in shared memory and stages 3, 2 or 1 words of rows, as many
as fit, or, past what one word's rows take, reads the kept rows from global
memory. The source has the details.

:func:`greedy_nms` is the plain version: the same function as a fixpoint
over a boolean suppression matrix, on any leading batch shape. The wrapper
uses it for CPU tensors only; on a CUDA tensor it launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..ops.boxes import pairwise_iou
from .build import define_op, launch, load_library

SMEM_MAX = 232_448  # a Hopper block's opt-in maximum of shared memory
GRID_YZ_MAX = 65_535  # gridDim.y and gridDim.z
# the warp walk holds one 64-candidate word of the removed bitset per lane
# of its walking warp: 32 words, 2048 candidates
WARP_WALK_WORDS = 32
WIDE_STAGES = (3, 2, 1, 0)
# csrc/nms.cu's entry points: (argtypes, restype)
ENTRY_POINTS = {
    "msl_greedy_nms": ((ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                  ctypes.c_int, ctypes.c_void_p), ctypes.c_int),
    "msl_nms_walk_smem_bytes": ((ctypes.c_int, ctypes.c_int), ctypes.c_longlong),
}


@dataclass(frozen=True)
class NmsPlan:
    """How :func:`greedy_nms_cuda` runs K candidates (see :func:`plan_nms`).

    ``walk`` is "warp" or "wide"; ``stages`` the words of mask rows the wide
    walk stages in shared memory ahead of the one it resolves (0: it reads
    the kept rows from global memory); ``smem`` the walk's dynamic shared
    memory in bytes; ``mask_grid`` the mask launch's (y, z) blocks per row.
    """

    walk: str
    stages: int
    smem: int
    mask_grid: tuple


def mask_words(k: int) -> int:
    """Words of 64 bits per mask row: ceil(k / 64), rounded up to even so
    that every row starts on 16 bytes for the walk's copies."""
    return -(-k // 128) * 2


def walk_smem_bytes(k: int, walk: str, stages: int = 3) -> int:
    """csrc/nms.cu's walk_smem_bytes (warp) and wide_smem_bytes (wide)."""
    nwp = mask_words(k)
    if walk == "warp":  # three buffers of 64 rows and of one diagonal block
        return 3 * 64 * (nwp + 1) * 8
    # stages buffers of 64 rows and diagonal blocks, the removed bitset, the
    # kept word and the count
    return (stages * 64 * (nwp + 1) + nwp + 2) * 8


@functools.cache
def plan_nms(k: int, *, walk: str | None = None, stages: int | None = None) -> NmsPlan:
    """The walk for K candidates a row, and the mask launch's grid.

    Pure Python: it runs without a card. The warp walk takes K <= 2048 (32
    words). The wide walk takes any K, with the most staged words of
    ``WIDE_STAGES`` whose buffers fit ``SMEM_MAX``: 3 up to K = 9472, 2 up
    to 14336, 1 up to 28544, then 0. The mask launch's triangle of nw(nw+1)/2
    blocks a row (nw = ceil(K/64)) is spread over gridDim.y and gridDim.z,
    each at most 65535. ``walk`` and ``stages`` force a choice (the tests
    run every walk at small K); one that does not fit raises.
    """
    if k <= 0:
        raise ValueError(f"plan_nms: K={k}")
    nw = -(-k // 64)
    tri = nw * (nw + 1) // 2
    gy = min(tri, GRID_YZ_MAX)
    grid = (gy, -(-tri // gy))
    if grid[1] > GRID_YZ_MAX:
        raise ValueError(f"plan_nms: K={k} needs more than 65535 x 65535 mask blocks a row")
    walk = walk or ("warp" if nw <= WARP_WALK_WORDS else "wide")
    if walk == "warp":
        if nw > WARP_WALK_WORDS or stages not in (None, 3):
            raise ValueError(f"plan_nms: the warp walk takes K <= 2048 and 3 stages, not K={k}")
        return NmsPlan("warp", 3, walk_smem_bytes(k, "warp"), grid)
    if walk != "wide":
        raise ValueError(f"plan_nms: walk {walk!r}; 'warp' or 'wide'")
    options = WIDE_STAGES if stages is None else (stages,)
    for s in options:
        smem = walk_smem_bytes(k, "wide", s)
        if s in WIDE_STAGES and smem <= SMEM_MAX:
            return NmsPlan("wide", s, smem, grid)
    raise ValueError(f"plan_nms: no wide walk{'' if stages is None else f' with {stages} stages'}"
                     f" fits K={k} in {SMEM_MAX} B of shared memory")


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


def greedy_nms_cuda(boxes: torch.Tensor, valid: torch.Tensor, max_overlap: float,
                    plan: NmsPlan | None = None) -> torch.Tensor:
    """Batched exact greedy NMS: boxes (N, K, 6) float32, valid (N, K) bool -> keep (N, K).

    Calls the registered op ``msl::greedy_nms``, so that ``torch.export``
    captures it. On CUDA tensors the op launches the kernel on the current
    stream, without synchronising, and counts the launch in
    ``greedy_nms_cuda.launches`` (inside an exported program too). It
    takes any K; ``plan`` (default :func:`plan_nms` of K) picks the walk.
    Its scratch is N x nwp x (K + 64) 64-bit words, nwp = ceil(K/64)
    rounded up to even: about 64 MB at the 96^3 headline with top_k = 395
    and batch 32 (N = 32, K = 3942, nwp = 62), and 1 MB at K = 1000, N = 8.
    On CPU tensors the op returns :func:`greedy_nms`. Anything else raises.
    """
    if not (boxes.device.type == "cpu" and valid.device.type == "cpu") and (
            boxes.device.type != "cuda" or valid.device != boxes.device):
        raise ValueError(
            f"greedy_nms_cuda: boxes on {boxes.device} and valid on {valid.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    walk, stages = (plan.walk, plan.stages) if plan is not None else ("", -1)
    return torch.ops.msl.greedy_nms(boxes, valid, float(max_overlap), walk, stages)


greedy_nms_cuda.launches = 0


def _launch(boxes: torch.Tensor, valid: torch.Tensor, max_overlap: float,
            walk: str | None, stages: int | None) -> torch.Tensor:
    """Check the operands and launch K1 on CUDA tensors."""
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
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    # a given plan is re-derived for this K: one that does not fit raises
    plan = plan_nms(k, walk=walk, stages=stages)
    nwp = mask_words(k)
    # the mask rows (n, k, nwp), then the transposed diagonal blocks (n, nwp, 64)
    scratch = torch.empty(n * nwp * (k + 64), dtype=torch.int64, device=boxes.device)
    launch("greedy_nms_cuda", load_library("nms", **ENTRY_POINTS), "msl_greedy_nms",
           boxes.device, boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
           scratch[n * k * nwp:].data_ptr(), keep.data_ptr(), n, k, float(max_overlap),
           -1 if plan.walk == "warp" else plan.stages)
    greedy_nms_cuda.launches += 1
    return keep


def _greedy_nms_cpu(boxes, valid, max_overlap, walk, stages) -> torch.Tensor:
    keep = greedy_nms(boxes, valid, max_overlap)
    return keep.clone() if keep is valid else keep  # an op's output never aliases its input


# K1 as a registered op; ``walk`` "" and ``stages`` -1 leave the walk to plan_nms
define_op(
    "greedy_nms(Tensor boxes, Tensor valid, float max_overlap, str walk, SymInt stages) -> Tensor",
    _greedy_nms_cpu,
    lambda boxes, valid, max_overlap, walk, stages: _launch(
        boxes, valid, max_overlap, walk or None, None if stages < 0 else stages),
    lambda boxes, valid, max_overlap, walk, stages: torch.empty_like(valid),
)

