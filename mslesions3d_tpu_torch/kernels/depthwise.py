"""Fused depthwise 3x3x3 conv + folded BN + ReLU: the CUDA kernel K2 and its plain version.

:func:`fused_depthwise_bn_relu_cuda` replaces ``mslesions3d_tpu/kernels/
depthwise.py::fused_depthwise_bn_relu`` (body ``_dw_kernel``). It computes
relu(dwconv3x3x3(x) * gamma + beta) at stride 1 with zero padding 1: the 27
taps are summed in float32 in (kd, kh, kw) order, the folded BN affine and
the ReLU are applied in float32, and the result is rounded once to x's
dtype. (The unfused block rounds twice, after the conv and after the BN.)

What bounds it on the card: bytes in the ideal. Each input element is read
once and each output written once; the 27 multiply-adds per element are
about 57 float32 operations, far below the card's operations-per-byte
balance. At the model's sizes (a few MB) what costs is the work per element
the card issues and the latency of one wave. The first version issued 27
bounds-checked global loads and a chain of integer divisions per voxel.
The kernel (``csrc/depthwise.cu``, "tiled") gives each CTA a tile: one
sample, ``td`` output depths, ``th`` output rows, all of W and ``cs``
channels. Its input planes, with a one-voxel zero halo, stream into shared
memory with ``cp.async`` (the TPU kernel's three row views of depth d-1, d,
d+1; its masked clamped rows become zero taps). Each thread owns one channel
pair with its 27 weight pairs in registers and walks a row along W with a
register window of three columns, so each output reads one new
column of 9 values from shared memory. :func:`plan_depthwise` picks the tile
from the shapes; the first version stays as the "direct" variant for shapes
whose smallest tile does not fit a block's shared memory.

:func:`depthwise_bn_relu` is the plain version, summing the 27 shifted
zero-padded slices in the kernel's order, so the two agree bit for bit. The
wrapper uses it for CPU tensors only; on a CUDA tensor it launches the
kernel or raises.

Tensors are the model's (B, C, D, H, W) views in ``channels_last_3d``
memory: C is contiguous, as the kernel wants.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .build import alignment, define_op, launch, load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"tiled": 0, "direct": 1}
# csrc/depthwise.cu's entry point: (argtypes, restype)
ENTRY_POINTS = {"msl_depthwise_bn_relu": ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 13
                                          + (ctypes.c_void_p,), ctypes.c_int)}
SMEM_MAX = 232_448  # a Hopper block's opt-in maximum of shared memory
# two CTAs a SM: 2 * (smem + 1 KB the SM reserves per block) <= 228 KB
SMEM_TWO_PER_SM = 115_712
SLICE = 64  # channels a CTA at most: 32 pairs, one per lane of a warp
MAX_THREADS = 256  # csrc/depthwise.cu kMaxThreads: 8 walkers of 32 pairs
MAX_DEPTHS = 8  # kMaxDepths
PLANNED_DEPTHS = 4  # the planner tries slabs of 1-4 output depths ...
PLANNED_BANDS = 4  # ... and bands of 1/1-1/4 of the rows that fit
SMS = 132  # the H100's streaming multiprocessors
# The planner's model of a CTA's cost, in computed outputs per channel pair:
# a copied tile pixel costs HALO_COST and the CTA's prologue (its weights, the
# wait for its first three planes) CTA_COST. Set from tile sweeps on an H100;
# PERF.md has the tiles they choose and their times.
HALO_COST = 0.2
CTA_COST = 32


@dataclass(frozen=True)
class DepthwisePlan:
    """How :func:`fused_depthwise_bn_relu_cuda` runs a shape (see :func:`plan_depthwise`).

    A tiled CTA owns one sample, ``td`` output depths, ``th`` output rows,
    all of W and ``cs`` channels; its ``threads`` are walkers of ``cs / 2``
    threads (one per channel pair), each walking whole rows. ``smem`` is its
    dynamic shared memory, ``vec`` the bytes of one cp.async copy. The
    direct variant has no tile and leaves every number 0.
    """

    variant: str  # "tiled" or "direct"
    grid: int = 0
    threads: int = 0
    smem: int = 0
    cs: int = 0
    td: int = 0
    th: int = 0
    vec: int = 0


def _tile_smem(e: int, w: int, cs: int, td: int, th: int) -> int:
    """Bytes of a tile's input planes: (td + 2) x (th + 2) x (W + 2) x cs."""
    return (td + 2) * (th + 2) * (w + 2) * cs * e


@functools.cache
def plan_depthwise(dtype: torch.dtype, shape, align: int = 16, *, variant: str | None = None,
                   cs: int | None = None, td: int | None = None,
                   th: int | None = None) -> DepthwisePlan:
    """The kernel variant and tile for x of ``shape`` (B, C, D, H, W) and ``dtype``.

    ``shape`` is a tuple (or ``torch.Size``) and ``align`` the alignment of
    x's data in bytes; plans are cached, since the wrapper asks on every
    call. Pure Python: it runs without a card. The tiled variant takes every shape whose smallest tile
    fits; its choice, each step unless fixed by the keyword arguments:

    - ``cs``: min(64, C) channels, halved while one depth of the band below
      exceeds ``SMEM_MAX``; the last slice of C takes the remainder;
    - the band: all of H, halved while one depth of it exceeds
      ``SMEM_TWO_PER_SM``;
    - ``td`` and ``th``: of 1-4 output depths and 1/1-1/4 of the band's
      rows, the tile that fits ``SMEM_MAX`` with the least work on the
      busiest SM: ceil(CTAs / 132) x (outputs + ``HALO_COST`` x copied
      pixels + ``CTA_COST``) per channel pair, the larger tile on a tie; of
      the tiles that give each of the 132 SMs a CTA, where there are such;
    - ``threads``: a walker per row of the tile, at most 8;
    - ``vec``: 16, 8 or 4 bytes, the widest that divides C's and the slice's
      bytes and ``align``.

    The direct variant (the first version, with no shared memory) takes the
    shapes whose smallest tile, one depth, one row and one channel pair,
    does not fit ``SMEM_MAX``: W above 3226 in float32, above 6454 in
    bfloat16. ``variant`` forces one; a fixed tile that does not fit raises.
    """
    b, c, d, h, w = (int(n) for n in shape)
    e = torch.empty((), dtype=dtype).element_size()
    if variant == "direct" or (variant is None and _tile_smem(e, w, 2, 1, 1) > SMEM_MAX):
        return DepthwisePlan("direct")
    if variant not in (None, "tiled"):
        raise ValueError(f"plan_depthwise: variant {variant!r}; 'tiled' or 'direct'")
    fixed_cs, cs = cs, cs or min(SLICE, c)
    band = th or h
    while th is None and band > 1 and _tile_smem(e, w, cs, 1, band) > SMEM_TWO_PER_SM:
        band = -(-band // 2)
    while fixed_cs is None and cs > 2 and _tile_smem(e, w, cs, td or 1, band) > SMEM_MAX:
        cs = max(2, cs // 2 & ~1)
    ns = -(-c // cs)

    def ctas(tile):
        return b * -(-d // tile[0]) * -(-h // tile[1]) * ns

    def cost(tile):
        tdi, thi = tile
        work = tdi * thi * w + HALO_COST * (tdi + 2) * (thi + 2) * (w + 2) + CTA_COST
        return -(-ctas(tile) // SMS) * work, -tdi * thi

    depths = [td] if td else range(1, min(PLANNED_DEPTHS, d) + 1)
    rows = [th] if th else sorted({-(-band // k) for k in range(1, PLANNED_BANDS + 1)})
    tiles = [(tdi, thi) for tdi in depths for thi in rows
             if _tile_smem(e, w, cs, tdi, thi) <= SMEM_MAX]
    if cs % 2 or not 2 <= cs <= 2 * MAX_THREADS or not tiles or not 1 <= tiles[0][0] <= MAX_DEPTHS:
        raise ValueError(f"plan_depthwise: the tile cs={cs}, td={td}, th={th} of {tuple(shape)} "
                         f"{dtype} does not fit: it needs at most {SMEM_MAX:,} bytes of shared "
                         f"memory, an even cs and 1 <= td <= {MAX_DEPTHS}")
    td, th = min([t for t in tiles if ctas(t) >= SMS] or tiles, key=cost)
    pairs = cs // 2
    threads = pairs * min(MAX_THREADS // pairs, th)
    vec = math.gcd(16, c * e, cs * e, align)
    return DepthwisePlan("tiled", ctas((td, th)), threads, _tile_smem(e, w, cs, td, th), cs, td,
                         th, vec)


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Inference-fold BN params into a per-channel affine (gamma, beta)."""
    gamma = scale * torch.rsqrt(var + eps)
    beta = bias - mean * gamma
    return gamma, beta


def depthwise_taps(x: torch.Tensor, weights: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Ordered float32 sum of the 27 taps of a zero-padded depthwise 3x3x3 conv.

    x (B, D, H, W, C) float32, weights (3, 3, 3, C) float32. Output voxel i
    sums the taps at input positions stride*i + k - 1, k = 0, 1, 2, in
    (kd, kh, kw) order, starting from 0.
    """
    b, d, h, w, c = x.shape
    do, ho, wo = ((n - 1) // stride + 1 for n in (d, h, w))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, do, ho, wo, c), dtype=torch.float32, device=x.device)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = xp[:, kd: kd + stride * (do - 1) + 1: stride,
                         kh: kh + stride * (ho - 1) + 1: stride,
                         kw: kw + stride * (wo - 1) + 1: stride, :]
                acc = acc + tap * weights[kd, kh, kw]
    return acc


def depthwise_bn_relu(x: torch.Tensor, weights: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, C, D, H, W) -> same shape and dtype, channels_last_3d."""
    acc = depthwise_taps(x.permute(0, 2, 3, 4, 1).float(), weights.float())
    y = torch.relu(acc * gamma.float() + beta.float())
    return y.to(x.dtype).permute(0, 4, 1, 2, 3)


def fused_depthwise_bn_relu_cuda(x: torch.Tensor, weights: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor,
                                 plan: DepthwisePlan | None = None) -> torch.Tensor:
    """relu(dwconv3x3x3(x) * gamma + beta), stride 1, zero padding 1.

    x (B, C, D, H, W) float32 or bfloat16 in ``channels_last_3d`` memory;
    weights (3, 3, 3, C) in x's dtype; gamma, beta (C,) float32. Calls the
    registered op ``msl::fused_depthwise_bn_relu``, so that ``torch.export``
    captures it. On CUDA tensors the op launches the kernel on the current
    stream, without synchronising, and counts the launch in
    ``fused_depthwise_bn_relu_cuda.launches`` (inside an exported program
    too); ``plan`` (by default :func:`plan_depthwise`'s for x) chooses the
    variant and tile, and must be one that :func:`plan_depthwise` gives for
    x with its tile fixed. On CPU tensors the op returns
    :func:`depthwise_bn_relu`. Anything else raises.
    """
    tensors = (x, weights, gamma, beta)
    if not all(t.device.type == "cpu" for t in tensors) and (
            x.device.type != "cuda" or any(t.device != x.device for t in tensors)):
        raise ValueError(
            "fused_depthwise_bn_relu_cuda: x, weights, gamma and beta must be on one CUDA "
            f"device (or all on the CPU); got {[str(t.device) for t in tensors]}"
        )
    tile = [] if plan is None else [VARIANTS[plan.variant], *dataclasses.astuple(plan)[1:]]
    return torch.ops.msl.fused_depthwise_bn_relu(x, weights, gamma, beta, tile)


fused_depthwise_bn_relu_cuda.launches = 0


def _launch(x: torch.Tensor, weights: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            tile: list) -> torch.Tensor:
    """Check the operands and launch K2 on CUDA tensors; ``tile`` is [] (the
    planner's choice) or a :class:`DepthwisePlan`'s fields, the variant as 0
    (tiled) or 1 (direct)."""
    tensors = (x, weights, gamma, beta)
    if x.dim() != 5:
        raise ValueError(f"fused_depthwise_bn_relu_cuda: x must be (B, C, D, H, W), got "
                         f"{tuple(x.shape)}")
    b, c, d, h, w = x.shape
    if x.dtype not in DTYPES or weights.dtype != x.dtype:
        raise ValueError(
            f"fused_depthwise_bn_relu_cuda: x and weights must both be float32 or both "
            f"bfloat16, got {x.dtype} and {weights.dtype}"
        )
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError("fused_depthwise_bn_relu_cuda: gamma and beta must be float32")
    if weights.shape != (3, 3, 3, c) or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(
            f"fused_depthwise_bn_relu_cuda: for C={c} expected weights (3, 3, 3, {c}) and "
            f"gamma, beta ({c},); got {tuple(weights.shape)}, {tuple(gamma.shape)}, "
            f"{tuple(beta.shape)}"
        )
    if c % 2:
        raise ValueError(f"fused_depthwise_bn_relu_cuda: C={c}; the kernel reads channel "
                         "pairs and needs an even C")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("fused_depthwise_bn_relu_cuda: x must be contiguous in "
                         "channels_last_3d memory (C innermost)")
    if not (weights.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("fused_depthwise_bn_relu_cuda: weights, gamma and beta must be "
                         "contiguous")
    pair = 2 * x.element_size()
    if any(t.data_ptr() % (2 * t.element_size()) for t in tensors):
        raise ValueError(f"fused_depthwise_bn_relu_cuda: data must be aligned to channel "
                         f"pairs ({pair} bytes for x)")
    out = torch.empty_like(x, memory_format=torch.channels_last_3d)
    if out.numel() == 0:
        return out
    align = alignment(x)
    if not tile:
        plan = plan_depthwise(x.dtype, x.shape, align)
    else:
        plan = DepthwisePlan(("tiled", "direct")[tile[0]], *tile[1:])
        if plan != plan_depthwise(x.dtype, x.shape, align, variant=plan.variant,
                                  cs=plan.cs or None, td=plan.td or None, th=plan.th or None):
            raise ValueError(f"fused_depthwise_bn_relu_cuda: {plan} is not a plan for x "
                             f"{tuple(x.shape)} {x.dtype} at {align}-byte alignment")
    launch("fused_depthwise_bn_relu_cuda", load_library("depthwise", **ENTRY_POINTS),
           "msl_depthwise_bn_relu", x.device, x.data_ptr(), weights.data_ptr(),
           gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), DTYPES[x.dtype], b, d, h, w, c,
           VARIANTS[plan.variant], plan.cs, plan.td, plan.th, plan.threads, plan.smem, plan.vec)
    fused_depthwise_bn_relu_cuda.launches += 1
    return out


# K2 as a registered op
define_op(
    "fused_depthwise_bn_relu(Tensor x, Tensor weights, Tensor gamma, Tensor beta, "
    "SymInt[] tile) -> Tensor",
    lambda x, weights, gamma, beta, tile: depthwise_bn_relu(x, weights, gamma, beta),
    _launch,
    lambda x, weights, gamma, beta, tile: torch.empty_like(
        x, memory_format=torch.channels_last_3d),
)
