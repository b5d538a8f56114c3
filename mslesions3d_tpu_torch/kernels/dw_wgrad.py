"""Depthwise 3x3x3 weight gradient: a CUDA kernel and its plain version.

:func:`depthwise_wgrad_cuda` adds the weight gradient of a 3x3x3 conv whose
groups have one input channel each into a float32 ``grad_w``: from the
conv's input x and its output gradient gz, the weight half of
``aten.convolution_backward``. x has C channels (a depthwise conv, groups =
C) or one (a conv of one input channel, groups = 1, as the stem: a
depthwise conv whose one channel feeds all C outputs). The training
backward (``models.layers._ConvBNReLU``) calls it on the card for every
such conv, a chunk of samples at a time; cuDNN keeps the input gradient.

Replaces no TPU kernel: the JAX package leaves this gradient to XLA (the
vjp of ``jax.lax.conv_general_dilated``). It was added because cuDNN runs
both kinds through its grouped weight gradient
(``wgrad2d_grouped_direct``), which ran at about 0.37% of its byte bound on
an H100 and took about half of a batch-64 MobileNet train step, most of it
in the stem's.

What bounds it on the card: bytes, in the ideal. Each element of x and gz
is needed once; the 27 multiply-adds per element of gz are far below the
card's operations-per-byte balance, though at the stem's 32 outputs of one
input channel they take as long to execute as its bytes take to arrive. The
kernel (``csrc/dw_wgrad.cu``) cuts the work into tiles of samples, output
depths, rows and columns and a slice of the channels. Each CTA takes every
``ctas``-th tile of its slice through two shared-memory buffers, issuing
the next tile's copies (``cp.async``, 16 bytes a copy along the contiguous
channels where C allows; the input region with the halo its taps reach,
zeros outside the volume) before it sums the one that has landed. Each
thread keeps 9 taps of its channels in float32 registers across the CTA's
tiles (a one-channel x is one value a tap for all of them); the CTA writes
a workspace row of 27 x C sums, and a second kernel adds the rows, in a
fixed order, into ``grad_w``. No float atomics, so a launch repeats bit for
bit. :func:`plan_dw_wgrad` picks the tile and the CTAs from the shapes.

:func:`depthwise_wgrad` is the plain version: the 27 taps in (kd, kh, kw)
order, each the float32 sum (``torch.sum`` over samples and positions) of
the shifted, zero-padded, strided x times gz. The kernel sums in another
order, so the two agree to float32 rounding, not bit for bit. The wrapper
takes the plain version for CPU tensors only; on a CUDA tensor it launches
the kernel or raises.

Tensors are the model's (N, C, D, H, W) views in ``channels_last_3d``
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
# csrc/dw_wgrad.cu's entry point: (argtypes, restype)
ENTRY_POINTS = {"msl_dw_wgrad": ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 24
                                 + (ctypes.c_void_p,), ctypes.c_int)}
SMEM_MAX = 232_448  # a Hopper block's opt-in maximum of shared memory
SMEM_SM = 233_472  # a SM's shared memory for its blocks (228 KB), 1 KB of it reserved a block
# two CTAs a SM: 2 * (smem + 1 KB) <= 228 KB
SMEM_TWO_PER_SM = 115_712
MAX_THREADS = 256  # csrc/dw_wgrad.cu kMaxThreads
REGISTERS = 65_536  # a SM's
# registers a thread (nvcc -Xptxas -v): 48-64 for an x of C channels, 90 for a one-channel x
THREAD_REGISTERS = {False: 64, True: 96}
SLICE_BYTES = (64, 512)  # a CTA's channels span this many bytes of a position, where C allows
SMS = 132  # the H100's streaming multiprocessors
# The planner's model of a tile's cost, in bytes staged: its waits and index
# work cost TILE_COST more. On an H100 its picks for the recipe's stem and
# block 1 are within 2% of the fastest tile of a sweep (PERF.md).
TILE_COST = 8192


@dataclass(frozen=True)
class DwWgradPlan:
    """How :func:`depthwise_wgrad_cuda` runs a shape (see :func:`plan_dw_wgrad`).

    A tile is ``tn`` samples, ``td`` output depths, ``th`` output rows,
    ``tw`` output columns and ``cs`` channels; each of the ``ctas`` CTAs of
    a channel slice takes every ``ctas``-th of its ``tiles`` tiles in turn,
    staging the next while it sums one (two buffers where it has more than
    one); ``p`` position workers of each (channel group, kd) sum, in
    ``threads`` a CTA with ``smem`` bytes of dynamic shared memory; ``vec``
    and ``xvec`` bytes a copy of gz and of x. The workspace has a row a CTA.
    """

    cs: int
    tn: int
    td: int
    th: int
    tw: int
    p: int
    threads: int
    ctas: int
    smem: int
    vec: int
    xvec: int
    tiles: int


def output_size(size: int, stride: int, padding: int) -> int:
    """Output extent of a 3-tap window at ``stride`` with zero ``padding``."""
    return (size + 2 * padding - 3) // stride + 1


def _cpt(cs: int) -> int:
    """Channels a thread: 4 or 1 (csrc/dw_wgrad.cu's template)."""
    return 4 if cs % 4 == 0 else 1


def _buffer(e: int, cs: int, xcs: int, tile, stride) -> int:
    """Bytes of a buffer: a tile's input region (``xcs`` channels a
    position) and its gz tile, each from a 16-byte boundary
    (csrc/dw_wgrad.cu's ``buf``)."""
    tn, td, th, tw = tile
    rd, rh, rw = (s * (t - 1) + 3 for s, t in zip(stride, (td, th, tw)))
    xs = -(-tn * rd * rh * rw * xcs * e // 16) * 16
    return -(-(xs + tn * td * th * tw * cs * e) // 16) * 16


def _workers(cs: int, positions: int) -> tuple[int, int]:
    """(p, threads): as many position workers as fit MAX_THREADS, at most
    the tile's positions; threads rounded up to whole warps."""
    groups = cs // _cpt(cs)
    p = max(1, min(positions, MAX_THREADS // (3 * groups)))
    return p, -(-3 * groups * p // 32) * 32


def _fractions(size: int) -> list:
    """The tile sides that split ``size`` into 1, 2, ... pieces."""
    return sorted({-(-size // k) for k in range(1, size + 1)}, reverse=True)


@functools.cache
def plan_dw_wgrad(dtype: torch.dtype, shape, stride, padding=(1, 1, 1), align: int = 16, *,
                  channels: int | None = None, cs: int | None = None, tn: int | None = None,
                  td: int | None = None, th: int | None = None,
                  tw: int | None = None) -> DwWgradPlan:
    """The tile for x of ``shape`` (N, CX, D, H, W) and ``dtype`` under
    ``stride`` and ``padding`` (3-tuples), for ``channels`` output channels
    (gz's C; CX by default, else CX is 1); ``align`` is the alignment of x's
    and gz's data in bytes. Plans are cached, since the wrapper asks on every
    call. Pure Python: it runs without a card. Each step unless fixed by the
    keyword arguments:

    - ``cs``: the divisors of C spanning 64-512 bytes of a position (all of
      C where C spans less than 64; the largest under 512 where none does);
    - ``tw``: all of OW, halved while the smallest tile (one sample, depth
      and row) does not fit ``SMEM_TWO_PER_SM`` twice;
    - ``ctas`` of a slice for a tile: as many as the SMs hold at once (by
      shared memory with two buffers, threads and ``THREAD_REGISTERS``),
      at most one a tile;
    - ``tn`` (powers of 2 and N), ``td`` and ``th`` (the sides that split
      OD and OH into equal pieces): of the tiles whose CTAs fit
      ``SMEM_TWO_PER_SM`` (two CTAs a SM) where any do, the one with the
      least bytes on the busiest SM, its tiles a CTA x its CTAs x (staged
      bytes a tile + ``TILE_COST``), the larger tile on a tie; of those that
      give each of the 132 SMs a CTA, where there are such;
    - ``p`` and ``threads``: position workers of each channel group and kd
      up to ``MAX_THREADS`` threads;
    - ``vec`` (``xvec``): 16, 8, 4 or 2 bytes, the widest that divides gz's
      (x's) channels' and slice's bytes and ``align``.

    A fixed tile that does not fit ``SMEM_MAX`` raises.
    """
    n, cx, d, h, w = (int(v) for v in shape)
    c = int(channels or cx)
    if cx not in (c, 1):
        raise ValueError(f"plan_dw_wgrad: x's {cx} channels are neither the {c} outputs nor 1")
    stride, padding = tuple(int(s) for s in stride), tuple(int(p) for p in padding)
    od, oh, ow = (output_size(v, s, p) for v, s, p in zip((d, h, w), stride, padding))
    if min(od, oh, ow) < 1:
        raise ValueError(f"plan_dw_wgrad: {tuple(shape)} at stride {stride}, padding "
                         f"{padding} has no output")
    e = torch.empty((), dtype=dtype).element_size()
    divisors = [k for k in range(1, c + 1) if c % k == 0]
    lo, hi = min(SLICE_BYTES[0], c * e), SLICE_BYTES[1]
    slices = ([cs] if cs else [k for k in divisors if lo <= k * e <= hi]
              or [max(k for k in divisors if k * e <= hi)])

    def xcs(k):
        return 1 if cx == 1 else k

    def layout(k, tile):
        """(p, threads, tiles, ctas, smem) of slice width k and tile."""
        p, threads = _workers(k, math.prod(tile))
        tiles = math.prod(-(-v // t) for v, t in zip((n, od, oh, ow), tile))
        buf, red = _buffer(e, k, xcs(k), tile, stride), p * 27 * k * 4
        resident = max(1, min(SMEM_SM // (max(2 * buf, red) + 1024), 2048 // threads,
                              REGISTERS // (threads * THREAD_REGISTERS[cx == 1])))
        ctas = max(1, min(tiles, SMS * resident // (c // k)))
        return p, threads, tiles, ctas, max((2 if ctas < tiles else 1) * buf, red)

    if tw is None:
        tw = ow
        while tw > 1 and layout(min(slices), (1, 1, 1, tw))[4] > SMEM_TWO_PER_SM:
            tw = -(-tw // 2)
    nsides = [tn] if tn else sorted({*(2 ** i for i in range(n.bit_length()) if 2 ** i <= n), n})
    candidates = [(k, (a, b, f, tw)) for k in slices for a in nsides
                  for b in ([td] if td else _fractions(od))
                  for f in ([th] if th else _fractions(oh))]
    for limit in (SMEM_TWO_PER_SM, SMEM_MAX):
        fitting = [(k, t) for k, t in candidates if layout(k, t)[4] <= limit]
        if fitting:
            break
    else:
        raise ValueError(f"plan_dw_wgrad: no tile of {tuple(shape)} {dtype} (cs={cs}, tn={tn}, "
                         f"td={td}, th={th}, tw={tw}) fits {SMEM_MAX:,} bytes of shared memory")

    def spread(item):
        k, tile = item
        return layout(k, tile)[3] * (c // k) >= SMS

    def cost(item):
        k, tile = item
        _, _, tiles, ctas, _ = layout(k, tile)
        rd, rh, rw = (s * (t - 1) + 3 for s, t in zip(stride, tile[1:]))
        staged = tile[0] * (rd * rh * rw * xcs(k) + math.prod(tile[1:]) * k) * e
        busiest = -(-tiles // ctas) * -(-ctas * (c // k) // SMS)
        return busiest * (staged + TILE_COST), -math.prod(tile) * k

    cs, tile = min([t for t in fitting if spread(t)] or fitting, key=cost)
    p, threads, tiles, ctas, smem = layout(cs, tile)
    vec = math.gcd(16, c * e, cs * e, align)
    xvec = math.gcd(16, cx * e, xcs(cs) * e, align)
    return DwWgradPlan(cs, *tile, p, threads, ctas, smem, vec, xvec, tiles)


def depthwise_wgrad(x: torch.Tensor, gz: torch.Tensor, stride, padding) -> torch.Tensor:
    """Plain version: the (C, 1, 3, 3, 3) float32 weight gradient of a 3x3x3
    conv of x (N, C or 1, D, H, W) whose groups have one input channel each
    (depthwise, or one input channel for all C outputs) at ``stride`` with
    zero ``padding``, whose output gradient is gz (N, C, OD, OH, OW). Tap
    (kd, kh, kw), in that order, is ``torch.sum`` in float32 over samples and
    output positions of gz times x zero-padded and shifted by the tap at the
    stride."""
    (sd, sh, sw), (pd, ph, pw) = stride, padding
    od, oh, ow = gz.shape[2:]
    xp = F.pad(x.float(), (pw, pw, ph, ph, pd, pd))
    g = gz.float()
    out = torch.empty((gz.shape[1], 1, 3, 3, 3), dtype=torch.float32, device=x.device)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = xp[:, :, kd: kd + sd * (od - 1) + 1: sd, kh: kh + sh * (oh - 1) + 1: sh,
                         kw: kw + sw * (ow - 1) + 1: sw]
                out[:, 0, kd, kh, kw] = (tap * g).sum(dim=(0, 2, 3, 4))
    return out


def _check(x, gz, grad_w, stride, padding, dilation) -> None:
    """Raises on what the kernel does not take, on either route."""
    name = "depthwise_wgrad_cuda"
    tensors = (x, gz, grad_w)
    if not all(t.device.type == "cpu" for t in tensors) and (
            x.device.type != "cuda" or any(t.device != x.device for t in tensors)):
        raise ValueError(f"{name}: x, gz and grad_w must be on one CUDA device (or all on the "
                         f"CPU); got {[str(t.device) for t in tensors]}")
    if x.dim() != 5 or gz.dim() != 5:
        raise ValueError(f"{name}: x and gz must be (N, C, D, H, W); got {tuple(x.shape)}, "
                         f"{tuple(gz.shape)}")
    if x.dtype not in DTYPES or gz.dtype != x.dtype:
        raise ValueError(f"{name}: x and gz must both be float32 or both bfloat16; got "
                         f"{x.dtype} and {gz.dtype}")
    if len(stride) != 3 or any(s not in (1, 2) for s in stride):
        raise ValueError(f"{name}: stride {tuple(stride)}; each must be 1 or 2")
    if len(padding) != 3 or any(p not in (0, 1) for p in padding):
        raise ValueError(f"{name}: padding {tuple(padding)}; each must be 0 or 1")
    if tuple(dilation) != (1, 1, 1):
        raise ValueError(f"{name}: dilation {tuple(dilation)}; the kernel takes dilation 1")
    n, cx, d, h, w = x.shape
    c = gz.shape[1]
    if grad_w.dtype != torch.float32 or grad_w.shape != (c, 1, 3, 3, 3) \
            or not grad_w.is_contiguous():
        raise ValueError(f"{name}: grad_w must be a contiguous float32 ({c}, 1, 3, 3, 3), the "
                         f"gradient of a 3x3x3 kernel of one input channel a group; got "
                         f"{grad_w.dtype} {tuple(grad_w.shape)}")
    if cx not in (c, 1):
        raise ValueError(f"{name}: x has {cx} channels; a depthwise conv's {c} or one")
    out = (n, c, *(output_size(v, s, p) for v, s, p in zip((d, h, w), stride, padding)))
    if tuple(gz.shape) != out:
        raise ValueError(f"{name}: gz must be the conv's output gradient {out}; got "
                         f"{tuple(gz.shape)}")
    fmt = torch.channels_last_3d
    if not (x.is_contiguous(memory_format=fmt) and gz.is_contiguous(memory_format=fmt)):
        raise ValueError(f"{name}: x and gz must be contiguous in channels_last_3d memory "
                         "(C innermost)")


def depthwise_wgrad_cuda(x: torch.Tensor, gz: torch.Tensor, grad_w: torch.Tensor, stride,
                         padding, dilation=(1, 1, 1), plan: DwWgradPlan | None = None) -> None:
    """grad_w += the weight gradient of a 3x3x3 conv whose groups have one
    input channel each.

    x (N, C or 1, D, H, W) is the conv's input and gz (N, C, OD, OH, OW) its
    output gradient, both float32 or both bfloat16 in ``channels_last_3d``
    memory; grad_w (C, 1, 3, 3, 3) float32. Strides 1 or 2 and paddings 0 or
    1 per dimension, dilation 1. Calls the registered op
    ``msl::depthwise_wgrad``. On CUDA tensors the op launches the kernel on
    the current stream, without synchronising, and counts the launch in
    ``depthwise_wgrad_cuda.launches``; ``plan`` (by default
    :func:`plan_dw_wgrad`'s for x) chooses the tile, and must be one that
    :func:`plan_dw_wgrad` gives for x with its tile fixed. On CPU tensors the
    op adds :func:`depthwise_wgrad`. Anything else raises, on either route.
    """
    _check(x, gz, grad_w, stride, padding, dilation)
    tile = [] if plan is None else list(dataclasses.astuple(plan))
    torch.ops.msl.depthwise_wgrad(x, gz, grad_w, list(stride), list(padding), tile)


depthwise_wgrad_cuda.launches = 0


def _launch(x, gz, grad_w, stride, padding, tile) -> None:
    """The op on CUDA tensors that :func:`_check` passed: launches the
    kernel; ``tile`` is [] (the planner's choice) or a
    :class:`DwWgradPlan`'s fields."""
    if x.numel() == 0 or gz.numel() == 0:
        return
    align = alignment(x, gz)
    shape, stride, padding = tuple(x.shape), tuple(stride), tuple(padding)
    channels = gz.shape[1]
    if not tile:
        plan = plan_dw_wgrad(x.dtype, shape, stride, padding, align, channels=channels)
    else:
        plan = DwWgradPlan(*tile)
        if plan != plan_dw_wgrad(x.dtype, shape, stride, padding, align, channels=channels,
                                 cs=plan.cs, tn=plan.tn, td=plan.td, th=plan.th, tw=plan.tw):
            raise ValueError(f"depthwise_wgrad_cuda: {plan} is not a plan for x {shape} "
                             f"{x.dtype} at {align}-byte alignment")
    n, cx, d, h, w = shape
    c = gz.shape[1]
    ws = torch.empty(plan.ctas * 27 * c, dtype=torch.float32, device=x.device)
    launch("depthwise_wgrad_cuda", load_library("dw_wgrad", **ENTRY_POINTS), "msl_dw_wgrad",
           x.device, x.data_ptr(), gz.data_ptr(), grad_w.data_ptr(), ws.data_ptr(),
           DTYPES[x.dtype], n, d, h, w, c, cx, *stride, *padding, plan.cs, plan.tn, plan.td,
           plan.th, plan.tw, plan.p, plan.threads, plan.ctas, plan.smem, plan.vec, plan.xvec)
    depthwise_wgrad_cuda.launches += 1


def _wgrad_cpu(x, gz, grad_w, stride, padding, tile) -> None:
    """The op on CPU tensors: adds the plain version (``tile`` unused)."""
    grad_w += depthwise_wgrad(x, gz, stride, padding)


# K4 as a registered op: it adds into grad_w
define_op(
    "depthwise_wgrad(Tensor x, Tensor gz, Tensor(a!) grad_w, int[] stride, int[] padding, "
    "int[] tile) -> ()",
    _wgrad_cpu,
    _launch,
    lambda x, gz, grad_w, stride, padding, tile: None,
)
