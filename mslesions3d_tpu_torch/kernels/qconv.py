"""int8 3D convolution with int32 accumulation and a fused epilogue: the CUDA kernel Q1 and its plain version.

Q1 is not a TPU kernel. It replaces the int8 convs of
``mslesions3d_tpu/quant.py::_qconv`` (:212-220), which XLA runs as
``conv_general_dilated`` on int8 operands with ``preferred_element_type=
int32``; torch on CUDA has no int8 conv3d. For q (B, D, H, W, Cin) int8 in
NDHWC and wq (k, k, k, Cin / groups, Cout) int8 in DHWIO, with k 3 or 1,
zero padding k // 2, a stride of 1 or 2 on each axis and ``groups`` 1
(dense: the stem, the pointwise convs, the heads) or Cin (depthwise, Cout =
Cin), it sums in int32 and writes, through one epilogue, one of:

- :func:`qconv_cuda` (op ``msl::qconv``): ``y = relu?(float32(acc) *
  scale[oc] + bias[oc])`` in float32, the form of the first version;
- :func:`qconv_codes_cuda` (op ``msl::qconv_codes``): the int8 codes of y
  for one or two activation scales, ``clip(round(y / sx), -127, 127)``
  (``requantize``) fused into the epilogue: what the next conv of the
  backbone reads and, at an emitted layer, what the heads read. Its input
  may be the caller's float32 or bf16 image, quantized as it loads;
- :func:`qconv_heads_cuda` (op ``msl::qconv_heads``): the loc and cls heads
  of a feature layer in one launch over their concatenated weights, y split
  by column into two float32 tensors;
- :func:`qconv_s32_cuda`: the int32 sums alone, to hold the arithmetic exact.

What bounds it on the card: bytes. A forward's int8 operations are far below
the tensor cores' rate; what costs is moving operands and outputs, which the
codes (one byte where float32 took four and a requantize pass read them
back) halve. :func:`plan_qconv` picks the variant and tile of
``csrc/qconv.cu`` from the shapes:

- ``igemm`` (dense, Cin % 16 == 0: the pointwise convs and the heads): an
  implicit GEMM on the tensor cores (``mma.sync`` m16n8k32 s8), M the
  output voxels, N Cout, K taps x Cin in k-steps of 32 bytes; operand tiles
  stream through shared memory with ``cp.async`` (zero-filled taps and
  edges); a tile of :data:`IGEMM_TILES` per shape, its warps splitting K
  where M is small;
- ``stem`` (Cin 1, 3^3): a voxel's 27 taps padded to 32 are one k-step,
  gathered from an input patch quantized into shared memory once;
- ``depthwise`` (3^3, Cin % 4 == 0): CUDA cores, a shared-memory patch, a
  char4 of channels and a register window of 4 outputs along W a thread;
- ``direct`` (the first version, one thread an output element): every other
  shape.

:func:`pack_weights` stores a model's dense weights as (Cout, k, k, k, Cin),
the B operand's layout; ``quant.QuantizedSSD3D`` stores them so once, and
weights given in another layout are repacked at every call.

:func:`qconv_s32` is the plain integer conv: ``F.conv3d`` in float64 of the
int8 values, rounded to int32, exact since every sum stays far below 2^53.
:func:`qconv_reference` adds the same epilogue, :func:`qconv_codes_reference`
is ``requantize(qconv_reference(...))`` and :func:`qconv_heads_reference`
its columns split, so the kernels and the plain versions agree bit for bit.
Each wrapper uses the plain version for CPU tensors only; on a CUDA tensor
it launches a kernel or raises. Every launch of any variant counts in
``qconv_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .build import alignment, define_op, launch, load_library

QMAX = 128  # the largest magnitude of an int8 operand
IN_DTYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
MODES = {"sums": 0, "float": 1, "codes": 2, "heads": 3}
VARIANTS = {"direct": 0, "igemm": 1, "stem": 2, "depthwise": 3}
# csrc/qconv.cu's entry point: (argtypes, restype)
ENTRY_POINTS = {"msl_qconv": ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 31
                              + (ctypes.c_void_p,), ctypes.c_int)}
# csrc/qconv.cu's Tile table, in its order: name -> (BM, BN, WM, WN, WK, KC,
# stages): a CTA's rows and columns, its warps along M, N and K, the bytes of
# K a stage and the stages in flight
IGEMM_TILES = {
    "m128n64": (128, 64, 4, 2, 1, 64, 3),
    "m64n64": (64, 64, 2, 2, 1, 64, 3),
    "m32n64k4": (32, 64, 1, 2, 4, 128, 3),
    "m64n16k4": (64, 16, 2, 1, 4, 128, 3),
    "m16n16k8": (16, 16, 1, 1, 8, 512, 3),
}
SMS = 132  # the H100's streaming multiprocessors
SMEM_DEFAULT = 49_152  # a block's shared memory without opting in: the planner stays below
SMEM_MAX = 232_448  # a Hopper block's opt-in maximum
STEM_THREADS = 128  # csrc/qconv.cu kStemThreads
STEM_MAX_COUT = 64
DW_THREADS = 256  # kDwThreads
DW_RUN = 4  # kRun: outputs along W a depthwise thread sums at once
DW_SLICE = 64  # channels a depthwise CTA at most


def _strides(stride) -> tuple:
    return tuple(int(s) for s in stride) if isinstance(stride, (tuple, list)) else (int(stride),) * 3


def _out_dims(dims, k: int, strides) -> tuple:
    return tuple((n + 2 * (k // 2) - k) // s + 1 for n, s in zip(dims, strides))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_weights(wq: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """wq (k, k, k, Cin / groups, Cout) int8 as Q1 reads it, contiguous:
    a dense conv's (``groups`` 1) as (Cout, k, k, k, Cin), the rows of the
    implicit GEMM's B operand; a depthwise conv's as they are."""
    return wq.contiguous() if groups > 1 else wq.permute(4, 0, 1, 2, 3).contiguous()


def unpack_weights(wk: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """:func:`pack_weights`' result as a (k, k, k, Cin / groups, Cout) view,
    which Q1 reads without a copy."""
    return wk if groups > 1 else wk.permute(1, 2, 3, 4, 0)


# ---------------------------------------------------------------- the plain versions
def requantize(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """clip(round(x / sx), -127, 127) as int8; round half to even, as jnp.round."""
    return torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)


def qconv_s32(q: torch.Tensor, wq: torch.Tensor, stride=1, groups: int = 1) -> torch.Tensor:
    """Plain integer conv: q (B, D, H, W, Cin) int8, wq (k, k, k, Cin/groups,
    Cout) int8 -> (B, Do, Ho, Wo, Cout) int32, zero padding k // 2."""
    k = wq.shape[0]
    y = F.conv3d(q.permute(0, 4, 1, 2, 3).double(), wq.permute(4, 3, 0, 1, 2).double(),
                 stride=_strides(stride), padding=k // 2, groups=groups)
    return y.round().to(torch.int32).permute(0, 2, 3, 4, 1).contiguous()


def qconv_epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """float32(acc) * scale + bias, then ReLU if asked: two roundings, as the kernel."""
    y = acc.float() * scale + bias
    return torch.relu(y) if relu else y


def qconv_reference(q, wq, scale, bias, stride=1, groups: int = 1, relu: bool = False):
    """Plain version of :func:`qconv_cuda`."""
    return qconv_epilogue(qconv_s32(q, wq, stride, groups), scale, bias, relu)


def qconv_codes_reference(x, wq, scale, bias, sx_out, stride=1, groups: int = 1,
                          relu: bool = True, sx_in=None):
    """Plain version of :func:`qconv_codes_cuda`: x requantized with ``sx_in``
    where it is a float image, the conv, then one plane of codes a scale of
    ``sx_out``: (len(sx_out), B, Do, Ho, Wo, Cout) int8."""
    q = x if x.dtype == torch.int8 else requantize(x.float(), sx_in)
    y = qconv_reference(q, wq, scale, bias, stride, groups, relu)
    return torch.stack([requantize(y, sx_out[i]) for i in range(sx_out.shape[0])])


def qconv_heads_reference(q, wq, scale, bias, split: int):
    """Plain version of :func:`qconv_heads_cuda`: the 3^3 head conv (stride
    1, no ReLU) over the concatenated weights, its columns before ``split``
    and from it as two contiguous float32 tensors."""
    y = qconv_reference(q, wq, scale, bias)
    # clones: a slice of a single voxel's row is contiguous, and the op's
    # two outputs must not alias each other
    return (y[..., :split].clone(memory_format=torch.contiguous_format),
            y[..., split:].clone(memory_format=torch.contiguous_format))


# ---------------------------------------------------------------- the planner
@dataclass(frozen=True)
class QconvPlan:
    """How Q1 runs a conv (see :func:`plan_qconv`).

    ``igemm``: ``tile`` names a row of :data:`IGEMM_TILES`; ``grid`` counts
    its CTAs. ``stem``: a CTA's ``tz`` x ``ty`` x ``tx`` outputs. ``depthwise``:
    a CTA's ``tz`` output depths and ``ty`` rows of all columns in a slice of
    ``cs`` channels, its threads ``cs / 4`` channel quads x ``walkers``,
    ``vec`` the bytes of one cp.async copy. ``direct`` has no tile; ``vec``
    4 there means it sums channel quads (``__dp4a``). ``smem`` is the
    dynamic shared memory of a CTA.
    """

    variant: str
    tile: str = ""
    grid: int = 0
    threads: int = 0
    smem: int = 0
    tz: int = 0
    ty: int = 0
    tx: int = 0
    cs: int = 0
    walkers: int = 0
    vec: int = 0


def igemm_smem(tile: str) -> int:
    """Bytes of shared memory a CTA of ``tile`` uses: the larger of its ring
    of stages ((BM + BN) rows of KC + 16 bytes each) and its staged sums (WK
    slices of BM rows of BN + 8 int32s)."""
    bm, bn, _, _, wk, kc, stages = IGEMM_TILES[tile]
    return max(stages * (bm + bn) * (kc + 16), wk * bm * (bn + 8) * 4)


def igemm_threads(tile: str) -> int:
    _, _, wm, wn, wk, _, _ = IGEMM_TILES[tile]
    return 32 * wm * wn * wk


def stem_n8(cout: int) -> int:
    """The stem kernel's n8 tiles: Cout rounded up to 8, 16, 32 or 64."""
    return next(n for n in (1, 2, 4, 8) if 8 * n >= cout)


def stem_smem(cout: int, strides, tz: int, ty: int, tx: int) -> int:
    """The stem CTA's patch ((t - 1) * stride + 3 a side, int8, padded to 16
    bytes), and for each row of its m16 tiles the output row (int64), the
    patch offset (int32) and the staged sums ((8 n8 + 8) int32s)."""
    sd, sh, sw = strides
    patch = ((tz - 1) * sd + 3) * ((ty - 1) * sh + 3) * ((tx - 1) * sw + 3)
    return _cdiv(patch, 16) * 16 + _cdiv(tz * ty * tx, 16) * 16 * (
        12 + (8 * stem_n8(cout) + 8) * 4)


def dw_smem(cs: int, out_w: int, strides, tz: int, ty: int) -> int:
    """The depthwise CTA's patch: (tz - 1) s + 3 depths x (ty - 1) s + 3 rows
    x the columns of whole runs of 4 outputs, cs bytes a voxel."""
    sd, sh, sw = strides
    px = (_cdiv(out_w, DW_RUN) * DW_RUN - 1) * sw + 3
    return ((tz - 1) * sd + 3) * ((ty - 1) * sh + 3) * px * cs


@functools.cache
def plan_qconv(shape, wshape, stride=1, groups: int = 1, dtype: torch.dtype = torch.int8,
               align: int = 16, *, variant: str | None = None, tile: str | None = None,
               tz: int | None = None, ty: int | None = None, tx: int | None = None,
               cs: int | None = None) -> QconvPlan:
    """Q1's variant and tile for x of ``shape`` (B, D, H, W, Cin) and
    ``dtype`` (int8 codes, or a float32 / bf16 image for a dense conv) and
    weights of ``wshape`` (k, k, k, Cin / groups, Cout); ``align`` is the
    smaller alignment of x's and the weights' data in bytes. Plans are
    cached; pure Python, it runs without a card. Each choice, unless fixed
    by the keyword arguments:

    - ``variant``: depthwise (groups = Cin > 1) 3^3 with Cin % 4 == 0 takes
      ``depthwise``; a dense 3^3 conv of Cin 1 and Cout <= 64, ``stem``; a
      dense conv of int8 codes with Cin % 16 == 0 and 16-byte alignment,
      ``igemm``; every other conv ``direct``;
    - igemm's ``tile``: for Cout <= 16 (the heads) ``m64n16k4`` or
      ``m16n16k8``, else ``m128n64``, ``m64n64`` or ``m32n64k4``: the first
      that gives the 132 SMs a CTA each, or the last (most CTAs) where none
      does;
    - the stem's tile: ``tx`` = min(Wo, 64) columns, ``ty`` rows up to 128
      outputs, ``tz`` depths up to 256 outputs;
    - the depthwise tile: ``cs`` = min(Cin, 64) channels; of 1-4 depths and
      1-8 rows whose patch fits 48 KB, the least work on the busiest SM
      (``_dw_cost``) among the tiles that give each SM a CTA, where there are
      such; ``walkers`` one a run of 4 outputs, at most 256 threads; ``vec``
      16 where Cin, cs and ``align`` allow, else 4.
    """
    b, d, h, w, cin = (int(n) for n in shape)
    k, cout = int(wshape[0]), int(wshape[-1])
    strides = _strides(stride)
    od, oh, ow = _out_dims((d, h, w), k, strides)
    depthwise = groups == cin and cin > 1
    if dtype not in IN_DTYPES:
        raise ValueError(f"plan_qconv: x's dtype {dtype}; int8, float32 or bfloat16")
    if variant is None:
        if depthwise:
            variant = "depthwise" if k == 3 and cin % 4 == 0 and align % 4 == 0 else "direct"
        elif cin == 1 and k == 3 and cout <= STEM_MAX_COUT:
            variant = "stem"
        elif dtype == torch.int8 and cin % 16 == 0 and align % 16 == 0:
            variant = "igemm"
        else:
            variant = "direct"
    ok = {"direct": not depthwise or dtype == torch.int8,
          "igemm": not depthwise and dtype == torch.int8 and cin % 16 == 0 and align % 16 == 0,
          "stem": not depthwise and cin == 1 and k == 3 and cout <= STEM_MAX_COUT,
          "depthwise": depthwise and dtype == torch.int8 and k == 3 and cin % 4 == 0
          and align % 4 == 0}
    if not ok.get(variant, False):
        raise ValueError(f"plan_qconv: variant {variant!r} does not take x {tuple(shape)} {dtype},"
                         f" weights {tuple(wshape)}, groups {groups}, {align}-byte alignment")
    m = b * od * oh * ow

    if variant == "direct":
        total = m * cout
        quad = not depthwise and dtype == torch.int8 and cin % 4 == 0 and align % 4 == 0
        return QconvPlan("direct", grid=_cdiv(total, 256), threads=256, vec=4 if quad else 0)

    if variant == "igemm":
        def ctas(name):
            bm, bn = IGEMM_TILES[name][:2]
            return _cdiv(m, bm) * _cdiv(cout, bn)

        if tile is None:
            cands = ["m64n16k4", "m16n16k8"] if cout <= 16 else ["m128n64", "m64n64", "m32n64k4"]
            tile = next((t for t in cands if ctas(t) >= SMS), cands[-1])
        if tile not in IGEMM_TILES:
            raise ValueError(f"plan_qconv: igemm tile {tile!r}; one of {list(IGEMM_TILES)}")
        return QconvPlan("igemm", tile, ctas(tile), igemm_threads(tile), igemm_smem(tile))

    if variant == "stem":
        tx = tx or min(ow, 64)
        ty = ty or min(oh, max(1, 128 // tx))
        tz = tz or min(od, max(1, 256 // (tx * ty)))
        smem = stem_smem(cout, strides, tz, ty, tx)
        if smem > SMEM_MAX:
            raise ValueError(f"plan_qconv: the stem tile {tz}x{ty}x{tx} needs {smem:,} bytes of "
                             f"shared memory, above {SMEM_MAX:,}")
        grid = b * _cdiv(od, tz) * _cdiv(oh, ty) * _cdiv(ow, tx)
        return QconvPlan("stem", grid=grid, threads=STEM_THREADS, smem=smem, tz=tz, ty=ty, tx=tx)

    # depthwise
    fixed = cs is not None
    cs = cs or min(cin, DW_SLICE)
    if cs % 4 or not 4 <= cs <= 4 * DW_THREADS:
        raise ValueError(f"plan_qconv: cs={cs}; a multiple of 4 from 4 to {4 * DW_THREADS}")
    quads, runs, ns = cs // 4, _cdiv(ow, DW_RUN), _cdiv(cin, cs)

    def shape_of(t):
        tzi, tyi = t
        walkers = min(DW_THREADS // quads, tzi * tyi * runs)
        return walkers, b * _cdiv(od, tzi) * _cdiv(oh, tyi) * ns

    def cost(t):
        walkers, n = shape_of(t)
        work = _dw_cost(dw_smem(cs, ow, strides, *t), quads * walkers,
                        _cdiv(t[0] * t[1] * runs, walkers))
        return _cdiv(n, SMS) * work, -t[0] * t[1]

    depths = [tz] if tz else range(1, min(4, od) + 1)
    rows = [ty] if ty else range(1, min(8, oh) + 1)
    limit = SMEM_MAX if (fixed or tz or ty) else SMEM_DEFAULT
    tiles = [(a, c) for a in depths for c in rows if dw_smem(cs, ow, strides, a, c) <= limit]
    if not tiles:
        raise ValueError(f"plan_qconv: no depthwise tile of cs={cs}, tz={tz}, ty={ty} fits "
                         f"x {tuple(shape)}")
    tz, ty = min([t for t in tiles if shape_of(t)[1] >= SMS] or tiles, key=cost)
    walkers, grid = shape_of((tz, ty))
    vec = 16 if cin % 16 == 0 and cs % 16 == 0 and align % 16 == 0 else 4
    return QconvPlan("depthwise", grid=grid, threads=quads * walkers,
                     smem=dw_smem(cs, ow, strides, tz, ty), tz=tz, ty=ty, cs=cs, walkers=walkers,
                     vec=vec)


def _dw_cost(patch_bytes: int, threads: int, items_a_walker: int) -> float:
    """A depthwise CTA's time in a thread's instructions: its patch's 4-byte
    copies spread over its threads, then its busiest walker's runs (27 taps
    x 4 outputs x 4 channels in __dp4a, ~3 instructions an output-tap)."""
    return patch_bytes / (4 * threads) + items_a_walker * 27 * DW_RUN * 3


# ---------------------------------------------------------------- the wrappers
def _check_devices(name, tensors) -> None:
    if not all(t.device.type == "cpu" for t in tensors) and (
            tensors[0].device.type != "cuda" or any(t.device != tensors[0].device
                                                    for t in tensors)):
        raise ValueError(f"{name}: every tensor must be on one CUDA device (or all on the CPU); "
                         f"got {[str(t.device) for t in tensors]}")


def _check_overflow(name, wq) -> None:
    # the int32 sum of one output: at most k^3 x (Cin / groups) products of
    # magnitude <= 128^2 (27 x 1024 x 128^2 < 2^31 at the model's widths)
    k, per_group = wq.shape[0], wq.shape[3]
    if k ** 3 * per_group * QMAX * QMAX >= 2 ** 31:
        raise ValueError(f"{name}: k={k}, Cin/groups={per_group} could overflow int32")


def qconv_cuda(q: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               stride=1, groups: int = 1, relu: bool = False,
               plan: QconvPlan | None = None) -> torch.Tensor:
    """int8 conv + fused epilogue in float32: q (B, D, H, W, Cin) int8, wq
    (k, k, k, Cin / groups, Cout) int8, scale and bias (Cout,) float32 ->
    (B, Do, Ho, Wo, Cout) float32.

    Calls the registered op ``msl::qconv``, so that ``torch.export``
    captures it. On CUDA tensors the op launches the kernel on the current
    stream, without synchronising, and counts the launch in
    ``qconv_cuda.launches``. On CPU tensors it returns :func:`qconv_reference`.
    Anything else raises. ``plan`` forces one of :func:`plan_qconv`'s plans
    (eager calls only: the launch then bypasses the op).
    """
    _check_devices("qconv_cuda", (q, wq, scale, bias))
    _check_overflow("qconv_cuda", wq)
    if plan is not None and q.device.type == "cuda":
        return _launch(q, wq, scale, bias, _strides(stride), groups, relu, "float", plan=plan)
    return torch.ops.msl.qconv(q, wq, scale, bias, list(_strides(stride)), int(groups), bool(relu))


qconv_cuda.launches = 0


def qconv_s32_cuda(q: torch.Tensor, wq: torch.Tensor, stride=1, groups: int = 1,
                   plan: QconvPlan | None = None) -> torch.Tensor:
    """Q1's int32 sums alone, on CUDA tensors (no epilogue): the card's
    counterpart of :func:`qconv_s32`, for holding the kernel's integer
    arithmetic exact. Counts its launch in ``qconv_cuda.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"qconv_s32_cuda: q on {q.device}; CUDA tensors only")
    _check_overflow("qconv_s32_cuda", wq)
    zeros = torch.zeros(wq.shape[-1], dtype=torch.float32, device=q.device)
    return _launch(q, wq, zeros, zeros, _strides(stride), int(groups), False, "sums", plan=plan)


def qconv_codes_cuda(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     sx_out: torch.Tensor, stride=1, groups: int = 1, relu: bool = True,
                     sx_in: torch.Tensor | None = None,
                     plan: QconvPlan | None = None) -> torch.Tensor:
    """int8 conv whose epilogue writes the next convs' int8 codes.

    x: (B, D, H, W, Cin) int8 codes, or a float32 / bf16 image that the
    kernel quantizes as it loads with ``sx_in`` (a 0-d or (1,) float32
    tensor; dense convs only); wq, scale, bias as :func:`qconv_cuda`;
    ``sx_out`` (n,) float32, n 1 or 2. Returns (n, B, Do, Ho, Wo, Cout) int8:
    plane i is ``requantize(y, sx_out[i])`` of the float32 y that
    :func:`qconv_cuda` gives. Calls the registered op ``msl::qconv_codes``
    (CPU tensors: :func:`qconv_codes_reference`); counts in
    ``qconv_cuda.launches``. ``plan`` as in :func:`qconv_cuda`.
    """
    tensors = (x, wq, scale, bias, sx_out) + (() if sx_in is None else (sx_in,))
    _check_devices("qconv_codes_cuda", tensors)
    _check_overflow("qconv_codes_cuda", wq)
    if sx_out.dim() != 1 or sx_out.shape[0] not in (1, 2):
        raise ValueError(f"qconv_codes_cuda: sx_out {tuple(sx_out.shape)}; (1,) or (2,)")
    if x.dtype != torch.int8 and sx_in is None:
        raise ValueError(f"qconv_codes_cuda: a {x.dtype} input needs sx_in to quantize it")
    if plan is not None and x.device.type == "cuda":
        return _launch(x, wq, scale, bias, _strides(stride), groups, relu, "codes",
                       sx_out=sx_out, sx_in=sx_in, plan=plan)
    return torch.ops.msl.qconv_codes(x, wq, scale, bias, list(_strides(stride)), int(groups),
                                     bool(relu), sx_out, sx_in)


def qconv_heads_cuda(q: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     split: int, plan: QconvPlan | None = None):
    """The loc and cls heads of a feature layer in one launch: q (B, D, H,
    W, Cin) int8 codes, wq (k, k, k, Cin, Cout) the heads' weights
    concatenated along Cout, scale and bias (Cout,); stride 1, no ReLU.
    Returns (y[..., :split], y[..., split:]) as two contiguous float32
    tensors. Calls the registered op ``msl::qconv_heads`` (CPU tensors:
    :func:`qconv_heads_reference`); counts in ``qconv_cuda.launches``."""
    _check_devices("qconv_heads_cuda", (q, wq, scale, bias))
    _check_overflow("qconv_heads_cuda", wq)
    if not 0 < split < wq.shape[-1]:
        raise ValueError(f"qconv_heads_cuda: split {split} of Cout {wq.shape[-1]}")
    if plan is not None and q.device.type == "cuda":
        return _launch(q, wq, scale, bias, (1, 1, 1), 1, False, "heads", split=split, plan=plan)
    return torch.ops.msl.qconv_heads(q, wq, scale, bias, int(split))


def _launch(x, wq, scale, bias, stride, groups, relu, mode, *, sx_out=None, sx_in=None, split=0,
            plan=None):
    """Check the operands and launch Q1 on CUDA tensors; ``mode`` is one of
    :data:`MODES`. Returns the output (a tuple of two for ``heads``)."""
    if x.dim() != 5 or wq.dim() != 5 or x.dtype not in IN_DTYPES or wq.dtype != torch.int8:
        raise ValueError(f"qconv: expected x (B, D, H, W, Cin) int8 (or a float32 / bf16 image) "
                         f"and wq (k, k, k, I, O) int8, got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if x.dtype != torch.int8 and mode != "codes":
        raise ValueError(f"qconv: a {x.dtype} input is quantized as it loads only by "
                         "qconv_codes_cuda")
    b, d, h, w, cin = x.shape
    k, cout = wq.shape[0], wq.shape[4]
    depthwise = groups == cin and cin > 1
    if (k not in (1, 3) or wq.shape[:3] != (k, k, k) or groups not in (1, cin)
            or wq.shape[3] != cin // groups or (depthwise and cout != cin)):
        raise ValueError(f"qconv: wq {tuple(wq.shape)} with groups={groups} for Cin={cin}; "
                         "expected a 3^3 or 1^3 kernel, dense (groups 1) or depthwise "
                         "(groups = Cin = Cout)")
    if len(stride) != 3 or any(s not in (1, 2) for s in stride):
        raise ValueError(f"qconv: strides {stride}; 1 or 2 on each axis")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or \
            scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"qconv: scale and bias must be ({cout},) float32")
    for name, s in (("sx_out", sx_out), ("sx_in", sx_in)):
        if s is not None and (s.dtype != torch.float32 or s.numel() not in (1, 2)):
            raise ValueError(f"qconv: {name} must be float32 with 1 or 2 elements")
    x = x.contiguous()
    wk = pack_weights(wq, groups)  # no copy where wq is unpack_weights' view
    scale, bias = scale.contiguous(), bias.contiguous()
    sx_out = None if sx_out is None else sx_out.contiguous()
    sx_in = None if sx_in is None else sx_in.contiguous()
    od, oh, ow = _out_dims((d, h, w), k, stride)
    dims = (b, od, oh, ow)
    ncodes = 0 if sx_out is None else sx_out.numel()
    if mode == "heads":
        result = (torch.empty((*dims, split), dtype=torch.float32, device=x.device),
                  torch.empty((*dims, cout - split), dtype=torch.float32, device=x.device))
        ptr0, ptr1 = result[0].data_ptr(), result[1].data_ptr()
        vec = split % 4 == 0 and (cout - split) % 4 == 0
    elif mode == "codes":
        result = torch.empty((ncodes, *dims, cout), dtype=torch.int8, device=x.device)
        ptr0 = result.data_ptr()
        ptr1 = ptr0 + (ncodes - 1) * (result.numel() // ncodes)  # plane ncodes - 1
        vec = cout % 16 == 0
    else:
        result = torch.empty((*dims, cout), dtype=torch.int32 if mode == "sums" else
                             torch.float32, device=x.device)
        ptr0 = ptr1 = result.data_ptr()
        vec = cout % 4 == 0
    if math.prod(dims) * cout == 0:
        return result
    vec = vec and ptr0 % 16 == 0 and ptr1 % 16 == 0
    align = alignment(x, wk)
    shape, wshape = tuple(x.shape), tuple(wq.shape)
    if plan is None:
        plan = plan_qconv(shape, wshape, tuple(stride), groups, x.dtype, align)
    elif plan != plan_qconv(shape, wshape, tuple(stride), groups, x.dtype, align,
                            variant=plan.variant, tile=plan.tile or None, tz=plan.tz or None,
                            ty=plan.ty or None, tx=plan.tx or None, cs=plan.cs or None):
        raise ValueError(f"qconv: {plan} is not a plan for x {shape} {x.dtype}, weights {wshape}"
                         f", groups {groups}, strides {tuple(stride)} at {align}-byte alignment")
    tile = list(IGEMM_TILES).index(plan.tile) if plan.tile else 0
    launch("qconv", load_library("qconv", **ENTRY_POINTS), "msl_qconv", x.device,
           x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           None if sx_in is None else sx_in.data_ptr(),
           None if sx_out is None else sx_out.data_ptr(), ptr0, ptr1,
           IN_DTYPES[x.dtype], MODES[mode], max(ncodes, 1), int(split), int(relu), int(vec),
           b, d, h, w, cin, od, oh, ow, cout, k, *stride, int(depthwise),
           VARIANTS[plan.variant], tile, plan.tz, plan.ty, plan.tx, plan.cs, plan.walkers,
           plan.vec, int(plan.variant == "direct" and plan.vec == 4), plan.threads, plan.smem)
    qconv_cuda.launches += 1
    return result


def _out_shape(x, wq, stride) -> tuple:
    b, *dims, _ = x.shape
    return (b, *_out_dims(dims, wq.shape[0], stride))


# Q1's three epilogues as registered ops: float32, int8 codes, the two heads
define_op(
    "qconv(Tensor q, Tensor wq, Tensor scale, Tensor bias, SymInt[] stride, SymInt groups, "
    "bool relu) -> Tensor",
    qconv_reference,
    lambda q, wq, scale, bias, stride, groups, relu: _launch(
        q, wq, scale, bias, tuple(stride), groups, relu, "float"),
    lambda q, wq, scale, bias, stride, groups, relu: q.new_empty(
        (*_out_shape(q, wq, stride), wq.shape[-1]), dtype=torch.float32),
)
define_op(
    "qconv_codes(Tensor x, Tensor wq, Tensor scale, Tensor bias, SymInt[] stride, "
    "SymInt groups, bool relu, Tensor sx_out, Tensor? sx_in) -> Tensor",
    lambda x, wq, scale, bias, stride, groups, relu, sx_out, sx_in: qconv_codes_reference(
        x, wq, scale, bias, sx_out, stride, groups, relu, sx_in),
    lambda x, wq, scale, bias, stride, groups, relu, sx_out, sx_in: _launch(
        x, wq, scale, bias, tuple(stride), groups, relu, "codes", sx_out=sx_out, sx_in=sx_in),
    lambda x, wq, scale, bias, stride, groups, relu, sx_out, sx_in: x.new_empty(
        (sx_out.shape[0], *_out_shape(x, wq, stride), wq.shape[-1]), dtype=torch.int8),
)
define_op(
    "qconv_heads(Tensor q, Tensor wq, Tensor scale, Tensor bias, SymInt split) "
    "-> (Tensor, Tensor)",
    qconv_heads_reference,
    lambda q, wq, scale, bias, split: _launch(q, wq, scale, bias, (1, 1, 1), 1, False, "heads",
                                              split=split),
    lambda q, wq, scale, bias, split: tuple(
        q.new_empty((*_out_shape(q, wq, (1, 1, 1)), n), dtype=torch.float32)
        for n in (split, wq.shape[-1] - split)),
)

