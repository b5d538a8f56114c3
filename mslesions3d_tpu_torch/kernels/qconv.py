"""int8 3D convolution with int32 accumulation and a fused epilogue: the CUDA kernel Q1 and its plain version.

Q1 is not a TPU kernel. It replaces the int8 convs of
``mslesions3d_tpu/quant.py::_qconv`` (:212-220), which XLA runs as
``conv_general_dilated`` on int8 operands with ``preferred_element_type=
int32``; torch on CUDA has no int8 conv3d. :func:`qconv_cuda` computes
``relu?(float32(conv_s32(q, wq)) * scale[oc] + bias[oc])`` for q (B, D, H,
W, Cin) int8 in NDHWC and wq (k, k, k, Cin / groups, Cout) int8 in DHWIO,
with k 3 or 1, zero padding k // 2, a stride of 1 or 2 on each axis and
``groups`` 1 (dense: the stem, the pointwise convs, the heads) or Cin
(depthwise, Cout = Cin). The output is float32 NDHWC. The requantize step
``clip(round(x / sx))`` runs before, as plain torch (``quant.py``).

What bounds it on the card: at the model's sizes, bytes and a wave's
latency; the int8 operations are far below the tensor cores' rate. The
first version (``csrc/qconv.cu``) runs them on the CUDA cores, one thread an
output element, output channel fastest: dense convs sum channel quads with
``__dp4a`` from weights stored (Cout, k, k, k, Cin) (a scalar loop
where Cin % 4 != 0, as at the stem, or a pointer is not 4-byte aligned);
depthwise convs take one multiply-add a tap. :func:`pack_weights` stores
a model's weights so once (``quant.QuantizedSSD3D``); weights given in
another layout are repacked at every call. Tensor-core int8 products are
the next step (ROADMAP).

:func:`qconv_s32` is the plain integer conv: ``F.conv3d`` in float64 of the
int8 values, rounded to int32, exact since every sum stays far below 2^53.
:func:`qconv_reference` adds the same epilogue, so the kernel and the plain
version agree bit for bit. The wrapper uses the plain version for CPU
tensors only; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

QMAX = 128  # the largest magnitude of an int8 operand


def _strides(stride) -> tuple:
    return tuple(int(s) for s in stride) if isinstance(stride, (tuple, list)) else (int(stride),) * 3


def _out_dims(dims, k: int, strides) -> tuple:
    return tuple((n + 2 * (k // 2) - k) // s + 1 for n, s in zip(dims, strides))


def pack_weights(wq: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """wq (k, k, k, Cin / groups, Cout) int8 as Q1 reads it, contiguous:
    a dense conv's (``groups`` 1) as (Cout, k, k, k, Cin), so a channel quad
    is one word; a depthwise conv's as they are."""
    return wq.contiguous() if groups > 1 else wq.permute(4, 0, 1, 2, 3).contiguous()


def unpack_weights(wk: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """:func:`pack_weights`' result as a (k, k, k, Cin / groups, Cout) view,
    which Q1 reads without a copy."""
    return wk if groups > 1 else wk.permute(1, 2, 3, 4, 0)


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
    """Plain version of Q1."""
    return qconv_epilogue(qconv_s32(q, wq, stride, groups), scale, bias, relu)


def qconv_cuda(q: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               stride=1, groups: int = 1, relu: bool = False) -> torch.Tensor:
    """int8 conv + fused epilogue: q (B, D, H, W, Cin) int8, wq (k, k, k,
    Cin / groups, Cout) int8, scale and bias (Cout,) float32 -> (B, Do, Ho,
    Wo, Cout) float32.

    Calls the registered op ``msl::qconv``, so that ``torch.export``
    captures it. On CUDA tensors the op launches the kernel on the current
    stream, without synchronising, and counts the launch in
    ``qconv_cuda.launches``. On CPU tensors it returns :func:`qconv_reference`.
    Anything else raises.
    """
    tensors = (q, wq, scale, bias)
    if not all(t.device.type == "cpu" for t in tensors) and (
            q.device.type != "cuda" or any(t.device != q.device for t in tensors)):
        raise ValueError("qconv_cuda: q, wq, scale and bias must be on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in tensors]}")
    # the int32 sum of one output: at most k^3 x (Cin / groups) products of
    # magnitude <= 128^2 (27 x 1024 x 128^2 < 2^31 at the model's widths)
    k, per_group = wq.shape[0], wq.shape[3]
    if k ** 3 * per_group * QMAX * QMAX >= 2 ** 31:
        raise ValueError(f"qconv_cuda: k={k}, Cin/groups={per_group} could overflow int32")
    return torch.ops.msl.qconv(q, wq, scale, bias, list(_strides(stride)), int(groups), bool(relu))


qconv_cuda.launches = 0


@torch.library.custom_op("msl::qconv", mutates_args=())
def _qconv_op(q: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              stride: list[int], groups: int, relu: bool) -> torch.Tensor:
    """Q1 as a registered op."""
    if q.device.type == "cpu":
        return qconv_reference(q, wq, scale, bias, stride, groups, relu)
    return _launch(q, wq, scale, bias, stride, groups, relu)


@_qconv_op.register_fake
def _(q, wq, scale, bias, stride, groups, relu):
    b, *dims, _ = q.shape
    return q.new_empty((b, *_out_dims(dims, wq.shape[0], stride), wq.shape[-1]),
                       dtype=torch.float32)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("qconv")
    lib.msl_qconv.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    lib.msl_qconv.restype = ctypes.c_int
    lib.msl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def qconv_s32_cuda(q: torch.Tensor, wq: torch.Tensor, stride=1, groups: int = 1) -> torch.Tensor:
    """Q1's int32 sums alone, on CUDA tensors (no epilogue): the card's
    counterpart of :func:`qconv_s32`, for holding the kernel's integer
    arithmetic exact. Counts its launch in ``qconv_cuda.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"qconv_s32_cuda: q on {q.device}; CUDA tensors only")
    cout = wq.shape[-1]
    zeros = torch.zeros(cout, dtype=torch.float32, device=q.device)
    return _launch(q, wq, zeros, zeros, list(_strides(stride)), int(groups), False, raw=True)


def _launch(q, wq, scale, bias, stride, groups, relu, raw=False) -> torch.Tensor:
    """Check the operands and launch Q1 on CUDA tensors (``raw``: the int32 sums)."""
    if q.dim() != 5 or wq.dim() != 5 or q.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"qconv_cuda: expected q (B, D, H, W, Cin) and wq (k, k, k, I, O) int8, "
                         f"got {tuple(q.shape)} {q.dtype} and {tuple(wq.shape)} {wq.dtype}")
    b, d, h, w, cin = q.shape
    k, cout = wq.shape[0], wq.shape[4]
    depthwise = groups == cin and cin > 1
    if (k not in (1, 3) or wq.shape[:3] != (k, k, k) or groups not in (1, cin)
            or wq.shape[3] != cin // groups or (depthwise and cout != cin)):
        raise ValueError(f"qconv_cuda: wq {tuple(wq.shape)} with groups={groups} for Cin={cin}; "
                         "expected a 3^3 or 1^3 kernel, dense (groups 1) or depthwise "
                         "(groups = Cin = Cout)")
    if any(s not in (1, 2) for s in stride) or len(stride) != 3:
        raise ValueError(f"qconv_cuda: strides {stride}; 1 or 2 on each axis")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or \
            scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"qconv_cuda: scale and bias must be ({cout},) float32")
    q = q.contiguous()
    wk = pack_weights(wq, groups)  # no copy where wq is unpack_weights' view
    scale, bias = scale.contiguous(), bias.contiguous()
    od, oh, ow = _out_dims((d, h, w), k, stride)
    out = torch.empty((b, od, oh, ow, cout), dtype=torch.int32 if raw else torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    quad = not depthwise and cin % 4 == 0 and q.data_ptr() % 4 == 0 and wk.data_ptr() % 4 == 0
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msl_qconv(q.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), b, d, h, w, cin, od, oh, ow, cout, k, *stride,
                            int(depthwise), int(quad), int(relu), int(raw), stream)
    if err != 0:
        raise RuntimeError(f"qconv_cuda: launch failed: {lib.msl_cuda_error_string(err).decode()}")
    qconv_cuda.launches += 1
    return out
