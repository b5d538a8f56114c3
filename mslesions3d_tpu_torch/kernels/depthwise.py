"""Fused depthwise 3x3x3 conv + folded BN + ReLU: the CUDA kernel K2 and its plain version.

:func:`fused_depthwise_bn_relu_cuda` replaces ``mslesions3d_tpu/kernels/
depthwise.py::fused_depthwise_bn_relu`` (body ``_dw_kernel``). It computes
relu(dwconv3x3x3(x) * gamma + beta) at stride 1 with zero padding 1: the 27
taps are summed in float32 in (kd, kh, kw) order, the folded BN affine and
the ReLU are applied in float32, and the result is rounded once to x's
dtype. (The unfused block rounds twice, after the conv and after the BN.)

What bounds it on the card: bytes. Each input element is read once and
each output written once; the 27 multiply-adds per element are about 57
float32 operations, far below the card's operations-per-byte balance.
The kernel (``csrc/depthwise.cu``): one thread per pair of channels, with
its 27 weight pairs and its gamma/beta pair in registers, walking a strip of
voxels; neighbouring threads read neighbouring channel pairs, so every tap
is a coalesced 4-byte (bf16) or 8-byte (float32) load. The TPU kernel's
three row views of depth d-1, d, d+1 become reads through L1/L2; its masked
clamped rows become zero taps. At the model's sizes (a few MB) the launch
latency dominates the time.

:func:`depthwise_bn_relu` is the plain version, summing the 27 shifted
zero-padded slices in the kernel's order, so the two agree bit for bit. The
wrapper uses it for CPU tensors only; on a CUDA tensor it launches the
kernel or raises.

Tensors are the model's (B, C, D, H, W) views in ``channels_last_3d``
memory: C is contiguous, as the kernel wants.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("depthwise")
    lib.msl_depthwise_bn_relu.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.msl_depthwise_bn_relu.restype = ctypes.c_int
    lib.msl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_depthwise_bn_relu_cuda(x: torch.Tensor, weights: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor) -> torch.Tensor:
    """relu(dwconv3x3x3(x) * gamma + beta), stride 1, zero padding 1.

    x (B, C, D, H, W) float32 or bfloat16 in ``channels_last_3d`` memory;
    weights (3, 3, 3, C) in x's dtype; gamma, beta (C,) float32. On CUDA
    tensors this launches the kernel on the current stream, without
    synchronising, and counts the launch in
    ``fused_depthwise_bn_relu_cuda.launches``. On CPU tensors it returns
    :func:`depthwise_bn_relu`. Anything else raises.
    """
    tensors = (x, weights, gamma, beta)
    if all(t.device.type == "cpu" for t in tensors):
        return depthwise_bn_relu(x, weights, gamma, beta)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(
            "fused_depthwise_bn_relu_cuda: x, weights, gamma and beta must be on one CUDA "
            f"device (or all on the CPU); got {[str(t.device) for t in tensors]}"
        )
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
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msl_depthwise_bn_relu(
            x.data_ptr(), weights.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), DTYPES[x.dtype], b, d, h, w, c, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_depthwise_bn_relu_cuda: launch failed: "
            f"{lib.msl_cuda_error_string(err).decode()}"
        )
    fused_depthwise_bn_relu_cuda.launches += 1
    return out


fused_depthwise_bn_relu_cuda.launches = 0
