"""The fused tail of the MobileNet tower: the CUDA kernel K3 and its plain version.

:func:`fused_tail_cuda` replaces ``mslesions3d_tpu/kernels/tail.py::
fused_tail`` (body ``_tail_kernel`` / ``_dw_block``). It runs a chain of
depthwise-separable blocks at inference, each one
dw 3x3x3 (stride 1 or 2, zero padding 1) + folded BN + ReLU, then pointwise
C_in x C_out + folded BN + ReLU, and returns the outputs of the blocks named
in ``emit``. It rounds where the TPU kernel rounds:

- the depthwise taps sum in float32, and the depthwise output is rounded
  to the weights' dtype (x's dtype) before the pointwise product, which
  accumulates in float32;
- the activations between blocks stay float32;
- only the emitted maps are rounded to x's dtype.

What bounds it on the card: bytes, and launch latency. At the 96^3
headline (input (B, 12, 12, 12, 128), layers 4-7) the pointwise products
are ~64 MFLOP a sample, which the tensor cores would finish in well under a
microsecond at batch 8, while the input, the emitted maps and ~1 MB of
weights take a few microseconds to move. The TPU design keeps four whole
samples and the whole chain in VMEM; one sample's 12^3 x 128 bf16 input
(442 KB) exceeds a Hopper block's 227 KB of shared memory, so here
(``csrc/tail.cu``) each block is one launch. A CUDA block computes a tile of
8 output voxels x 128 output channels: it computes the depthwise result of
its voxels for every input channel into shared memory, rounded as above,
multiplies it by ``pw_w`` in its own body with float32 sums, and writes the
float32 activation (the next block's input, small enough to stay in the
50 MB L2) and, for an emitted block, the map in x's dtype. ``.launches``
counts one per block of the chain: 4 per forward at the headline.

:func:`tail_reference` is the plain version. The wrapper uses it for CPU
tensors only; on a CUDA tensor it launches the kernel or raises. The
depthwise sums equal the kernel's bit for bit; the pointwise sums are taken
in another order (torch.matmul), so the two differ by float32 rounding.

Tensors are the model's (B, C, D, H, W) views in ``channels_last_3d``
memory; ``layers`` holds dicts of ``DepthwiseSeparableBlock.folded_params``:
dw_w (3, 3, 3, C_in), dw_gamma/dw_beta (C_in,) float32, pw_w (C_in, C_out),
pw_gamma/pw_beta (C_out,) float32, stride (1 or 2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library
from .depthwise import DTYPES, depthwise_taps

# The kernel keeps the float32 depthwise result of its 8 output voxels for
# every input channel in at most 48 KB of shared memory.
MAX_C_IN = 48 * 1024 // (4 * 8)


def _out_size(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def tail_reference(x: torch.Tensor, layers, emit) -> list:
    """Plain version: x (B, C, D, H, W) -> the emitted maps, in x's dtype, in order."""
    emit = set(emit)
    wdtype = x.dtype
    cur = x.permute(0, 2, 3, 4, 1).float()
    outs = []
    for i, layer in enumerate(layers):
        acc = depthwise_taps(cur, layer["dw_w"].to(wdtype).float(), int(layer["stride"]))
        y = torch.relu(acc * layer["dw_gamma"].float() + layer["dw_beta"].float())
        z = torch.matmul(y.to(wdtype).float(), layer["pw_w"].to(wdtype).float())
        cur = torch.relu(z * layer["pw_gamma"].float() + layer["pw_beta"].float())
        if i in emit:
            outs.append(cur.to(x.dtype).permute(0, 4, 1, 2, 3))
    return outs


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("tail")
    lib.msl_tail_block.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.msl_tail_block.restype = ctypes.c_int
    lib.msl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _layer_operands(layer: dict, x: torch.Tensor, cin: int) -> tuple:
    """One block's weights as the kernel takes them, checked against x."""
    dw_w = layer["dw_w"].to(x.dtype).contiguous()
    pw_w = layer["pw_w"].to(x.dtype).contiguous()
    vectors = [layer[k].float().contiguous()
               for k in ("dw_gamma", "dw_beta", "pw_gamma", "pw_beta")]
    cout = pw_w.shape[-1] if pw_w.dim() == 2 else -1
    if (dw_w.shape != (3, 3, 3, cin) or pw_w.shape != (cin, cout)
            or [v.shape for v in vectors] != [(cin,), (cin,), (cout,), (cout,)]):
        raise ValueError(
            f"fused_tail_cuda: for C_in={cin} expected dw_w (3, 3, 3, {cin}), pw_w ({cin}, "
            f"C_out) and gamma/beta vectors of C_in, C_in, C_out, C_out; got "
            f"{tuple(dw_w.shape)}, {tuple(pw_w.shape)}, {[tuple(v.shape) for v in vectors]}"
        )
    if any(t.device != x.device for t in (dw_w, pw_w, *vectors)):
        raise ValueError("fused_tail_cuda: every weight must be on x's CUDA device")
    if int(layer["stride"]) not in (1, 2):
        raise ValueError(f"fused_tail_cuda: stride {layer['stride']}; 1 or 2 only")
    return dw_w, vectors[0], vectors[1], pw_w, vectors[2], vectors[3]


def fused_tail_cuda(x: torch.Tensor, layers, emit) -> list:
    """Run a chain of depthwise-separable blocks; returns the maps named in ``emit``.

    x (B, C, D, H, W) float32 or bfloat16 in ``channels_last_3d`` memory.
    On CUDA tensors this launches one kernel per block of the chain on the
    current stream, without synchronising, and counts each launch in
    ``fused_tail_cuda.launches``. On CPU tensors it returns
    :func:`tail_reference`. Anything else raises.
    """
    if x.device.type == "cpu":
        return tail_reference(x, layers, emit)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tail_cuda: x on {x.device}; CUDA or CPU only")
    if x.dim() != 5 or x.dtype not in DTYPES:
        raise ValueError(f"fused_tail_cuda: x must be (B, C, D, H, W) float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("fused_tail_cuda: x must be contiguous in channels_last_3d memory "
                         "(C innermost)")
    emit = set(emit)
    if not layers or not emit <= set(range(len(layers))):
        raise ValueError(f"fused_tail_cuda: emit {sorted(emit)} must name blocks of the "
                         f"{len(layers)}-block chain")
    operands = []
    b, cin = x.shape[:2]
    for layer in layers:
        if cin > MAX_C_IN:
            raise ValueError(f"fused_tail_cuda: C_in={cin}; the kernel's shared-memory "
                             f"tile takes at most {MAX_C_IN}")
        operands.append(_layer_operands(layer, x, cin))
        cin = operands[-1][3].shape[1]

    lib = _library()
    dtype = DTYPES[x.dtype]
    cur = x.permute(0, 2, 3, 4, 1)  # (B, D, H, W, C) contiguous
    outs = []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, ((dw_w, dw_g, dw_b, pw_w, pw_g, pw_b), layer) in enumerate(zip(operands, layers)):
            stride = int(layer["stride"])
            d_in, h_in, w_in, cin = cur.shape[1:]
            cout = pw_w.shape[1]
            shape = (b, _out_size(d_in, stride), _out_size(h_in, stride),
                     _out_size(w_in, stride), cout)
            # the float32 activation feeds the next block; an emitted map is
            # in x's dtype, which for float32 x is that same buffer
            chain = emitted = None
            if x.dtype == torch.float32 or i < len(layers) - 1 or i not in emit:
                chain = torch.empty(shape, dtype=torch.float32, device=x.device)
            if i in emit:
                emitted = (chain if x.dtype == torch.float32
                           else torch.empty(shape, dtype=x.dtype, device=x.device))
            separate = emitted is not None and emitted is not chain
            err = lib.msl_tail_block(
                cur.data_ptr(), dw_w.data_ptr(), dw_g.data_ptr(), dw_b.data_ptr(),
                pw_w.data_ptr(), pw_g.data_ptr(), pw_b.data_ptr(),
                chain.data_ptr() if chain is not None else 0,
                emitted.data_ptr() if separate else 0,
                int(i > 0), dtype, b, d_in, h_in, w_in, cin, cout, stride, stream,
            )
            if err != 0:
                raise RuntimeError(f"fused_tail_cuda: launch of block {i} failed: "
                                   f"{lib.msl_cuda_error_string(err).decode()}")
            fused_tail_cuda.launches += 1
            if emitted is not None:
                outs.append(emitted.permute(0, 4, 1, 2, 3))
            cur = chain
    return outs


fused_tail_cuda.launches = 0
