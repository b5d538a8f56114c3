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

What bounds it on the card: latency. At the 96^3 headline (input (B, 12,
12, 12, 128), layers 4-7) the pointwise products are ~64 MFLOP a sample,
which the tensor cores finish in microseconds, and the input, the emitted
maps and ~1 MB of weights take a few microseconds to move; what costs is
the chain of dependent steps. ``csrc/tail.cu`` has three kernels, and
:func:`plan_tail` picks one from the shapes:

- ``cluster`` (bfloat16, when a sample's chain fits a cluster's shared
  memory, as at the headline): one launch for the whole chain. A cluster of
  8 CTAs holds one sample; CTA r owns channel slice r of every block's
  activation for every voxel (in a zero halo, so the depthwise taps need
  no bounds checks), computes the depthwise of its slice once, and reads
  the other slices' bf16 depthwise outputs through distributed shared
  memory for the pointwise product on the tensor cores. Only x is read
  from memory and only the emitted maps are written.
- ``block_mma`` (bfloat16, when the chain does not fit): one launch per
  block. A CTA computes the depthwise of 32 output voxels for every input
  channel once, then the product on the tensor cores chunk by chunk of 32
  output channels; the float32 activations between blocks go through memory.
- ``block_f32`` (float32): one launch per block, the product in float32 on
  CUDA cores (TF32 would change the function).

``.launches`` counts every launch of any of them: 1 per forward at the
headline.

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
import math
from dataclasses import dataclass

import torch

from .build import define_op, launch, load_library
from .depthwise import DTYPES, depthwise_taps

# The per-block kernels keep one tile's depthwise result for every input
# channel in shared memory: 8 voxels x C_in float32 in 48 KB (block_f32),
# 32 voxels x C_in bf16 beside a C_in x 32 slice of pw_w (block_mma).
MAX_C_IN = 48 * 1024 // (4 * 8)
SMEM_MAX = 232_448  # a Hopper block's opt-in maximum of shared memory
CLUSTER = 8  # CTAs per sample in the cluster kernel (csrc/tail.cu kCluster)
MAX_CLUSTER_LAYERS = 16  # kMaxLayers


@dataclass(frozen=True)
class TailPlan:
    """How :func:`fused_tail_cuda` runs a chain (see :func:`plan_tail`).

    ``smem`` is the shared memory of one CTA of the largest launch;
    ``slices`` (cluster only) each block's (input, output) channel slice
    width per CTA; ``offsets`` (cluster only) the byte offsets of the CTA's
    buffers: activation, the two depthwise slices, work (x slice, then A and
    B), and the total.
    """

    variant: str  # "cluster", "block_mma" or "block_f32"
    launches: int
    smem: int
    slices: tuple = ()
    offsets: tuple = ()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def channel_slices(c: int) -> list:
    """The [lo, hi) channel range of each CTA of a cluster, for C = c."""
    s = -(-c // CLUSTER)
    return [(min(c, r * s), min(c, (r + 1) * s)) for r in range(CLUSTER)]


def _cluster_layout(spatial, specs) -> tuple:
    """(slices, offsets) of the cluster kernel's shared memory per CTA."""
    act = y = work = 0
    slices = []
    dims = tuple(spatial)
    for i, (cin, cout, stride) in enumerate(specs):
        dims = tuple(_out_size(n, stride) for n in dims)
        vout = math.prod(dims)
        # CTA r owns channels channel_slices(c)[r] = [r * s, (r + 1) * s) & [0, c)
        s_in, s_out = (channel_slices(c)[0][1] for c in (cin, cout))
        slices.append((s_in, s_out))
        if i == 0:  # the x slice, bf16, with a zero halo
            work = math.prod(n + 2 for n in spatial) * s_in * 2
        if i + 1 < len(specs):  # the next block's input slice, float32, with a zero halo
            act = max(act, math.prod(n + 2 for n in dims) * s_out * 4)
        y = max(y, vout * s_in * 2)  # the depthwise slice, bf16
        kpad, mpad, npad = _round_up(cin, 16), _round_up(vout, 16), _round_up(s_out, 16)
        work = max(work, (mpad * (kpad + 8) + kpad * (npad + 8)) * 2)  # A and B
    offsets = [0]
    for size in (act, y, y, work):
        offsets.append(offsets[-1] + _round_up(size, 16))
    return tuple(slices), tuple(offsets)


def _mma_smem(cin: int) -> int:
    kpad = _round_up(cin, 16)
    return (32 * (kpad + 8) + kpad * (32 + 8)) * 2


def plan_tail(dtype: torch.dtype, shape, specs) -> TailPlan:
    """Which kernel runs a chain, with how many launches and how much shared memory.

    ``shape`` is x's (B, C, D, H, W); ``specs`` each block's (C_in, C_out,
    stride). float32 takes ``block_f32``; bfloat16 takes ``cluster`` when the
    chain has at most 16 blocks and one CTA's buffers fit ``SMEM_MAX``, else
    ``block_mma``. Pure Python: it runs without a card.
    """
    if dtype == torch.float32:
        return TailPlan("block_f32", len(specs), max(8 * cin * 4 for cin, _, _ in specs))
    slices, offsets = _cluster_layout(shape[2:], specs)
    if len(specs) <= MAX_CLUSTER_LAYERS and offsets[-1] <= SMEM_MAX:
        return TailPlan("cluster", 1, offsets[-1], slices, offsets)
    return TailPlan("block_mma", len(specs), max(_mma_smem(cin) for cin, _, _ in specs))


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


# csrc/tail.cu's entry points: (argtypes, restype)
ENTRY_POINTS = {
    "msl_tail_block": ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,),
                       ctypes.c_int),
    "msl_tail_cluster": ((ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p),
                         ctypes.c_int),
}


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


WEIGHTS = ("dw_w", "dw_gamma", "dw_beta", "pw_w", "pw_gamma", "pw_beta")  # a block's, in order


def fused_tail_cuda(x: torch.Tensor, layers, emit) -> list:
    """Run a chain of depthwise-separable blocks; returns the maps named in ``emit``.

    x (B, C, D, H, W) float32 or bfloat16 in ``channels_last_3d`` memory.
    Calls the registered op ``msl::fused_tail`` (x, the blocks' weights
    flat in ``WEIGHTS`` order, the strides, the sorted ``emit``), so that
    ``torch.export`` captures it. On CUDA tensors the op launches the
    kernels :func:`plan_tail` picks (one for the whole chain at the
    headline, else one per block) on the current stream, without
    synchronising, and counts each launch in ``fused_tail_cuda.launches``
    (inside an exported program too). On CPU tensors the op returns
    :func:`tail_reference`. Anything else raises.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_tail_cuda: x on {x.device}; CUDA or CPU only")
    weights = [layer[k] for layer in layers for k in WEIGHTS]
    strides = [int(layer["stride"]) for layer in layers]
    return torch.ops.msl.fused_tail(x, weights, strides, sorted(set(emit)))


fused_tail_cuda.launches = 0


def _unflatten(weights, strides) -> list:
    return [dict(zip(WEIGHTS, weights[6 * i: 6 * i + 6]), stride=s) for i, s in enumerate(strides)]


def _launch(x: torch.Tensor, layers, emit) -> list:
    """Check the operands and launch K3 on CUDA tensors."""
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
    cin = x.shape[1]
    for layer in layers:
        if cin > MAX_C_IN:
            raise ValueError(f"fused_tail_cuda: C_in={cin}; the kernel's shared-memory "
                             f"tile takes at most {MAX_C_IN}")
        operands.append(_layer_operands(layer, x, cin))
        cin = operands[-1][3].shape[1]

    specs = [(op[3].shape[0], op[3].shape[1], int(layer["stride"]))
             for op, layer in zip(operands, layers)]
    plan = plan_tail(x.dtype, x.shape, specs)
    cur = x.permute(0, 2, 3, 4, 1)  # (B, D, H, W, C) contiguous
    if plan.variant == "cluster":
        return _run_cluster(cur, operands, specs, emit, plan)
    return _run_blocks(cur, operands, specs, emit)


def _out_shapes(cur: torch.Tensor, specs) -> list:
    b, *dims = cur.shape[:4]
    shapes = []
    for _, cout, stride in specs:
        dims = [_out_size(n, stride) for n in dims]
        shapes.append((b, *dims, cout))
    return shapes


def _run_cluster(cur, operands, specs, emit, plan) -> list:
    """The whole bf16 chain in one launch of the cluster kernel."""
    shapes = _out_shapes(cur, specs)
    maps = {i: torch.empty(shapes[i], dtype=cur.dtype, device=cur.device) for i in sorted(emit)}
    ptrs, dims = [], []
    in_dims = cur.shape[1:4]
    for i, ((dw_w, dw_g, dw_b, pw_w, pw_g, pw_b), (cin, cout, stride)) in enumerate(
            zip(operands, specs)):
        ptrs += [t.data_ptr() for t in (dw_w, dw_g, dw_b, pw_w, pw_g, pw_b)]
        ptrs.append(maps[i].data_ptr() if i in maps else None)
        dims += [cin, cout, stride, *in_dims, *shapes[i][1:4], *plan.slices[i]]
        in_dims = shapes[i][1:4]
    launch("fused_tail_cuda: the cluster kernel", load_library("tail", **ENTRY_POINTS),
           "msl_tail_cluster", cur.device, cur.data_ptr(), (ctypes.c_void_p * len(ptrs))(*ptrs),
           (ctypes.c_int * len(dims))(*dims), len(specs),
           (ctypes.c_int * len(plan.offsets))(*plan.offsets), cur.shape[0])
    fused_tail_cuda.launches += 1
    return [m.permute(0, 4, 1, 2, 3) for m in maps.values()]


def _run_blocks(cur, operands, specs, emit) -> list:
    """One launch per block: block_mma for bf16, block_f32 for float32."""
    dtype, n = cur.dtype, len(specs)
    outs = []
    for i, (op, (cin, cout, stride), shape) in enumerate(zip(operands, specs,
                                                            _out_shapes(cur, specs))):
        b, d_in, h_in, w_in = cur.shape[:4]
        # the float32 activation feeds the next block; an emitted map is
        # in x's dtype, which for float32 x is that same buffer
        chain = emitted = None
        if dtype == torch.float32 or i < n - 1 or i not in emit:
            chain = torch.empty(shape, dtype=torch.float32, device=cur.device)
        if i in emit:
            emitted = (chain if dtype == torch.float32
                       else torch.empty(shape, dtype=dtype, device=cur.device))
        separate = emitted is not None and emitted is not chain
        launch(f"fused_tail_cuda: block {i}", load_library("tail", **ENTRY_POINTS),
               "msl_tail_block", cur.device, cur.data_ptr(), *(t.data_ptr() for t in op),
               chain.data_ptr() if chain is not None else 0,
               emitted.data_ptr() if separate else 0,
               int(i > 0), DTYPES[dtype], b, d_in, h_in, w_in, cin, cout, stride)
        fused_tail_cuda.launches += 1
        if emitted is not None:
            outs.append(emitted.permute(0, 4, 1, 2, 3))
        cur = chain
    return outs


def _tail_fake(x, weights, strides, emit) -> list:
    specs = [(w.shape[0], w.shape[1], s) for w, s in zip(weights[3::6], strides)]
    shapes = _out_shapes(x.permute(0, 2, 3, 4, 1), specs)
    return [x.new_empty(shapes[i]).permute(0, 4, 1, 2, 3) for i in emit]


# K3 as a registered op: the blocks' weights flat, six a block
define_op(
    "fused_tail(Tensor x, Tensor[] weights, SymInt[] strides, SymInt[] emit) -> Tensor[]",
    lambda x, weights, strides, emit: tail_reference(x, _unflatten(weights, strides), emit),
    lambda x, weights, strides, emit: _launch(x, _unflatten(weights, strides), emit),
    _tail_fake,
)
