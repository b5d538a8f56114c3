"""Frozen work counts and the H100's published peaks.

Plain Python on shapes (and, for the NMS, on which candidates are valid):
nothing here imports the program. The bounds are copies of the ones the
port's chip smoke test uses for K1-K3, and the per-volume count of the
SSD3D forward is the layer-plan count of the JAX package's roofline tool,
rewritten against the H100 instead of a TPU.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
"""

from __future__ import annotations

PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float32 operations a pair of candidates costs greedy NMS (the IoU and the test)
NMS_OPS_PER_PAIR = 18
# float32 operations an output element of a depthwise 3^3 conv + BN + ReLU costs
DW_OPS_PER_ELEMENT = 57

# SSD3D's truncated MobileNet: stem channels, then (channels, repeats, stride)
MOBILENET = (32, ((64, 1, 2), (128, 2, 2), (256, 2, 2), (512, 6, 2), (1024, 2, 1)))


def bound(ops_by_peak: dict, nbytes: float) -> tuple[float, str]:
    """(bound seconds, what bounds it): the larger of the bytes over the memory
    rate and each kind of operations over its peak rate."""
    bytes_s = nbytes / PEAK_BYTES_PER_S
    ops_s = max((ops / peak for peak, ops in ops_by_peak.items()), default=0.0)
    return max(bytes_s, ops_s), ("operations" if ops_s > bytes_s else "bytes")


def nms_bound(n_rows: int, k: int, last_valid: list) -> tuple[float, str]:
    """Greedy NMS over ``n_rows`` rows of ``k`` candidates sorted by score;
    ``last_valid`` holds each row's 1-based position of its last valid
    candidate (0: none). Only the pairs above that position are counted, as
    the kernel skips the rest; boxes and validity are read once, the keep
    mask written once."""
    ops = sum(last * (last - 1) / 2 for last in last_valid) * NMS_OPS_PER_PAIR
    nbytes = n_rows * k * (6 * 4 + 1) + n_rows * k
    return bound({PEAK_FP32_FLOPS: ops}, nbytes)


def dw_bound(shape, elem_bytes: int) -> tuple[float, str]:
    """A depthwise 3^3 conv + folded BN + ReLU at stride 1 on an (N, C, D, H, W)
    input: the input read once, the output written once, the weights and the
    folded BN once."""
    n = 1
    for s in shape:
        n *= s
    c = shape[1]
    nbytes = 2 * n * elem_bytes + 27 * c * elem_bytes + 2 * c * 4
    return bound({PEAK_FP32_FLOPS: n * DW_OPS_PER_ELEMENT}, nbytes)


def tail_bound(shape, elem_bytes: int, blocks, emit) -> tuple[float, str]:
    """A chain of depthwise-separable blocks on an (N, C, D, H, W) input.
    ``blocks``: (cin, cout, stride) each; ``emit``: the indices of the blocks
    whose output is written. Bytes: the input in, the emitted maps out, the
    weights and folded BN once. Operations: the depthwise and epilogue work
    in float32, the pointwise products on the bf16 tensor cores (2-byte
    inputs) or in float32."""
    b, dims = shape[0], list(shape[2:])
    nbytes = b * shape[1] * dims[0] * dims[1] * dims[2] * elem_bytes
    fp32_ops, pw_ops = 0, 0
    for i, (cin, cout, stride) in enumerate(blocks):
        dims = [(d - 1) // stride + 1 for d in dims]
        vox = b * dims[0] * dims[1] * dims[2]
        fp32_ops += vox * cin * DW_OPS_PER_ELEMENT + vox * cout * 3
        pw_ops += vox * cin * cout * 2
        nbytes += (27 * cin + cin * cout) * elem_bytes + 2 * (cin + cout) * 4
        if i in emit:
            nbytes += vox * cout * elem_bytes
    if elem_bytes == 4:
        return bound({PEAK_FP32_FLOPS: fp32_ops + pw_ops}, nbytes)
    return bound({PEAK_FP32_FLOPS: fp32_ops, PEAK_BF16_TENSOR_FLOPS: pw_ops}, nbytes)


def layer_plan(feature_layers=(3, 5, 7), width_mult: float = 1.0) -> list:
    """[(kind, channels, stride)] of the tower up to its last feature layer."""
    stem, groups = MOBILENET
    plan = [("stem", int(stem * width_mult), 2)]
    for channels, repeats, stride in groups:
        for i in range(repeats):
            if len(plan) - 1 == max(feature_layers):
                return plan
            plan.append(("dw_block", int(channels * width_mult), stride if i == 0 else 1))
    return plan


def forward_count(volume, in_channels: int = 1, width_mult: float = 1.0,
                  boxes_per_location: int = 2, n_classes: int = 2,
                  feature_layers=(3, 5, 7), elem_bytes: int = 2) -> tuple[float, float]:
    """(FLOPs, activation bytes) of one volume's SSD3D forward: 2 x the
    multiply-accumulates of every conv (stem 3^3, depthwise 3^3, pointwise,
    the 3^3 loc + cls heads of each feature layer, one box a ratio of 1.0 and
    ``boxes_per_location`` in all); bytes: the input read once and every
    activation and head output written once."""
    dims = list(volume)
    cin = in_channels
    macs = 0
    act = elem_bytes * in_channels * dims[0] * dims[1] * dims[2]
    voxels, channels = {}, {}
    for i, (kind, cout, stride) in enumerate(layer_plan(feature_layers, width_mult)):
        dims = [(d - 1) // stride + 1 for d in dims]
        vox = dims[0] * dims[1] * dims[2]
        if kind == "stem":
            macs += vox * cout * cin * 27
        else:
            macs += vox * cin * 27 + vox * cout * cin
        act += elem_bytes * vox * cout
        voxels[i], channels[i] = vox, cout
        cin = cout
    per_box = 6 + n_classes
    for layer in feature_layers:
        macs += voxels[layer] * channels[layer] * boxes_per_location * per_box * 27
        act += elem_bytes * voxels[layer] * boxes_per_location * per_box
    return 2.0 * macs, float(act)


def dw_conv_bound(shape, stride: int, elem_bytes: int) -> tuple[float, str]:
    """A depthwise 3^3 conv alone (padding 1) on an (N, C, D, H, W) input:
    the input read once, the output written once, the weights once; 27
    multiply-adds an output element in float32."""
    n, c = shape[0], shape[1]
    out = [(d - 1) // stride + 1 for d in shape[2:]]
    vin = n * c * shape[2] * shape[3] * shape[4]
    vout = n * c * out[0] * out[1] * out[2]
    nbytes = (vin + vout + 27 * c) * elem_bytes
    return bound({PEAK_FP32_FLOPS: 54 * vout}, nbytes)


def share(bound_s: float, device_s: float):
    """A roofline share in percent; None where nothing ran."""
    return None if device_s <= 0 else 100.0 * bound_s / device_s
