"""The depthwise 3^3 weight gradient (``kernels/dw_wgrad.py``) on the CPU.

* The plain ``depthwise_wgrad`` against ``jax.vjp`` of the JAX package's
  depthwise conv (``jax.lax.conv_general_dilated`` with
  ``feature_group_count=C``, as ``mslesions3d_tpu/models/layers.py`` calls
  it) and against ``aten.convolution_backward``'s weight gradient, on numpy
  inputs from a seed: strides 1 and 2, padding (1, 1, 1) and (0, 1, 1) (a
  depth-split slab), C 32, 64 and 128, float32 and bfloat16 inputs; and so
  for a conv of one input channel into 32 (the stem's, groups 1). The
  three sum the same products in different orders, so they are held within
  float32 rounding of the sum of the products' magnitudes (below); a
  bfloat16 result (JAX's and aten's round their float32 sums once to bf16)
  within that plus one bf16 ulp.
* The wrapper's CPU route adds the plain version into ``grad_w`` bit for
  bit and counts no launch; it refuses what the kernel does not take, on
  the CPU too.
* The planner: the benchmark cell's seven depthwise chunk shapes and the
  stem's fit two CTAs a SM and copy gz 16 bytes at a time (the stem's
  one-channel x a value at a time); block 1's chunk fills at least two
  waves of 132 SMs; any C (odd, and bf16 channels copied 2 bytes at a
  time); wide rows are split; a fixed tile that does not fit raises.
* A torch mirror of the kernel's tiling (the input region each CTA stages,
  with the halo and the zeros outside the volume, its gz tile, a workspace
  row a tile, the rows summed) equals the plain version within float32
  rounding, on the planner's tiles and on forced ragged ones.
* ``_ConvBNReLU``'s training backward, routed as on the card
  (``layers._kernel_wgrad`` shown a card tensor), sends the weight gradient
  of each conv whose groups have one input channel each (depthwise, and one
  input channel into 8) to the wrapper, a chunk at a time, and no other
  conv's (two input channels into 8); its gradients stay within float32
  rounding of the plain ``torch.relu(bn(conv(x)))`` autograd. On CPU
  tensors the route is aten's, as before the kernel: no call.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mslesions3d_tpu_torch.kernels import dw_wgrad
from mslesions3d_tpu_torch.kernels.dw_wgrad import (
    DwWgradPlan,
    depthwise_wgrad,
    depthwise_wgrad_cuda,
    output_size,
    plan_dw_wgrad,
)
from mslesions3d_tpu_torch.models import layers

FMT = torch.channels_last_3d
# the benchmark cell's depthwise convs, one chunk each: (x's shape, stride)
CELL = [((8, 32, 32, 32, 32), 2), ((32, 64, 16, 16, 16), 2), ((64, 128, 8, 8, 8), 1),
        ((64, 128, 8, 8, 8), 2), ((64, 256, 4, 4, 4), 1), ((64, 256, 4, 4, 4), 2),
        ((64, 512, 2, 2, 2), 1)]
STEM = (8, 1, 64, 64, 64)  # the cell's stem, a chunk: one input channel into 32, stride 2
# float32 sums of up to ~10^3 products, in any order: |error| <= n * eps * S
# at worst, where S sums the products' magnitudes; pairwise and blocked
# orders stay far below it. 64 eps of S is a few times what any of the three
# reaches here and far below a dropped or doubled product (~S / n).
EPS32 = 2.0 ** -23
SUM_ROUNDING = 64 * EPS32


def bf16_ulp(v):
    """One bf16 ulp at the magnitude of v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def _inputs(c, spatial, stride, padding, dtype, seed, cx=None):
    """x (N, CX, D, H, W) (CX = C by default) and gz (N, C, ...) of its
    conv's output, numpy float32 rounded to ``dtype``, as torch tensors in
    channels_last_3d memory."""
    rng = np.random.default_rng(seed)
    out = [output_size(v, s, p) for v, s, p in zip(spatial, stride, padding)]
    x = rng.normal(size=(2, cx or c, *spatial)).astype(np.float32)
    gz = rng.normal(size=(2, c, *out)).astype(np.float32)
    tx, tg = (torch.from_numpy(a).to(dtype).contiguous(memory_format=FMT) for a in (x, gz))
    return tx, tg


def _magnitudes(x, gz, stride, padding):
    """S per weight entry: the plain version's sums of |x| |gz|."""
    return depthwise_wgrad(x.float().abs(), gz.float().abs(), stride, padding).double()


def _jax_wgrad(x, gz, stride, padding):
    """jax.vjp of the JAX package's depthwise conv with respect to its
    kernel, as (C, 1, 3, 3, 3) float32."""
    jdt = jnp.float32 if x.dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x.float().permute(0, 2, 3, 4, 1).numpy()).astype(jdt)
    gj = jnp.asarray(gz.float().permute(0, 2, 3, 4, 1).numpy()).astype(jdt)
    c = gz.shape[1]
    kernel = jnp.zeros((3, 3, 3, 1, c), jdt)

    def conv(k):
        return jax.lax.conv_general_dilated(
            xj, k, window_strides=tuple(stride), padding=tuple((p, p) for p in padding),
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), feature_group_count=x.shape[1])

    _, vjp = jax.vjp(conv, kernel)
    (gk,) = vjp(gj)
    return torch.from_numpy(np.array(gk, np.float32)).permute(4, 3, 0, 1, 2)


def _aten_wgrad(x, gz, stride, padding):
    weight = torch.zeros((gz.shape[1], 1, 3, 3, 3), dtype=x.dtype)
    _, gw, _ = torch.ops.aten.convolution_backward(
        gz, x, weight, None, list(stride), list(padding), [1, 1, 1], False, [0, 0, 0],
        x.shape[1], [False, True, False])
    return gw.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)], ids=["pad1", "slab"])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_matches_jax_and_aten(stride, padding, c, dtype):
    _against_jax_and_aten(stride, padding, c, dtype, cx=c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)], ids=["pad1", "slab"])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_one_input_channel_matches_jax_and_aten(stride, padding, dtype):
    _against_jax_and_aten(stride, padding, 32, dtype, cx=1)


def _against_jax_and_aten(stride, padding, c, dtype, cx):
    stride3 = (stride,) * 3
    x, gz = _inputs(c, (8, 8, 8), stride3, padding, dtype, seed=c + stride, cx=cx)
    ours = depthwise_wgrad(x, gz, stride3, padding)
    assert ours.dtype == torch.float32 and ours.shape == (c, 1, 3, 3, 3)
    s = _magnitudes(x, gz, stride3, padding)
    assert float(s.min()) > 0  # every tap sees products
    for theirs in (_jax_wgrad(x, gz, stride3, padding), _aten_wgrad(x, gz, stride3, padding)):
        bound = SUM_ROUNDING * s
        if dtype == torch.bfloat16:  # their float32 sums rounded once to bf16
            bound = bound + torch.from_numpy(bf16_ulp(theirs.numpy())).double()
        error = (ours.double() - theirs.double()).abs()
        assert bool((error <= bound).all()), float((error / bound).max())


def test_wrapper_cpu_route_adds_the_plain_version():
    x, gz = _inputs(8, (6, 6, 6), (1, 1, 1), (1, 1, 1), torch.float32, seed=1)
    start = torch.randn(8, 1, 3, 3, 3)
    grad_w = start.clone()
    launches = depthwise_wgrad_cuda.launches
    depthwise_wgrad_cuda(x, gz, grad_w, (1, 1, 1), (1, 1, 1))
    assert torch.equal(grad_w, start + depthwise_wgrad(x, gz, (1, 1, 1), (1, 1, 1)))
    assert depthwise_wgrad_cuda.launches == launches  # the CPU route launches nothing


def _refused(**change):
    """The wrapper's arguments for a valid (2, 8, 6, 6, 6) stride-1 call,
    with ``change`` applied."""
    x, gz = _inputs(8, (6, 6, 6), (1, 1, 1), (1, 1, 1), torch.float32, seed=2)
    args = dict(x=x, gz=gz, grad_w=torch.zeros(8, 1, 3, 3, 3), stride=(1, 1, 1),
                padding=(1, 1, 1), dilation=(1, 1, 1))
    args.update(change)
    return args


@pytest.mark.parametrize("change", [
    dict(stride=(3, 1, 1)),
    dict(grad_w=torch.zeros(8, 1, 5, 5, 5)),  # a 5^3 kernel
    dict(x=_inputs(8, (6, 6, 6), (1, 1, 1), (1, 1, 1), torch.float32, 2)[0].contiguous()),
    dict(gz=_inputs(8, (6, 6, 6), (1, 1, 1), (1, 1, 1), torch.bfloat16, 2)[1]),
    dict(padding=(2, 1, 1)),
    dict(dilation=(2, 2, 2)),
    dict(grad_w=torch.zeros(8, 1, 3, 3, 3, dtype=torch.bfloat16)),
    dict(gz=torch.zeros(2, 8, 3, 3, 3).contiguous(memory_format=FMT)),  # not the conv's output
    dict(x=torch.zeros(2, 2, 6, 6, 6).contiguous(memory_format=FMT)),  # two input channels
], ids=["stride3", "kernel5", "not_channels_last", "dtype_mismatch", "padding2", "dilation2",
        "grad_w_bf16", "gz_shape", "x_channels"])
def test_wrapper_refuses_on_the_cpu_too(change):
    args = _refused(**change)
    before = args["grad_w"].clone()
    with pytest.raises(ValueError):
        depthwise_wgrad_cuda(**args)
    assert torch.equal(args["grad_w"], before)


def test_wrapper_takes_a_valid_call():
    args = _refused()
    depthwise_wgrad_cuda(**args)
    assert float(args["grad_w"].abs().sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape, stride", CELL, ids=[f"block{i + 1}" for i in range(7)])
def test_plans_of_the_cell(shape, stride, dtype):
    plan = plan_dw_wgrad(dtype, shape, (stride,) * 3)
    n, c = shape[:2]
    e = torch.empty((), dtype=dtype).element_size()
    assert plan.smem <= dw_wgrad.SMEM_TWO_PER_SM and plan.vec == 16
    assert c % plan.cs == 0 and 64 <= plan.cs * e <= 512
    assert plan.threads % 32 == 0 and plan.threads <= dw_wgrad.MAX_THREADS
    assert 3 * (plan.cs // dw_wgrad._cpt(plan.cs)) * plan.p <= plan.threads
    od, oh, ow = (output_size(v, stride, 1) for v in shape[2:])
    assert plan.tiles == (math.ceil(n / plan.tn) * math.ceil(od / plan.td)
                          * math.ceil(oh / plan.th) * math.ceil(ow / plan.tw))
    assert 1 <= plan.ctas <= plan.tiles
    assert plan.ctas * (c // plan.cs) >= dw_wgrad.SMS  # every SM gets a CTA
    assert plan_dw_wgrad(dtype, shape, (stride,) * 3) is plan  # cached


def test_block1_fills_two_waves():
    """Tiles for two waves of 132 SMs, and CTAs that stage a tile while
    they sum the one before (two buffers)."""
    plan = plan_dw_wgrad(torch.float32, CELL[0][0], (2, 2, 2))
    assert plan.tiles * (32 // plan.cs) >= 2 * dw_wgrad.SMS
    assert plan.ctas < plan.tiles
    tile = (plan.tn, plan.td, plan.th, plan.tw)
    assert plan.smem >= 2 * dw_wgrad._buffer(4, plan.cs, plan.cs, tile, (2, 2, 2))


@pytest.mark.parametrize("dtype, xvec", [(torch.float32, 4), (torch.bfloat16, 2)],
                         ids=["float32", "bfloat16"])
def test_plan_of_the_stem(dtype, xvec):
    plan = plan_dw_wgrad(dtype, STEM, (2, 2, 2), channels=32)
    assert plan.smem <= dw_wgrad.SMEM_TWO_PER_SM and plan.vec == 16 and plan.xvec == xvec
    assert plan.ctas * (32 // plan.cs) >= dw_wgrad.SMS
    with pytest.raises(ValueError):
        plan_dw_wgrad(dtype, (8, 2, 64, 64, 64), (2, 2, 2), channels=32)


@pytest.mark.parametrize("dtype, c, vec", [(torch.float32, 6, 8), (torch.float32, 7, 4),
                                           (torch.bfloat16, 7, 2), (torch.bfloat16, 12, 8)])
def test_any_c(dtype, c, vec):
    plan = plan_dw_wgrad(dtype, (2, c, 9, 10, 11), (1, 2, 1))
    e = torch.empty((), dtype=dtype).element_size()
    assert plan.cs == c and plan.vec == vec and (plan.cs * e) // plan.vec <= 32


def test_wide_rows_are_split():
    plan = plan_dw_wgrad(torch.float32, (1, 512, 3, 3, 4000), (1, 1, 1))
    assert plan.tw < 4000 and plan.smem <= dw_wgrad.SMEM_TWO_PER_SM


def test_a_fixed_tile_that_does_not_fit_raises():
    with pytest.raises(ValueError):
        plan_dw_wgrad(torch.float32, (8, 128, 32, 32, 32), (1, 1, 1), cs=128, tn=8, td=8, th=8)


def mirror(x, gz, stride, padding, plan: DwWgradPlan):
    """The kernel's tiling in torch: each tile's staged input region (zeros
    outside the volume) and gz tile, a workspace row of 27 x C sums a CTA
    (its tiles ``cta``, ``cta + ctas``, ... in order), the rows summed.
    Returns (C, 1, 3, 3, 3) float32."""
    xs, gs = x.float().permute(0, 2, 3, 4, 1), gz.float().permute(0, 2, 3, 4, 1)
    n, cx, c = x.shape[0], x.shape[1], gz.shape[1]
    extents, out = x.shape[2:], gz.shape[2:]
    tile = (plan.td, plan.th, plan.tw)
    region = [s * (t - 1) + 3 for s, t in zip(stride, tile)]
    rows = []
    for n0 in range(0, n, plan.tn):
        for od0 in range(0, out[0], plan.td):
            for oh0 in range(0, out[1], plan.th):
                for ow0 in range(0, out[2], plan.tw):
                    o0 = (od0, oh0, ow0)
                    vn = min(plan.tn, n - n0)
                    valid = [min(t, o - a) for t, o, a in zip(tile, out, o0)]
                    staged = torch.zeros((vn, *region, cx))
                    src, dst = [], []
                    for a, s, p, r, size in zip(o0, stride, padding, region, extents):
                        lo = a * s - p
                        first, last = max(lo, 0), min(lo + r, size)
                        src.append(slice(first, last))
                        dst.append(slice(first - lo, last - lo))
                    staged[(slice(None), *dst)] = xs[(slice(n0, n0 + vn), *src)]
                    g = gs[n0:n0 + vn, od0:od0 + valid[0], oh0:oh0 + valid[1],
                           ow0:ow0 + valid[2]]
                    row = torch.empty(27, c)
                    for k in range(27):
                        kd, kh, kw = k // 9, k // 3 % 3, k % 3
                        taps = staged[:, kd: kd + stride[0] * (valid[0] - 1) + 1: stride[0],
                                      kh: kh + stride[1] * (valid[1] - 1) + 1: stride[1],
                                      kw: kw + stride[2] * (valid[2] - 1) + 1: stride[2]]
                        row[k] = (taps * g).sum((0, 1, 2, 3))
                    rows.append(row)
    assert len(rows) == plan.tiles
    ws = torch.zeros(plan.ctas, 27, c)
    for t, row in enumerate(rows):
        ws[t % plan.ctas] += row
    return ws.sum(0).t().reshape(c, 1, 3, 3, 3)


@pytest.mark.parametrize("shape, stride, padding, tile, channels", [
    ((3, 8, 9, 10, 7), (1, 1, 1), (1, 1, 1), None, None),
    ((3, 8, 9, 10, 7), (2, 2, 2), (1, 1, 1), None, None),
    ((3, 8, 10, 9, 7), (2, 1, 2), (0, 1, 1), None, None),
    ((5, 16, 9, 10, 11), (2, 2, 2), (1, 1, 1), dict(cs=8, tn=2, td=2, th=3, tw=4), None),
    ((5, 16, 10, 7, 6), (1, 2, 1), (0, 1, 0), dict(cs=4, tn=3, td=3, th=2, tw=5), None),
    ((4, 12, 8, 8, 8), (1, 1, 1), (1, 1, 1), dict(cs=12, tn=2, td=8, th=8, tw=8), None),
    ((3, 1, 12, 10, 9), (2, 2, 2), (1, 1, 1), None, 16),
    ((3, 1, 9, 10, 12), (1, 2, 2), (0, 1, 1), dict(cs=8, tn=2, td=4, th=2, tw=3), 16),
], ids=["s1", "s2", "slab_mixed", "ragged_s2", "ragged_pad0", "whole", "one_channel",
        "one_channel_ragged"])
def test_mirror_of_the_tiling_equals_the_plain_version(shape, stride, padding, tile, channels):
    c = channels or shape[1]
    x, gz = _inputs(c, shape[2:], stride, padding, torch.float32, seed=sum(shape), cx=shape[1])
    x, gz = (t.repeat(math.ceil(shape[0] / 2), 1, 1, 1, 1)[:shape[0]] for t in (x, gz))
    x = x + 0.25 * torch.arange(shape[0]).view(-1, 1, 1, 1, 1)  # samples differ
    plan = plan_dw_wgrad(torch.float32, shape, stride, padding, channels=channels,
                         **(tile or {}))
    plain = depthwise_wgrad(x, gz, stride, padding)
    error = (mirror(x, gz, stride, padding, plan).double() - plain.double()).abs()
    assert bool((error <= SUM_ROUNDING * _magnitudes(x, gz, stride, padding)).all())


class _Counted:
    def __init__(self, fn):
        self.fn, self.shapes = fn, []

    def __call__(self, x, gz, grad_w, stride, padding, dilation=(1, 1, 1)):
        self.shapes.append((tuple(x.shape), tuple(stride), tuple(padding)))
        assert x.is_contiguous(memory_format=FMT) and gz.is_contiguous(memory_format=FMT)
        return self.fn(x, gz, grad_w, stride, padding, dilation)


def _grads(conv, bn, x, grad_out, plain):
    x = x.clone().requires_grad_()
    out = torch.relu(bn(conv(x))) if plain else layers.conv_bn_relu_train(conv, bn, x)
    return torch.autograd.grad(out, [x, conv.weight, bn.weight, bn.bias], grad_out)


@pytest.mark.parametrize("samples_a_chunk", [1, 5])
@pytest.mark.parametrize("kind", ["depthwise_s1", "depthwise_s2", "one_input_channel", "dense"])
def test_conv_bn_relu_backward_routes_depthwise_weight_gradients(monkeypatch, kind,
                                                                 samples_a_chunk):
    torch.manual_seed(0)
    stride = 2 if kind != "depthwise_s1" else 1
    if kind == "dense":
        conv = nn.Conv3d(2, 8, 3, stride, 1, bias=False)
    elif kind == "one_input_channel":  # the stem's kind
        conv = nn.Conv3d(1, 8, 3, stride, 1, bias=False)
    else:
        conv = nn.Conv3d(8, 8, 3, stride, 1, groups=8, bias=False)
    bn = layers.BatchNorm3d(8)
    bn.train()
    x = torch.randn(5, conv.in_channels, 8, 8, 8).contiguous(memory_format=FMT)
    out = (8 - 1) // stride + 1
    per_sample = max(x[0].numel(), 8 * out ** 3)  # a chunk counts the larger
    monkeypatch.setattr(layers, "CHUNK_ELEMENTS", samples_a_chunk * per_sample)
    counted = _Counted(depthwise_wgrad_cuda)
    monkeypatch.setattr(layers, "depthwise_wgrad_cuda", counted)
    on_card = layers._kernel_wgrad  # the card's route, taken here by the plain version
    monkeypatch.setattr(layers, "_kernel_wgrad",
                        lambda conv, w, x: on_card(conv, w, SimpleNamespace(is_cuda=True)))
    grad_out = torch.randn(5, 8, out, out, out)
    ours = _grads(conv, bn, x, grad_out, plain=False)
    chunks = math.ceil(5 / samples_a_chunk)
    if kind == "dense":
        assert counted.shapes == []
    else:
        assert [s for s, *_ in counted.shapes] == [
            (min(samples_a_chunk, 5 - i), conv.in_channels, 8, 8, 8)
            for i in range(0, 5, samples_a_chunk)]
        assert len(counted.shapes) == chunks
        assert all(sp == [(stride,) * 3, (1, 1, 1)] for _, *sp in counted.shapes)
    plain = _grads(conv, bn, x, grad_out, plain=True)
    reference = _grads(conv.double(), bn.double(), x.double(), grad_out.double(), plain=True)
    for a, b, ref in zip(ours, plain, reference):
        scale = float(ref.abs().max())
        error = float((a.double() - ref).abs().max()) / scale
        plain_error = float((b.double() - ref).abs().max()) / scale
        # float32 rounding: no worse than twice the plain modules' own
        assert error <= max(2 * plain_error, 1e-6), (error, plain_error)


@pytest.mark.parametrize("in_channels, groups, on_card, kernel", [
    (8, 8, True, True), (1, 1, True, True), (2, 1, True, False), (8, 4, True, False),
    (8, 8, False, False), (1, 1, False, False),
], ids=["depthwise", "one_input_channel", "dense", "grouped", "depthwise_cpu", "stem_cpu"])
def test_kernel_route(in_channels, groups, on_card, kernel):
    conv = nn.Conv3d(in_channels, 8, 3, 1, 1, groups=groups, bias=False)
    spec = layers._ConvSpec(conv.stride, conv.padding, conv.dilation, conv.groups)
    x = SimpleNamespace(is_cuda=on_card)
    assert layers._kernel_wgrad(spec, conv.weight, x) is kernel


def test_the_cpu_keeps_atens_weight_gradient(monkeypatch):
    counted = _Counted(depthwise_wgrad_cuda)
    monkeypatch.setattr(layers, "depthwise_wgrad_cuda", counted)
    conv, bn = nn.Conv3d(8, 8, 3, 2, 1, groups=8, bias=False), layers.BatchNorm3d(8)
    bn.train()
    x = torch.randn(3, 8, 8, 8, 8).contiguous(memory_format=FMT)
    _grads(conv, bn, x, torch.randn(3, 8, 4, 4, 4), plain=False)
    assert counted.shapes == []
