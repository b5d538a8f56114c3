"""Building blocks of the MobileNet and ConvNet backbones, NCDHW tensors.

Counterpart of ``mslesions3d_tpu/models/layers.py``. Tensors inside the
model are (N, C, D, H, W) views in ``torch.channels_last_3d`` memory, which
is the JAX package's NDHWC layout in memory. Conv weights live in the
compute dtype; BatchNorm runs in float32 and casts back, as in the JAX
package. Module and parameter names follow the reference ``state_dict``
schema (stem ``<i>.0`` / ``<i>.1``, blocks ``conv1, bn1, conv2, bn2``), so
reference checkpoints load with ``load_state_dict``.

Inputs arrive in the compute dtype (``SSD3D`` casts the images once), and
every block returns it. In training mode BatchNorm normalises with the
batch statistics and moves its running statistics by
``0.9 * old + 0.1 * batch`` with the *biased* batch variance, as the JAX
package does (a stock ``nn.BatchNorm3d`` moves them with the unbiased one).

In training every conv + BN + ReLU runs through :func:`conv_bn_relu_train`,
in chunks of samples, keeping no float32 activation for the backward.
:func:`checkpointed` runs a block with its activations recomputed in the
backward pass rather than kept (the JAX package's ``remat``).

Inside ``parallel.data_parallel(mesh)`` (a data-parallel train step) the
training BatchNorm takes its statistics over the global batch, summed over
the mesh's ranks, as the JAX package's sharded program does, and the
ConvNet's dropout draws the global batch's mask and keeps this rank's rows.
Under a data x spatial mesh (``parallel/spatial.py``) each rank holds a depth
slab: every 3^3 conv and the max-pool take their neighbours' boundary planes
(``parallel.collectives.halo``) and run with depth padding 0, instance norm
sums over the spatial group, dropout keeps the rank's slab of the global
mask, and :func:`run_tower` gathers the depth at the cut.

Under a data x spatial x model mesh (``parallel/tensor.py``) each rank holds
its slice of the sharded parameters, and the layers read from the weights'
shapes, against the module's whole ones, how the channels lie
(:func:`model_conv_input`): a conv whose output channels are sharded takes
every input channel (gathered over the model group) and gives its slice; a
depthwise conv works on its slice of the channels with no communication; a
conv whose input channels are sharded sums its partial output over the
group; BatchNorm, instance norm, the max-pool and the ReLU are per channel
and stay local. The heads' outputs come back whole.
"""

from __future__ import annotations

import collections
import contextlib
import math

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..kernels.depthwise import fold_bn, fused_depthwise_bn_relu_cuda
from ..kernels.dw_wgrad import depthwise_wgrad_cuda
from ..parallel.collectives import (
    all_reduce_sum,
    channel_slice,
    copy_to_model,
    current_depth,
    current_model,
    current_split,
    current_stats_group,
    differentiable_all_reduce_sum,
    gather_channels,
    gather_depth,
    halo,
    past_the_cut,
    reduce_partial,
    scatter_channels,
    under_split,
)
from ..utils.profiling import phases

INIT_SCHEMES = ("torch", "flax", "kaiming_relu")
# standard deviation of a standard normal truncated to (-2, 2)
TRUNCATED_NORMAL_STD = 0.87962566103423978


def torch_uniform_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator,
                   gain: float = 1.0) -> None:
    """Fill with U(-gain/sqrt(fan_in), gain/sqrt(fan_in)); gain 1 is torch's
    default Conv3d init.

    The values are drawn in float32 and then rounded to the tensor's dtype,
    as the JAX package rounds its float32 params at use.
    """
    bound = gain / math.sqrt(fan_in)
    values = torch.empty(tensor.shape, dtype=torch.float32, device=tensor.device)
    values.uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        tensor.copy_(values)


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated to 2 standard deviations,
    scaled to variance 1 / fan_in; drawn in float32, then rounded."""
    values = torch.empty(tensor.shape, dtype=torch.float32, device=tensor.device)
    nn.init.trunc_normal_(values, 0.0, 1.0, -2.0, 2.0, generator=generator)
    values *= math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD
    with torch.no_grad():
        tensor.copy_(values)


def init_conv_(conv: nn.Conv3d, generator: torch.Generator, scheme: str = "torch") -> None:
    """One conv under an init scheme, from an explicit generator.

    "torch": U(+-1/sqrt(fan_in)) weights and biases (torch's defaults, the
    reference's init). "flax": lecun-normal weights, zero biases.
    "kaiming_relu": U(+-sqrt(6/fan_in)) weights, zero biases (the JAX
    package's legacy override, ``train/state.py::kaiming_init_overrides``).
    fan_in = C_in / groups x prod(kernel) in every scheme.
    """
    fan_in = conv.weight.shape[1] * math.prod(conv.weight.shape[2:])
    if scheme == "torch":
        torch_uniform_(conv.weight, fan_in, generator)
        if conv.bias is not None:
            torch_uniform_(conv.bias, fan_in, generator)
        return
    if scheme == "flax":
        lecun_normal_(conv.weight, fan_in, generator)
    elif scheme == "kaiming_relu":
        torch_uniform_(conv.weight, fan_in, generator, gain=math.sqrt(6.0))
    else:
        raise ValueError(f"unknown init_scheme {scheme!r}; known: {INIT_SCHEMES}")
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()


class BatchNorm3d(nn.Module):
    """BatchNorm over the channel axis 1, in float32, cast back to the input dtype.

    Eval mode: y = (x32 - mean) * rsqrt(var + eps) * weight + bias with the
    running statistics. Training mode normalises with the batch's float32
    mean and biased variance and moves the running statistics by
    ``momentum * old + (1 - momentum) * batch``. Two variants, as in the JAX
    package: the blocks' BN (the JAX package's own ``BatchNorm3d``) takes the
    variance centred on the batch mean and applies rsqrt, then weight; the
    stem's BN (flax's ``nn.BatchNorm``, ``fast_variance=True``) takes
    max(E[x^2] - E[x]^2, 0) and applies rsqrt(var + eps) * weight as one
    factor. Buffers carry torch's names, ``num_batches_tracked`` included
    (training leaves it alone), so reference checkpoints load strictly.
    """

    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.9,
                 fast_variance: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.fast_variance = fast_variance
        # off while checkpointed() recomputes the block: the first pass moved
        # the running statistics already
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def _channel(self, v: torch.Tensor) -> torch.Tensor:
        return v.view(1, -1, 1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        x32 = x.float()
        y = (x32 - self._channel(self.running_mean)) * self._channel(
            torch.rsqrt(self.running_var + self.epsilon)
        ) * self._channel(self.weight) + self._channel(self.bias)
        return y.to(x.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        dims = (0, 2, 3, 4)
        mesh = current_stats_group()
        if mesh is not None:  # the global batch's statistics: sums over the ranks
            count = x32.numel() // x32.shape[1] * mesh.size
            c = x32.shape[1]
            if self.fast_variance:
                sums = differentiable_all_reduce_sum(
                    torch.cat([x32.sum(dims), (x32 * x32).sum(dims)]), mesh) / count
                mean = sums[:c]
                var = torch.clamp(sums[c:] - mean * mean, min=0.0)
            else:
                mean = differentiable_all_reduce_sum(x32.sum(dims), mesh) / count
                var = differentiable_all_reduce_sum(
                    ((x32 - self._channel(mean)) ** 2).sum(dims), mesh) / count
        elif self.fast_variance:
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
        else:
            var, mean = torch.var_mean(x32, dims, correction=0)
        if self.update_stats:
            self.move_running_statistics(mean, var)
        return self.normalise(x32, mean, var, self.weight, self.bias).to(x.dtype)

    def move_running_statistics(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1 - keep) * var)

    def normalise(self, x32: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The float32 affine of training mode on the given batch statistics."""
        centred = x32 - self._channel(mean)
        if self.fast_variance:
            y = centred * self._channel(torch.rsqrt(var + self.epsilon) * weight)
        else:
            y = centred * self._channel(torch.rsqrt(var + self.epsilon)) * self._channel(weight)
        return y + self._channel(bias)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(gamma, beta) of the inference-time affine y = x * gamma + beta."""
        return fold_bn(self.weight, self.bias, self.running_mean, self.running_var,
                       self.epsilon)


class ConvBNReLU(nn.Sequential):
    """Conv3d(k3, stride, explicit padding 1 at every stride, no bias) + BN + ReLU.

    Children ``0`` (conv) and ``1`` (BN) give the reference stem's keys. The
    BN is flax's ``nn.BatchNorm`` in the JAX package: the fast variance.
    """

    def __init__(self, in_features: int, features: int, strides=1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            nn.Conv3d(in_features, features, 3, stride=strides, padding=1,
                      bias=False, dtype=dtype),
            BatchNorm3d(features, fast_variance=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self[0], self[1]
        if self.training:
            return conv_bn_relu_train(conv, bn, x)
        return torch.relu(bn(conv3d(conv, x)))


class DepthwiseSeparableBlock(nn.Module):
    """Depthwise 3x3x3 conv + BN + ReLU, then pointwise 1x1x1 conv + BN + ReLU.

    ``use_pallas`` sends the depthwise half to the fused kernel K2
    (``kernels/depthwise.py``) at inference, under the JAX package's
    condition: eval mode, stride 1 and C_in % 128 == 0. The parameters are
    the same either way.
    """

    def __init__(self, in_features: int, features: int, strides=1,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False):
        super().__init__()
        self.strides = tuple(strides) if isinstance(strides, (tuple, list)) else (strides,) * 3
        self.use_pallas = use_pallas
        self.conv1 = nn.Conv3d(in_features, in_features, 3, stride=strides,
                               padding=1, groups=in_features, bias=False, dtype=dtype)
        self.bn1 = BatchNorm3d(in_features)
        self.conv2 = nn.Conv3d(in_features, features, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm3d(features)

    def _dw_weights(self) -> torch.Tensor:
        """conv1's (C, 1, 3, 3, 3) kernel as (3, 3, 3, C), in the compute dtype."""
        c = self.conv1.weight.shape[0]
        return self.conv1.weight.permute(2, 3, 4, 1, 0).reshape(3, 3, 3, c).contiguous()

    def folded_params(self) -> dict:
        """The block's inference parameters for the fused tail kernel (K3)."""
        dw_gamma, dw_beta = self.bn1.folded()
        pw_gamma, pw_beta = self.bn2.folded()
        cout, cin = self.conv2.weight.shape[:2]
        return {
            "dw_w": self._dw_weights(),
            "dw_gamma": dw_gamma, "dw_beta": dw_beta,
            "pw_w": self.conv2.weight.reshape(cout, cin).t().contiguous(),
            "pw_gamma": pw_gamma, "pw_beta": pw_beta,
            "stride": self.strides[0],
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = (self.use_pallas and not self.training and self.strides == (1, 1, 1)
                 and self.conv1.in_channels % 128 == 0)
        if fused:
            gamma, beta = self.bn1.folded()
            depth = current_depth()
            # depth-split: K2 on the haloed slab (planes + 2), its middle planes kept
            x = x if depth is None else halo(x, depth, 1, 1)
            # channel-split: K2 on this rank's slice of the channels
            x = model_conv_input(self.conv1, x)[0]
            x = fused_depthwise_bn_relu_cuda(
                x.contiguous(memory_format=torch.channels_last_3d), self._dw_weights(),
                gamma, beta,
            )
            x = x if depth is None else x[:, :, 1:-1]
        elif self.training:
            x = conv_bn_relu_train(self.conv1, self.bn1, x)
        else:
            x = torch.relu(self.bn1(conv3d(self.conv1, x)))
        if self.training:
            return conv_bn_relu_train(self.conv2, self.bn2, x)
        return torch.relu(self.bn2(conv3d(self.conv2, x)))


# elements of the conv's input or output (the larger) that one chunk of a
# training conv + BN + ReLU works on at a time: its float32 temporaries are
# 32 MiB each, and what cuDNN allocates in a strided depthwise conv's
# backward (several times its input) shrinks with the chunk
CHUNK_ELEMENTS = 1 << 23


class _ConvBNReLU(torch.autograd.Function):
    """relu(bn(conv(x))) in training: BN on the batch statistics, in float32,
    with no float32 activation kept for the backward.

    The conv and its output z run in chunks of samples: the statistics in
    one pass over the chunks (two for the centred variance), the
    normalisation and ReLU in another, so no float32 tensor is ever whole. The backward keeps ``x``, the per-channel statistics and, when
    ``keep`` is set, z (in the compute dtype); it recomputes the ReLU mask
    and the normalised input chunk by chunk, sums the two per-channel terms
    of BN's backward in one pass and forms the gradients of the conv in a
    second: on the card the weight gradient of a conv whose groups have one
    input channel each (a depthwise conv, or the stem's one input channel)
    by ``kernels.dw_wgrad`` (:func:`_kernel_wgrad`; a launch a chunk, each
    marked ``msl.train.dw_wgrad``), every other gradient by
    ``aten.convolution_backward``. With
    ``keep`` off (remat of the stem) z is not kept either: the conv is
    recomputed chunk by chunk, chunk for chunk the same as in the forward,
    so the numbers do not depend on ``keep``. The running statistics move in
    the forward, unless the BN's ``update_stats`` is off.

    Under a data mesh (``parallel.data_parallel``) every rank holds as many
    samples (and, depth-split, as many planes), and the per-channel sums
    are summed over the split's statistics view, so ``count`` is the global
    voxels': the count
    and sum of z (and the fast variance's sum of squares) in one reduction,
    the centred sum of squares in a second, after the global mean; in the
    backward the two sums of BN's gradient. The gradients of gamma and beta
    stay this rank's sums: the step sums every gradient over the ranks.
    """

    @staticmethod
    def forward(ctx, x, weight, gamma, beta, conv, bn, keep):
        n, c = x.shape[0], weight.shape[0]
        spatial = [(size + 2 * p - d * (k - 1) - 1) // s + 1 for size, k, s, p, d in zip(
            x.shape[2:], weight.shape[2:], conv.stride, conv.padding, conv.dilation)]
        chunks = _chunks(n, max(x[0].numel(), c * math.prod(spatial)))
        shape, fmt = (n, c, *spatial), torch.channels_last_3d
        z = None
        if keep:
            z = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)
            for sl in chunks:
                z[sl] = _conv(conv, x[sl], weight)
        mesh = current_stats_group()
        ctx.conv, ctx.bn, ctx.chunks, ctx.mesh = conv, bn, chunks, mesh
        ctx.count = n * math.prod(spatial) * (1 if mesh is None else mesh.size)
        dims = (0, 2, 3, 4)
        total = torch.zeros(c, dtype=torch.float32, device=x.device)
        squares = torch.zeros_like(total)
        for sl in chunks:
            z32 = _chunk_z(conv, x, weight, z, sl).float()
            total += z32.sum(dims)
            if bn.fast_variance:
                squares += (z32 * z32).sum(dims)
        if bn.fast_variance:
            total, squares = all_reduce_sum([total, squares], mesh)
        else:
            (total,) = all_reduce_sum([total], mesh)
        mean = total / ctx.count
        if bn.fast_variance:
            raw_var = squares / ctx.count - mean * mean
        else:
            for sl in chunks:
                centred = _chunk_z(conv, x, weight, z, sl).float() - bn._channel(mean)
                squares += (centred * centred).sum(dims)
            (squares,) = all_reduce_sum([squares], mesh)
            raw_var = squares / ctx.count
        var = torch.clamp(raw_var, min=0.0)
        if bn.update_stats:
            bn.move_running_statistics(mean, var)
        out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)
        for sl in chunks:
            z32 = _chunk_z(conv, x, weight, z, sl).float()
            out[sl] = torch.relu(bn.normalise(z32, mean, var, gamma, beta).to(x.dtype))
        ctx.save_for_backward(x, weight, gamma, beta, mean, var, raw_var >= 0, z)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, gamma, beta, mean, var, var_grad, z = ctx.saved_tensors
        conv, bn = ctx.conv, ctx.bn
        dims = (0, 2, 3, 4)
        rstd = torch.rsqrt(var + bn.epsilon)
        zero = torch.zeros((), dtype=grad.dtype, device=grad.device)

        def recompute(sl):
            """(the normalised input, the ReLU-masked gradient) of a chunk, in float32."""
            z32 = _chunk_z(conv, x, weight, z, sl).float()
            y = bn.normalise(z32, mean, var, gamma, beta).to(x.dtype)
            g = torch.where(y > 0, grad[sl], zero).float()
            return (z32 - bn._channel(mean)) * bn._channel(rstd), g

        sum_g = torch.zeros_like(mean)
        sum_gx = torch.zeros_like(mean)
        for sl in ctx.chunks:
            xhat, g = recompute(sl)
            sum_g += g.sum(dims)
            sum_gx += (g * xhat).sum(dims)
        all_g, all_gx = all_reduce_sum([sum_g, sum_gx], ctx.mesh)
        mean_g = bn._channel(all_g / ctx.count)
        mean_gx = bn._channel(torch.where(var_grad, all_gx / ctx.count, 0.0))
        scale = bn._channel(gamma.float() * rstd)
        need_x = ctx.needs_input_grad[0]
        grad_x = torch.empty_like(x) if need_x and len(ctx.chunks) > 1 else None
        grad_w = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
        kernel = _kernel_wgrad(conv, weight, x)
        fmt = torch.channels_last_3d
        for sl in ctx.chunks:
            xhat, g = recompute(sl)
            gz = (scale * (g - mean_g - xhat * mean_gx)).to(x.dtype)
            if need_x or not kernel:
                gx, gw, _ = torch.ops.aten.convolution_backward(
                    gz, x[sl], weight, None, conv.stride, conv.padding, conv.dilation, False,
                    [0, 0, 0], conv.groups, [need_x, not kernel, False])
            if kernel:
                with phases("msl.train.dw_wgrad"):
                    depthwise_wgrad_cuda(x[sl].contiguous(memory_format=fmt),
                                         gz.contiguous(memory_format=fmt), grad_w, conv.stride,
                                         conv.padding, conv.dilation)
            else:
                grad_w += gw.float()
            if grad_x is not None:
                grad_x[sl] = gx
            elif need_x:  # one chunk
                grad_x = gx
        return (grad_x, grad_w.to(weight.dtype), sum_gx.to(gamma.dtype),
                sum_g.to(beta.dtype), None, None, None)


def _kernel_wgrad(conv, weight: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether :class:`_ConvBNReLU`'s weight gradient goes to ``kernels.dw_wgrad``:
    on the card, for a conv of one input channel a group (depthwise, or one
    input channel for all outputs). The CPU keeps aten's, so its numbers are
    the ones the port has always had."""
    return x.is_cuda and weight.shape[1] == 1 and conv.groups in (1, weight.shape[0])


def _chunks(n: int, per_sample: int) -> list:
    """Slices of the batch's ``n`` samples, ``CHUNK_ELEMENTS // per_sample`` a chunk."""
    step = max(1, CHUNK_ELEMENTS // per_sample)
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


# a conv's stride, padding (the depth's 0 on a haloed slab), dilation and
# groups (a depthwise conv's slice of them when its channels are sharded)
_ConvSpec = collections.namedtuple("_ConvSpec", "stride padding dilation groups")


def _conv(conv, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.conv3d(x, weight, None, conv.stride, conv.padding,
                                      conv.dilation, conv.groups)


def depth_halo(x: torch.Tensor, kernel: int, stride: int, padding, fill: float = 0.0):
    """(input, padding) of a window over depth (``kernel``, ``stride``,
    ``padding``; H, W as given) on this rank: under a depth split the slab
    with the planes the window reaches past it (``padding`` before, ``kernel
    - stride - padding`` after: the slab starts at a multiple of ``stride``)
    and depth padding 0; else ``x`` and ``padding`` as they were."""
    depth = current_depth()
    padding = tuple(padding)
    if depth is None:
        return x, padding
    lo, hi = padding[0], kernel - stride - padding[0]
    if hi < 0:
        raise ValueError(f"a depth window of {kernel} at stride {stride}, padding {padding[0]} "
                         "skips planes: it cannot run depth-split")
    return halo(x, depth, lo, hi, fill), (0, *padding[1:])


def model_conv_input(conv: nn.Conv3d, x: torch.Tensor) -> tuple:
    """(x as ``conv`` takes it, the groups it runs with, how its output
    lies) under a model split (``parallel/tensor.py``): "whole" on every
    rank, "sharded" (this rank's slice of the output channels) or "partial"
    (this rank's share of a sum over the input channels).

    The conv's weight (its slice under the split) against the module's
    whole channel counts says which rule sharded it, and ``x``'s channels
    say whether the input is this rank's slice or whole. A depthwise conv
    whose groups are sharded takes its slice of ``x``; a conv whose output
    channels are sharded takes every input channel; one whose input
    channels are sharded takes its slice; a whole conv takes every input
    channel. Outside a model split: ``x``, the conv's groups, "whole".
    """
    model = current_model()
    if model is None:
        return x, conv.groups, "whole"
    w = conv.weight
    sharded_in = x.shape[1] < conv.in_channels
    if conv.groups > 1:  # depthwise: the groups split with the channels
        if w.shape[0] < conv.out_channels:
            return (x if sharded_in else scatter_channels(x, model)), w.shape[0], "sharded"
        return (gather_channels(x, model, partial=False) if sharded_in else x), conv.groups, "whole"
    if w.shape[0] < conv.out_channels:
        return (gather_channels(x, model) if sharded_in else copy_to_model(x, model)), 1, "sharded"
    if w.shape[1] < conv.in_channels:
        return (x if sharded_in else scatter_channels(x, model)), 1, "partial"
    return (gather_channels(x, model, partial=False) if sharded_in else x), 1, "whole"


def conv3d(conv: nn.Conv3d, x: torch.Tensor, whole: bool = False) -> torch.Tensor:
    """``conv(x)``; depth-split, on the haloed slab (:func:`depth_halo`);
    channel-split, as :func:`model_conv_input` says, a partial output summed
    over the model group and, with ``whole``, a sharded output's channels
    joined (the heads)."""
    x, padding = depth_halo(x, conv.kernel_size[0], conv.stride[0], conv.padding)
    x, groups, out = model_conv_input(conv, x)
    bias = conv.bias
    if out == "partial":
        y = reduce_partial(torch.nn.functional.conv3d(x, conv.weight, None, conv.stride, padding,
                                                      conv.dilation, groups), current_model())
        return y if bias is None else y + bias.to(y.dtype).view(1, -1, 1, 1, 1)
    y = torch.nn.functional.conv3d(x, conv.weight, bias, conv.stride, padding, conv.dilation,
                                   groups)
    if out == "sharded" and whole:
        y = gather_channels(y, current_model(), partial=False)
    return y


def _chunk_z(conv, x, weight, z, sl):
    """The conv output of the samples ``sl``: kept, or recomputed in the
    kept one's layout (the reductions' order follows the layout)."""
    if z is not None:
        return z[sl]
    return _conv(conv, x[sl], weight).contiguous(memory_format=torch.channels_last_3d)


def conv_bn_relu_train(conv: nn.Conv3d, bn: BatchNorm3d, x: torch.Tensor,
                       keep: bool = True) -> torch.Tensor:
    """relu(bn(conv(x))) in training mode through :class:`_ConvBNReLU`; equal,
    to float32 rounding, to the plain ``torch.relu(bn(conv(x)))``. Depth-split,
    the conv runs on the haloed slab (:func:`depth_halo`); channel-split, on
    the input :func:`model_conv_input` gives it (a conv whose input channels
    are sharded sums its partial output first, then runs the plain BN)."""
    x, padding = depth_halo(x, conv.kernel_size[0], conv.stride[0], conv.padding)
    x, groups, out = model_conv_input(conv, x)
    if out == "partial":  # a sum over the model group first: the plain layers
        y = torch.nn.functional.conv3d(x, conv.weight, None, conv.stride, padding,
                                       conv.dilation, groups)
        return torch.relu(bn(reduce_partial(y, current_model())))
    spec = _ConvSpec(conv.stride, padding, conv.dilation, groups)
    return _ConvBNReLU.apply(x, conv.weight, bn.weight, bn.bias, spec, bn, keep)


def checkpointed(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` with its activations recomputed in the backward pass
    rather than kept (the JAX package's ``remat``).

    A ``ConvBNReLU`` (the stem, whose output is the largest activation of
    the tower) keeps only its input: :class:`_ConvBNReLU` recomputes its
    conv chunk by chunk in the backward. Any other block runs under
    non-reentrant ``torch.utils.checkpoint``
    with its parameters as inputs, so the recompute uses the tensors of the
    forward (inside ``functional_call`` they are the caller's, which the
    module no longer holds when the backward runs). Buffers stay out: the
    first pass moves the BN running statistics in place, which autograd
    would reject in a saved input. The recompute runs with every
    ``BatchNorm3d``'s ``update_stats`` off, so the running statistics move
    once; its batch statistics are those of the first pass, recomputed from
    the same input by the same deterministic reduction. It also runs under
    the split of the first pass (``parallel.collectives.under_split``): the
    backward runs outside :func:`run_tower`'s cut, and a block past the cut
    must not take halos there. ``checkpoint`` restores no RNG here
    (``preserve_rng_state=False``): no MobileNet block draws at random.
    """
    if isinstance(module, ConvBNReLU):
        return conv_bn_relu_train(module[0], module[1], x, keep=False)
    named = list(module.named_parameters())
    names = [n for n, _ in named]
    bns = [m for m in module.modules() if isinstance(m, BatchNorm3d)]
    split = current_split()

    @contextlib.contextmanager
    def recompute_context():
        for bn in bns:
            bn.update_stats = False
        try:
            with under_split(split):
                yield
        finally:
            for bn in bns:
                bn.update_stats = True

    def run(x, *tensors):
        return functional_call(module, dict(zip(names, tensors)), (x,))

    return checkpoint(run, x, *(t for _, t in named), use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute_context()))


class ConvNormActBlock(nn.Module):
    """Conv3d(k3, stride, padding 1, bias) + InstanceNorm + Dropout + PReLU.

    The MONAI ``Convolution`` block of the reference ConvNet backbone
    (lesions3d/base_network.py:83-92; JAX ``layers.py:261-294``): instance
    norm over D, H, W per sample and channel in float32 (biased variance,
    eps 1e-5, no affine), then dropout, then PReLU with one alpha (init
    0.2). Children follow MONAI's names: ``conv`` and ``adn.A`` (the norm and
    the dropout hold no parameters).

    Dropout in training keeps an element with probability 1 - rate and
    scales it by 1 / (1 - rate), as flax's ``nn.Dropout``; the mask is a
    Bernoulli draw from the ``generator`` passed to ``forward`` (required
    when training with rate > 0), so the step's explicit generator decides
    it. Under a data mesh every rank draws the global batch's mask (its
    ranks' rows in rank order) and keeps its own rows, so the W ranks
    together drop what one device drops on the global batch. Depth-split,
    the mask is drawn for the whole depth and the rank keeps its slab, and
    the norm's per-sample sums run over the spatial group.

    The forward is two phases (``utils.profiling.phases``):
    ``msl.convnet.conv``, then ``msl.convnet.norm_act`` (the norm, dropout
    and PReLU), timed inside a CUDA graph's replay and spans in an eager
    trace.
    """

    def __init__(self, in_features: int, features: int, strides=1, dropout_rate: float = 0.1,
                 prelu_init: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.prelu_init = float(prelu_init)
        self.conv = nn.Conv3d(in_features, features, 3, stride=strides, padding=1, bias=True,
                              dtype=dtype)
        self.adn = nn.ModuleDict({"A": nn.PReLU(1, init=prelu_init, dtype=dtype)})

    def reset_prelu(self) -> None:
        with torch.no_grad():
            self.adn["A"].weight.fill_(self.prelu_init)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        with phases("msl.convnet.conv") as phase:
            x = conv3d(self.conv, x)
            phase.next("msl.convnet.norm_act")
            return self._norm_act(x, generator)

    def _norm_act(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        x32 = x.float()
        depth = current_depth()
        if depth is None:
            var, mean = torch.var_mean(x32, (2, 3, 4), correction=0, keepdim=True)
        else:  # the sample's sums over the spatial group
            count = x32[0, 0].numel() * depth.size
            mean = differentiable_all_reduce_sum(x32.sum((2, 3, 4), keepdim=True), depth) / count
            var = differentiable_all_reduce_sum(
                ((x32 - mean) ** 2).sum((2, 3, 4), keepdim=True), depth) / count
        x = ((x32 - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
        if self.training and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("ConvNormActBlock: dropout in training needs a generator")
            keep = 1.0 - self.dropout_rate
            mask = _global_mask(x.shape, current_split(), generator, x.device,
                                self.conv.out_channels) < keep
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        alpha = self.adn["A"].weight.to(x.dtype)
        if x.shape[1] < self.conv.out_channels:  # channel-split: the slope is shared
            alpha = copy_to_model(alpha, current_model())
        return torch.where(x >= 0, x, alpha * x)


def _global_mask(shape, split, generator, device, channels: int) -> torch.Tensor:
    """Uniform draws for the global batch's activation of local ``shape``
    (N, C, D, H, W), ``channels`` whole: all ranks' rows, the whole depth and
    every channel, of which this rank keeps its rows, its slab and its slice
    of the channels."""
    rows = None if split is None else split.rows
    depth = None if split is None else split.depth
    n, d = shape[0], shape[2]
    whole = (n * (1 if rows is None else rows.size), channels,
             d * (1 if depth is None else depth.size), *shape[3:])
    u = torch.rand(whole, generator=generator, device=device)
    if rows is not None:
        u = u[rows.rank * n:(rows.rank + 1) * n]
    if depth is not None:
        u = u[:, :, depth.rank * d:(depth.rank + 1) * d]
    if shape[1] < channels:
        u = channel_slice(u, split.model)
    return u


def max_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(k3, s2, p1) with -inf padding (lesions3d/base_network.py:79-81);
    depth-split, on the slab with its left neighbour's last plane."""
    x, padding = depth_halo(x, 3, 2, (1, 1, 1), fill=-math.inf)
    return torch.nn.functional.max_pool3d(x, 3, 2, padding)


class MaxPool3d(nn.Module):
    """:func:`max_pool_3d` as a ConvNet layer; it takes (and ignores) the
    blocks' ``generator``."""

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return max_pool_3d(x)


def depth_stride(layer: nn.Module) -> int:
    """The depth stride of a backbone layer: its first conv's, or the max-pool's 2."""
    if isinstance(layer, MaxPool3d):
        return 2
    return next(m for m in layer.modules() if isinstance(m, nn.Conv3d)).stride[0]


def run_tower(layers, x: torch.Tensor, wanted, call):
    """Runs ``layers`` in order (``call(layer, x) -> x``); returns (the last
    output, {i: output of layer i for i in wanted}), whole in depth.

    Depth-split (``parallel/spatial.py``), layer i runs on the slab while its
    input depth and its output depth divide 2 n_spatial; at the first layer
    that fails this, its input and the feature maps so far are gathered over
    the spatial group (``gather_depth``) and the rest runs whole, past the
    cut. A tower that never reaches its cut gathers at the end.
    """
    depth = current_depth()
    features = {}
    if depth is None:
        for i, layer in enumerate(layers):
            x = call(layer, x)
            if i in wanted:
                features[i] = x
        return x, features

    def gather_all():
        nonlocal x, features
        done = {}
        for t in (x, *features.values()):
            if id(t) not in done:
                done[id(t)] = gather_depth(t, depth)
        x = done[id(x)]
        features = {i: done[id(t)] for i, t in features.items()}

    total, even = x.shape[2] * depth.size, 2 * depth.size
    with contextlib.ExitStack() as stack:
        for i, layer in enumerate(layers):
            if depth is not None:
                out = -(-total // depth_stride(layer))
                if total % even or out % even:
                    gather_all()
                    stack.enter_context(past_the_cut())
                    depth = None
                else:
                    total = out
            x = call(layer, x)
            if i in wanted:
                features[i] = x
        if depth is not None:
            gather_all()
    return x, features
