"""Building blocks of the MobileNet backbone, NCDHW tensors.

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
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.depthwise import fold_bn, fused_depthwise_bn_relu_cuda

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
        if self.fast_variance:
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
        else:
            var, mean = torch.var_mean(x32, dims, correction=0)
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1 - keep) * var)
        centred = x32 - self._channel(mean)
        if self.fast_variance:
            y = centred * self._channel(torch.rsqrt(var + self.epsilon) * self.weight)
        else:
            y = centred * self._channel(torch.rsqrt(var + self.epsilon)) \
                * self._channel(self.weight)
        return (y + self._channel(self.bias)).to(x.dtype)

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
        return torch.relu(bn(conv(x)))


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
            x = fused_depthwise_bn_relu_cuda(
                x.contiguous(memory_format=torch.channels_last_3d), self._dw_weights(),
                gamma, beta,
            )
        else:
            x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))
