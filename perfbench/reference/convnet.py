"""The ConvNet family of SSD3D's backbone, in plain PyTorch: the reference
repository's ``ConvNetBase`` and ``CONVNET_CONFIGS``
(Medical-Image-Analysis-Laboratory/MSLesions3D, lesions3d/base_network.py:18-126).
A family module of ``reference/ssd3d.py``: its tower's plan, its state-dict
entries, the kind it adds, its forward and the leaf the ``double`` fault
moves.

A configuration is a list of entries. A number is a block of that many
output channels: Conv3d (k3, padding 1, bias, the entry's stride);
InstanceNorm over D, H and W per sample and channel, in float32, with biased
variance, eps 1e-5 and no affine; in training with a rate above 0, dropout;
PReLU with one slope (MONAI's ``Convolution`` with "NDA" order, as the
reference repository builds it). ``maxpool3d`` is MaxPool3d (k3, s2, p1),
padded with -inf. State-dict names follow MONAI's:
``base.features.<i>.conv.{weight,bias}`` and ``base.features.<i>.adn.A.weight``.

Slopes: ``init`` 0.2, MONAI's PReLU init as the reference repository sets
it. ``served`` draws each block's slope from U(0.15, 0.25). Every block's
InstanceNorm brings its conv's output to unit variance, so the slope does
not compound along the tower; it sets only the second moment of what the
next conv and the heads read, (1 + a^2) / 2 of a unit normal: 0.511-0.531
over the range, within 2% of the 0.52 at 0.2 and near the 0.5 of a ReLU,
which the served convs' variance of 2 / fan_in is made for. So activations
keep their scale and the heads give logits of a few units, as under the
MobileNet. A draw and not the constant, so that a program that read one
block's slope for another's, or kept its own init, serves other answers.

Departures from lesions3d/base_network.py:

* the tower is cut after the largest feature layer; the reference builds the
  whole configuration, whose layers past the cut change no feature map;
* dropout's mask is ``torch.rand((N, C, D, H, W), generator=...) < 1 -
  rate``, drawn in layer order from the generator handed in (the training
  step's, after its augmentation's draws), where torch's ``nn.Dropout`` draws
  a Bernoulli mask from the global generator; the kept values are divided
  by 1 - rate, where ``nn.Dropout`` multiplies by its inverse (an ulp apart);
* InstanceNorm runs in float32 whatever type the convs run in, and its
  output is rounded back to that type;
* the reference repository's SSD wiring of this backbone fails on a typo
  (lesions3d/ssd3d.py:281, ``self.boxes.per_location``); the heads, priors
  and rescale factors here are the MobileNet's (``reference/ssd3d.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NORM_EPS = 1e-5
CONVNET_CONFIGS = {  # (out channels or "maxpool3d", stride); padding is always 1
    "convnet_strides": (
        (32, (1, 1, 1)), (32, (1, 1, 1)),
        (64, (2, 2, 2)), (64, (1, 1, 1)),
        (128, (2, 2, 2)), (128, (1, 1, 1)),
        (256, (2, 2, 2)), (256, (1, 1, 1)),
    ),
    "convnet_maxpool_simple": (
        (32, (1, 1, 1)), (32, (1, 1, 1)),
        ("maxpool3d", (2, 2, 2)), (64, (1, 1, 1)),
        ("maxpool3d", (2, 2, 2)), (128, (1, 1, 1)),
        ("maxpool3d", (2, 2, 2)), (256, (1, 1, 1)),
    ),
    "convnet_maxpool_double": (
        (32, (1, 1, 1)), (32, (1, 1, 1)),
        ("maxpool3d", (2, 2, 2)), (64, (1, 1, 1)), (64, (1, 1, 1)),
        ("maxpool3d", (2, 2, 2)), (128, (1, 1, 1)), (128, (1, 1, 1)),
        ("maxpool3d", (2, 2, 2)), (256, (1, 1, 1)),
    ),
}
# kind -> (value under "init", value under "served", role), as in mobilenet.py
KINDS = {"prelu": (0.2, (0.15, 0.25), "trained")}
DOUBLE_LEAF = "base.features.3.conv.weight"


def tower_plan(cfg: dict) -> list:
    """[(kind, in channels, out channels, stride)] of the truncated tower; a
    max-pool keeps its input's channels."""
    last = max(int(k) for k in cfg["aspect_ratios"])
    cin = int(cfg["input_channels"])
    plan = []
    for features, stride in CONVNET_CONFIGS[cfg["base_network_config"]][:last + 1]:
        if features == "maxpool3d":
            plan.append(("maxpool", cin, cin, tuple(stride)))
        else:
            plan.append(("conv", cin, int(features), tuple(stride)))
            cin = int(features)
    return plan


def tower_specs(cfg: dict) -> list:
    """[(name, shape, kind, fan_in)] of the tower's state-dict entries, in the
    schema's order."""
    specs = []
    for i, (kind, cin, cout, _) in enumerate(tower_plan(cfg)):
        if kind == "conv":
            p = f"base.features.{i}"
            specs += [(f"{p}.conv.weight", (cout, cin, 3, 3, 3), "conv_w", cin * 27),
                      (f"{p}.conv.bias", (cout,), "conv_b", cin * 27),
                      (f"{p}.adn.A.weight", (1,), "prelu", 0)]
    return specs


def dropout_mask(shape, keep: float, generator: torch.Generator, device) -> torch.Tensor:
    """The elements dropout keeps: one uniform draw an element, in (N, C, D,
    H, W) order."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) times the inverse deviation, as torch's InstanceNorm3d
    computes it."""
    var, mean = torch.var_mean(x, (2, 3, 4), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + NORM_EPS)


def forward(sd: dict, cfg: dict, x: torch.Tensor, train: bool, moved: dict | None,
            dtype: torch.dtype, generator: torch.Generator | None) -> dict:
    """{feature layer: map (B, C, D, H, W)} of ``x`` (B, C, D, H, W) in
    ``dtype``. In training with ``convnet_dropout`` above 0 each block draws
    its mask from ``generator``. The tower keeps no statistics: ``moved``
    is not written."""
    rate = float(cfg["convnet_dropout"])
    wanted = {int(k) for k in cfg["aspect_ratios"]}
    features = {}
    for i, (kind, _, _, stride) in enumerate(tower_plan(cfg)):
        p = f"base.features.{i}"
        if kind == "maxpool":
            x = F.max_pool3d(x, 3, stride, 1)
        else:
            x = F.conv3d(x, sd[f"{p}.conv.weight"].to(dtype), sd[f"{p}.conv.bias"].to(dtype),
                         stride, 1)
            x = _instance_norm(x.float()).to(dtype)
            if train and rate > 0.0:
                if generator is None:
                    raise ValueError("the ConvNet's dropout in training needs a generator")
                keep = 1.0 - rate
                x = torch.where(dropout_mask(x.shape, keep, generator, x.device), x / keep, 0.0)
            slope = sd[f"{p}.adn.A.weight"].to(dtype)
            x = torch.where(x >= 0, x, slope * x)
        if i in wanted:
            features[i] = x
    return features
