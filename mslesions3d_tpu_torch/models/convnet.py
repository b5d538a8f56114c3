"""Plain 3D ConvNet backbone (the alternative to MobileNet).

Counterpart of ``mslesions3d_tpu/models/convnet.py``: the reference's
ConvNetBase + CONVNET_CONFIGS (lesions3d/base_network.py:18-126), stacks
of Conv + InstanceNorm + Dropout + PReLU blocks, downsampled by strided
convs or MaxPool3d(k3, s2, p1); the tower is cut after max(feature_layers).
The plans are pure data, so that :func:`..priors.feature_map_infos` covers
both backbones. The model holds no BatchNorm, so its train state carries no
BN statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import ConvNormActBlock, MaxPool3d, run_tower

# (out_channels | 'maxpool3d', stride); padding is always 1.
config_no_maxpool = (
    (32, (1, 1, 1)), (32, (1, 1, 1)),
    (64, (2, 2, 2)), (64, (1, 1, 1)),
    (128, (2, 2, 2)), (128, (1, 1, 1)),
    (256, (2, 2, 2)), (256, (1, 1, 1)),
)

config_maxpool_simple = (
    (32, (1, 1, 1)), (32, (1, 1, 1)),
    ("maxpool3d", (2, 2, 2)), (64, (1, 1, 1)),
    ("maxpool3d", (2, 2, 2)), (128, (1, 1, 1)),
    ("maxpool3d", (2, 2, 2)), (256, (1, 1, 1)),
)

config_maxpool_double = (
    (32, (1, 1, 1)), (32, (1, 1, 1)),
    ("maxpool3d", (2, 2, 2)), (64, (1, 1, 1)), (64, (1, 1, 1)),
    ("maxpool3d", (2, 2, 2)), (128, (1, 1, 1)), (128, (1, 1, 1)),
    ("maxpool3d", (2, 2, 2)), (256, (1, 1, 1)),
)

CONVNET_CONFIGS = {
    "convnet_strides": config_no_maxpool,
    "convnet_maxpool_simple": config_maxpool_simple,
    "convnet_maxpool_double": config_maxpool_double,
}


def convnet_layer_plan(config_name: str, truncate_after: int | None = None):
    """Flat per-layer plan, cut after index ``truncate_after``."""
    plan = []
    for i, (features, stride) in enumerate(CONVNET_CONFIGS[config_name]):
        if truncate_after is not None and i > truncate_after:
            break
        kind = "maxpool" if features == "maxpool3d" else "conv"
        plan.append(dict(kind=kind, features=features, strides=stride))
    return plan


class ConvNetBackbone(nn.Module):
    """Truncated ConvNet tower returning {layer index: feature map}.

    ``features[i]`` is a :class:`..layers.ConvNormActBlock` for a conv entry
    and a :class:`..layers.MaxPool3d` for a pooling one, so the ``state_dict`` keys
    are ``base.features.<i>.conv.{weight,bias}`` and
    ``base.features.<i>.adn.A.weight``. ``forward`` passes ``generator`` to
    every block's dropout. Depth-split (``parallel/spatial.py``) the blocks
    run on their slabs up to the cut (``layers.run_tower``).
    """

    def __init__(self, in_channels: int, feature_layers: Sequence[int] = (6, 9),
                 config_name: str = "convnet_maxpool_double", dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_layers = tuple(feature_layers)
        layers, c_in = [], in_channels
        for spec in convnet_layer_plan(config_name, max(self.feature_layers)):
            if spec["kind"] == "maxpool":
                layers.append(MaxPool3d())
                continue
            layers.append(ConvNormActBlock(c_in, spec["features"], spec["strides"],
                                           dropout_rate=dropout_rate, dtype=dtype))
            c_in = spec["features"]
        self.features = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> dict:
        _, features = run_tower(self.features, x, set(self.feature_layers),
                                lambda layer, x: layer(x, generator))
        return features
