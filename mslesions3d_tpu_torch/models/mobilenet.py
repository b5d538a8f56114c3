"""MobileNet-v1-style 3D backbone (depthwise-separable conv tower).

Counterpart of ``mslesions3d_tpu/models/mobilenet.py``:

  features[0]   = ConvBNReLU(stem_channels, first_stride)
  features[1:]  = DepthwiseSeparableBlock per config entry, the first block
                  of each group carrying the group stride
  truncation    : the tower is cut right after index max(feature_layers)
  first_stride  : (2,2,2) for cube inputs, (1,2,2) otherwise
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import ConvBNReLU, DepthwiseSeparableBlock

# stem_channels, then (channels, n_repeat, stride) groups
config_mobilenet = (
    32,
    ((64, 1, (2, 2, 2)),
     (128, 2, (2, 2, 2)),
     (256, 2, (2, 2, 2)),
     (512, 6, (2, 2, 2)),
     (1024, 2, (1, 1, 1))),
)

MOBILENET_CONFIGS = {"mobilenet": config_mobilenet}


def mobilenet_layer_plan(
    config_name: str = "mobilenet",
    width_mult: float = 1.0,
    cube: bool = True,
    truncate_after: int | None = None,
):
    """Expand a config into a flat per-layer plan of {kind, features, strides}.

    Entry 0 is the stem; ``truncate_after`` cuts the tower after that index.
    """
    stem_channels, groups = MOBILENET_CONFIGS[config_name]
    first_stride = (2, 2, 2) if cube else (1, 2, 2)
    plan = [dict(kind="conv_bn", features=int(stem_channels * width_mult), strides=first_stride)]
    for channels, n_repeat, stride in groups:
        for i in range(n_repeat):
            if truncate_after is not None and len(plan) - 1 == truncate_after:
                return plan
            plan.append(
                dict(
                    kind="dw_block",
                    features=int(channels * width_mult),
                    strides=stride if i == 0 else (1, 1, 1),
                )
            )
    return plan


class MobileNetBackbone(nn.Module):
    """Truncated MobileNet-3D tower returning {layer index: feature map}.

    ``use_pallas`` and ``use_pallas_tail`` select the fused depthwise and
    fused-tail kernels in the JAX package; their Hopper kernels are not
    ported yet, so asking for them raises.
    """

    def __init__(
        self,
        in_channels: int,
        feature_layers: Sequence[int] = (3, 5, 7),
        config_name: str = "mobilenet",
        width_mult: float = 1.0,
        cube: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        use_pallas_tail: bool = False,
    ):
        super().__init__()
        if use_pallas or use_pallas_tail:
            raise NotImplementedError(
                "use_pallas / use_pallas_tail need the fused depthwise (K2) and "
                "fused-tail (K3) kernels, which ROADMAP slice 2 ports"
            )
        self.feature_layers = tuple(feature_layers)
        plan = mobilenet_layer_plan(config_name, width_mult, cube, max(self.feature_layers))
        layers, c_in = [], in_channels
        for spec in plan:
            cls = ConvBNReLU if spec["kind"] == "conv_bn" else DepthwiseSeparableBlock
            layers.append(cls(c_in, spec["features"], spec["strides"], dtype=dtype))
            c_in = spec["features"]
        self.features = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> dict:
        wanted = set(self.feature_layers)
        features = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in wanted:
                features[i] = x
        return features
