"""MobileNet-v1-style 3D backbone (depthwise-separable conv tower).

Counterpart of ``mslesions3d_tpu/models/mobilenet.py``:

  features[0]   = ConvBNReLU(stem_channels, first_stride)
  features[1:]  = DepthwiseSeparableBlock per config entry, the first block
                  of each group carrying the group stride
  truncation    : the tower is cut right after index max(feature_layers)
  first_stride  : (2,2,2) for cube inputs, (1,2,2) otherwise

Depth-split (``parallel/spatial.py``) the blocks run on their slabs up to
the cut (``layers.run_tower``); the fused tail always takes the whole input,
so with ``use_pallas_tail`` the cut comes at its first block at the latest.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels.tail import fused_tail_cuda
from .layers import ConvBNReLU, DepthwiseSeparableBlock, checkpointed, run_tower

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

    ``use_pallas`` runs the depthwise half of eligible blocks on the fused
    kernel K2 (see ``DepthwiseSeparableBlock``). ``use_pallas_tail`` runs
    every block past the first wanted feature map as the fused tail K3
    (``kernels/tail.py``) at inference, under the JAX package's condition
    (``mobilenet.py:108-123``). The tail's blocks stay in ``features``, so
    the ``state_dict`` is the same whatever the flags. ``remat`` runs every
    layer under :func:`..layers.checkpointed` when training with gradients
    on (the JAX package's ``nn.remat`` of each block): activations are
    recomputed in the backward pass instead of kept. ``forward`` takes the
    ConvNet's ``generator`` argument and ignores it: no block draws.
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
        remat: bool = False,
    ):
        super().__init__()
        self.feature_layers = tuple(feature_layers)
        self.remat = remat
        plan = mobilenet_layer_plan(config_name, width_mult, cube, max(self.feature_layers))
        layers, c_in = [], in_channels
        for spec in plan:
            if spec["kind"] == "conv_bn":
                layers.append(ConvBNReLU(c_in, spec["features"], spec["strides"], dtype=dtype))
            else:
                layers.append(DepthwiseSeparableBlock(c_in, spec["features"], spec["strides"],
                                                      dtype=dtype, use_pallas=use_pallas))
            c_in = spec["features"]
        self.features = nn.ModuleList(layers)

        self.tail_from = min(self.feature_layers) + 1
        tail_specs = plan[self.tail_from:]
        self.fuse_tail = (
            use_pallas_tail
            and len(tail_specs) > 0
            # a wanted feature map must lie in the tail, else the tail is dead
            and any(i >= self.tail_from for i in self.feature_layers)
            and all(s["kind"] == "dw_block" for s in tail_specs)
            and all(s["features"] % 128 == 0 for s in tail_specs)
            and all(len(set(s["strides"])) == 1 for s in tail_specs)
        )

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> dict:
        wanted = set(self.feature_layers)
        fuse_tail = self.fuse_tail and not self.training
        remat = self.remat and self.training and torch.is_grad_enabled()
        head = self.features[: self.tail_from] if fuse_tail else self.features
        x, features = run_tower(head, x, wanted,
                                lambda layer, x: checkpointed(layer, x) if remat else layer(x))
        if fuse_tail:
            if x.shape[1] % 128 != 0:
                raise ValueError(
                    "use_pallas_tail needs lane-aligned tail input channels; "
                    f"got {x.shape[1]} (width_mult too small?)"
                )
            tail = [layer.folded_params() for layer in self.features[self.tail_from:]]
            emitted = sorted(i for i in wanted if i >= self.tail_from)
            outs = fused_tail_cuda(
                x.contiguous(memory_format=torch.channels_last_3d), tail,
                [i - self.tail_from for i in emitted],
            )
            features.update(zip(emitted, outs))
        return features
