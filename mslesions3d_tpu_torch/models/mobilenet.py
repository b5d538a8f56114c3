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
Channel-split (``parallel/tensor.py``) the fused tail takes every channel of
its input and the whole weights of its blocks, joined over the model group,
and gives whole maps on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels.tail import fused_tail_cuda
from ..parallel.collectives import current_model, gather_channels, whole_along
from .layers import (
    INIT_SCHEMES,
    BatchNorm3d,
    ConvBNReLU,
    DepthwiseSeparableBlock,
    checkpointed,
    init_conv_,
    lecun_normal_,
    run_tower,
    torch_uniform_,
)

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
            model = current_model()
            if model is not None and x.shape[1] < self.features[self.tail_from].conv1.in_channels:
                x = gather_channels(x, model, partial=False)
            if x.shape[1] % 128 != 0:
                raise ValueError(
                    "use_pallas_tail needs lane-aligned tail input channels; "
                    f"got {x.shape[1]} (width_mult too small?)"
                )
            tail = [whole_params(layer, model) for layer in self.features[self.tail_from:]]
            emitted = sorted(i for i in wanted if i >= self.tail_from)
            outs = fused_tail_cuda(
                x.contiguous(memory_format=torch.channels_last_3d), tail,
                [i - self.tail_from for i in emitted],
            )
            features.update(zip(emitted, outs))
        return features


def whole_params(block: DepthwiseSeparableBlock, model) -> dict:
    """The block's inference parameters for K3 (``folded_params``), each made
    whole over the model view where the split shards it (None: as they are)."""
    params = block.folded_params()
    if model is None:
        return params
    c, cout = block.conv1.out_channels, block.conv2.out_channels
    cin = block.conv2.in_channels
    return dict(params,
                dw_w=whole_along(params["dw_w"], c, 3, model),
                dw_gamma=whole_along(params["dw_gamma"], c, 0, model),
                dw_beta=whole_along(params["dw_beta"], c, 0, model),
                pw_w=whole_along(whole_along(params["pw_w"], cin, 0, model), cout, 1, model),
                pw_gamma=whole_along(params["pw_gamma"], cout, 0, model),
                pw_beta=whole_along(params["pw_beta"], cout, 0, model))


class MobileNetClassifier(nn.Module):
    """The whole MobileNet-3D with a global average pool, dropout and a
    linear head (the JAX package's ``MobileNetClassifier``: the reference's
    MobileNet / LMobileNetBase, lesions3d/mobilenet.py:52-147, kept for its
    classification demo).

    Images (B, D, H, W, C) in, logits (B, ``num_classes``) out. The layers
    are the whole plan with ``cube=False`` (first stride (1, 2, 2)), named
    ``features.<i>`` as the backbone's; the head is ``head``. Dropout (rate
    0.2) in training keeps an element with probability 0.8 and scales it by
    1 / 0.8, its mask drawn from the ``generator`` passed to ``forward``.
    The weights are made on the CPU from ``generator`` (seeded 0 if None)
    under ``init_scheme``: "torch" draws U(+-1/sqrt(fan_in)) weights and
    biases, "flax" lecun-normal weights and zero biases, and "kaiming_relu"
    draws as "flax", as the JAX package's classifier does (its override
    belongs to the SSD3D train state).
    """

    dropout_rate = 0.2

    def __init__(self, num_classes: int = 3, width_mult: float = 1.0, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, init_scheme: str = "torch",
                 generator: torch.Generator | None = None):
        super().__init__()
        if init_scheme not in INIT_SCHEMES:
            raise ValueError(f"unknown init_scheme {init_scheme!r}; known: {INIT_SCHEMES}")
        self.dtype = dtype
        with torch.device("meta"):
            layers, c_in = [], in_channels
            for spec in mobilenet_layer_plan("mobilenet", width_mult, cube=False):
                block = ConvBNReLU if spec["kind"] == "conv_bn" else DepthwiseSeparableBlock
                layers.append(block(c_in, spec["features"], spec["strides"], dtype=dtype))
                c_in = spec["features"]
            self.features = nn.ModuleList(layers)
            self.head = nn.Linear(c_in, num_classes, dtype=dtype)
        self.to_empty(device="cpu")
        self.reset_parameters(generator or torch.Generator().manual_seed(0),
                              "flax" if init_scheme == "kaiming_relu" else init_scheme)

    def reset_parameters(self, generator: torch.Generator, scheme: str) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                init_conv_(m, generator, scheme)
            elif isinstance(m, BatchNorm3d):
                m.reset_parameters()
        fan_in = self.head.in_features
        if scheme == "torch":
            torch_uniform_(self.head.weight, fan_in, generator)
            torch_uniform_(self.head.bias, fan_in, generator)
        else:
            lecun_normal_(self.head.weight, fan_in, generator)
            with torch.no_grad():
                self.head.bias.zero_()

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 4, 1, 2, 3)
        for layer in self.features:
            x = layer(x)
        x = x.mean(dim=(2, 3, 4))  # global average pool over D, H, W
        if self.training:
            if generator is None:
                raise ValueError("MobileNetClassifier: dropout in training needs a generator")
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.head(x)
