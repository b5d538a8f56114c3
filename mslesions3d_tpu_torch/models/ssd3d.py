"""SSD3D: truncated backbone + per-feature-map prediction heads.

Counterpart of ``mslesions3d_tpu/models/ssd3d.py``. The public layout is the
JAX package's: images (B, D, H, W, C) in, locs (B, P, 6) and class scores
(B, P, n_classes) out, in prior order. Inside, the (B, D, H, W, C) input is
viewed as (B, C, D, H, W) in ``channels_last_3d`` memory, so no copy is made
on the way in, and each head output is permuted back to (B, D, H, W, C)
before the reshape to (B, ·, 6), which is the priors' order.

Module names follow the reference ``state_dict`` schema: ``base.features.*``,
``pred_convs.{loc_convs,cl_convs}.<j>`` (ascending feature layer) and
``rescale_factors`` (1, C, 1, 1, 1).

Channel-split (``parallel/tensor.py``: a rank's slices of the sharded
parameters, through ``functional_call``) the heads give whole outputs on
every rank: a head whose output channels are sharded joins them, one whose
input channels are sharded sums its partial output (``layers.conv3d``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.nms import detect_objects
from ..parallel.collectives import current_model, differentiable_all_reduce_sum, past_the_cut
from .convnet import ConvNetBackbone
from .layers import INIT_SCHEMES, BatchNorm3d, ConvNormActBlock, conv3d, init_conv_
from .mobilenet import MobileNetBackbone
from .priors import default_scales, feature_map_infos, generate_priors

DEFAULT_ASPECT_RATIOS = {3: (1.0,), 5: (1.0,), 7: (1.0,)}


def _freeze_ratios(aspect_ratios) -> tuple:
    return tuple(sorted((int(k), tuple(float(r) for r in v)) for k, v in aspect_ratios.items()))


@dataclasses.dataclass(frozen=True)
class SSD3DConfig:
    """The JAX package's SSD3DConfig, field for field, so the JSON round-trips.

    The training fields (lr, scheduler, t_max, alpha, focal_*, ema_decay,
    remat, ...) drive ``train/``.
    """

    n_classes: int = 2
    input_channels: int = 1
    input_size: tuple[int, int, int] = (64, 64, 64)
    threshold: tuple[float, ...] = (0.5,)  # 1 value = hard matching, 2 = soft band
    alpha: float = 1.0
    lr: float = 1.3e-5
    base_network_config: str = "mobilenet"
    convnet_dropout: float = 0.1
    width_mult: float = 1.0
    min_score: float = 0.5
    max_overlap: float = 0.5
    min_overlap: float = 0.5
    top_k: int = 100
    scheduler: str = "CosineAnnealingLR"
    t_max: int = 40
    batch_size: int = 8
    compute_metric_every_n_epochs: int = 1
    aspect_ratios: tuple = _freeze_ratios(DEFAULT_ASPECT_RATIOS)
    min_object_size: float = 6.0
    max_object_size: float = 14.0
    scales: tuple = ()  # ((layer, scale), ...); empty = linspace default
    boxes_per_location: int = 2
    focal_gamma: float = 0.0
    focal_alpha: float = 0.25
    use_l2_rescale: bool = False
    use_pallas: bool = False  # fused depthwise kernel K2 (kernels/depthwise.py), inference
    use_pallas_tail: bool = False  # fused tail kernel K3 (kernels/tail.py), inference
    remat: bool = False  # recompute MobileNet blocks in the backward (training memory)
    dtype: str = "float32"  # or "bfloat16"
    init_scheme: str = "torch"
    ema_decay: float = 0.0
    comments: str = ""

    @staticmethod
    def create(aspect_ratios=None, scales=None, threshold=0.5, **kwargs) -> "SSD3DConfig":
        """Constructor accepting dicts and floats like the reference ctor."""
        if aspect_ratios:
            kwargs["aspect_ratios"] = _freeze_ratios(aspect_ratios)
        if scales:
            kwargs["scales"] = tuple(sorted((int(k), float(v)) for k, v in scales.items()))
        if isinstance(threshold, (int, float)):
            threshold = (float(threshold),)
        else:
            threshold = tuple(float(t) for t in threshold)
        return SSD3DConfig(threshold=threshold, **kwargs)

    @property
    def aspect_ratios_dict(self) -> dict:
        return {k: list(v) for k, v in self.aspect_ratios}

    @property
    def feature_layers(self) -> tuple:
        return tuple(k for k, _ in self.aspect_ratios)

    @property
    def cube(self) -> bool:
        return self.input_size[0] == self.input_size[1] == self.input_size[2]

    @property
    def scales_dict(self) -> dict:
        if self.scales:
            return dict(self.scales)
        return default_scales(
            self.feature_layers, self.input_size, self.min_object_size, self.max_object_size
        )

    @property
    def soft_matching(self) -> bool:
        return len(self.threshold) == 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def boxes_per_map(self, layer: int) -> int:
        return len(dict(self.aspect_ratios)[layer]) + self.boxes_per_location - 1

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["aspect_ratios"] = {str(k): list(v) for k, v in self.aspect_ratios}
        d["scales"] = {str(k): v for k, v in self.scales}
        return d

    @staticmethod
    def from_json_dict(d: dict) -> "SSD3DConfig":
        d = dict(d)
        d["aspect_ratios"] = _freeze_ratios(d["aspect_ratios"])
        d["scales"] = tuple(sorted((int(k), float(v)) for k, v in d.get("scales", {}).items()))
        d["input_size"] = tuple(d["input_size"])
        d["threshold"] = tuple(d["threshold"])
        return SSD3DConfig(**d)


class PredictionHeads(nn.Module):
    """Per-feature-map localization and classification convs (k3, padding 1, bias)."""

    def __init__(self, config: SSD3DConfig, channels: dict):
        super().__init__()
        self.n_classes = config.n_classes
        self.layers = sorted(config.feature_layers)
        dtype = config.compute_dtype
        self.loc_convs = nn.ModuleList([
            nn.Conv3d(channels[layer], config.boxes_per_map(layer) * 6, 3, padding=1, dtype=dtype)
            for layer in self.layers
        ])
        self.cl_convs = nn.ModuleList([
            nn.Conv3d(channels[layer], config.boxes_per_map(layer) * config.n_classes, 3,
                      padding=1, dtype=dtype)
            for layer in self.layers
        ])

    def forward(self, features: dict) -> tuple[torch.Tensor, torch.Tensor]:
        locs, scores = [], []
        for layer, loc_conv, cl_conv in zip(self.layers, self.loc_convs, self.cl_convs):
            x = features[layer]
            batch = x.shape[0]
            # (B, C, D, H, W) -> (B, D, H, W, C) before the reshape: prior order
            locs.append(conv3d(loc_conv, x, whole=True).permute(0, 2, 3, 4, 1)
                        .reshape(batch, -1, 6))
            scores.append(conv3d(cl_conv, x, whole=True).permute(0, 2, 3, 4, 1)
                          .reshape(batch, -1, self.n_classes))
        return torch.cat(locs, dim=1), torch.cat(scores, dim=1)


class SSD3D(nn.Module):
    """Backbone + heads; images (B, D, H, W, C) -> (locs (B, P, 6), scores (B, P, C)).

    The backbone is MobileNet for a ``mobilenet*`` config and the ConvNet
    for a ``convnet*`` one. The weights are made on the CPU with
    ``config.init_scheme`` ("torch", "flax" or "kaiming_relu", see
    ``layers.init_conv_``) from ``generator`` (a fresh generator seeded 0
    if none is given); move the model with ``.to(device)`` afterwards.
    ``forward``'s ``generator`` draws the ConvNet's dropout masks in
    training.
    """

    def __init__(self, config: SSD3DConfig, generator: torch.Generator | None = None):
        super().__init__()
        if not any(k in config.base_network_config for k in ("mobilenet", "convnet")):
            raise ValueError(
                "Unknown base network name. Expected 'mobilenet*' or 'convnet*' "
                f"but got {config.base_network_config!r}"
            )
        if config.init_scheme not in INIT_SCHEMES:
            raise ValueError(f"unknown init_scheme {config.init_scheme!r}; known: {INIT_SCHEMES}")
        self.config = config
        _, channels = feature_map_infos(
            config.base_network_config, config.input_size, config.feature_layers,
            config.width_mult,
        )
        # built on the meta device, so no default init runs on the global RNG
        with torch.device("meta"):
            if "mobilenet" in config.base_network_config:
                self.base = MobileNetBackbone(
                    config.input_channels,
                    feature_layers=config.feature_layers,
                    config_name=config.base_network_config,
                    width_mult=config.width_mult,
                    cube=config.cube,
                    dtype=config.compute_dtype,
                    use_pallas=config.use_pallas,
                    use_pallas_tail=config.use_pallas_tail,
                    remat=config.remat,
                )
            else:
                self.base = ConvNetBackbone(
                    config.input_channels,
                    feature_layers=config.feature_layers,
                    config_name=config.base_network_config,
                    dropout_rate=config.convnet_dropout,
                    dtype=config.compute_dtype,
                )
            self.pred_convs = PredictionHeads(config, channels)
            # L2 rescale of the shallowest map: created for checkpoint parity,
            # used only when use_l2_rescale (off in the reference)
            self.rescale_factors = nn.Parameter(
                torch.empty(1, channels[min(config.feature_layers)], 1, 1, 1)
            )
        self.to_empty(device="cpu")
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                init_conv_(m, generator, self.config.init_scheme)
            elif isinstance(m, BatchNorm3d):
                m.reset_parameters()
            elif isinstance(m, ConvNormActBlock):
                m.reset_prelu()
        with torch.no_grad():
            self.rescale_factors.fill_(20.0)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        # (B, D, H, W, C) -> (B, C, D, H, W) view with channels_last_3d strides
        x = images.to(cfg.compute_dtype).permute(0, 4, 1, 2, 3)
        features = self.base(x, generator)
        with past_the_cut():  # the backbone's maps are whole in depth
            return self._heads(features)

    def _heads(self, features: dict) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        if cfg.use_l2_rescale:
            first = min(features)
            f = features[first].float()
            squares = torch.sum(f * f, dim=1, keepdim=True)
            if f.shape[1] < self.pred_convs.loc_convs[0].in_channels:  # channel-split
                squares = differentiable_all_reduce_sum(squares, current_model())
            norm = torch.sqrt(squares) + 1e-6
            features = dict(features)
            features[first] = ((f / norm) * self.rescale_factors).to(cfg.compute_dtype)
        return self.pred_convs(features)


def model_priors(config: SSD3DConfig) -> np.ndarray:
    """Prior boxes for a config, center form (P, 6) float32."""
    fmap_dims, _ = feature_map_infos(
        config.base_network_config, config.input_size, config.feature_layers, config.width_mult
    )
    return generate_priors(
        {k: fmap_dims[k] for k in config.feature_layers},
        config.scales_dict,
        config.aspect_ratios_dict,
        config.boxes_per_location,
    )


def detect(config: SSD3DConfig, predicted_locs, predicted_scores, priors_center,
           min_score=None, max_overlap=None, top_k=None):
    """decode + NMS + top-k with the config's defaults."""
    return detect_objects(
        predicted_locs,
        predicted_scores,
        torch.as_tensor(priors_center, device=predicted_locs.device),
        n_classes=config.n_classes,
        min_score=config.min_score if min_score is None else min_score,
        max_overlap=config.max_overlap if max_overlap is None else max_overlap,
        top_k=config.top_k if top_k is None else top_k,
    )
