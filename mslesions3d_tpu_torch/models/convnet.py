"""Plain 3D ConvNet backbone: the layer plans only.

Counterpart of the plan part of ``mslesions3d_tpu/models/convnet.py``. The
plans are pure data, kept here so that :func:`..priors.feature_map_infos`
covers both backbones. The ConvNet modules themselves are not ported yet
(ROADMAP, "After the main path").
"""

from __future__ import annotations

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
