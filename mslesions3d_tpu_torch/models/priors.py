"""Prior (anchor) boxes and analytic feature-map shapes, in numpy.

Counterpart of ``mslesions3d_tpu/models/priors.py``; the output is equal
element for element. Every backbone layer is a k3/p1 conv or maxpool, so a
layer of stride s maps a dim d to ``(d - 1) // s + 1``. Priors are laid out

  for each feature map (ascending layer index)
    for i over dim0, j over dim1, k over dim2   (the heads' (N,D,H,W,C) order)
      base box   [cx, cy, cz, s, s, s]
      extra box  scale s + s/div for div in 1..boxes_per_location-1

with the reference's swapped centers cx=(j+.5)/dim1, cy=(i+.5)/dim0,
cz=(k+.5)/dim2, kept for parity with reference checkpoints (a no-op for cube
feature maps).
"""

from __future__ import annotations

import numpy as np

from .convnet import convnet_layer_plan
from .mobilenet import mobilenet_layer_plan


def _conv_out(d: int, s: int) -> int:
    # kernel 3, padding 1, stride s: floor((d + 2*1 - 3)/s) + 1
    return (d - 1) // s + 1


def feature_map_infos(
    base_network_config: str,
    input_size: tuple[int, int, int],
    feature_layers,
    width_mult: float = 1.0,
):
    """Shapes and channels of every layer of the truncated backbone.

    Returns (fmap_dims: {layer: (d, h, w)}, channels: {layer: C}).
    """
    cube = input_size[0] == input_size[1] == input_size[2]
    if "mobilenet" in base_network_config:
        plan = mobilenet_layer_plan(base_network_config, width_mult, cube, max(feature_layers))
    elif "convnet" in base_network_config:
        plan = convnet_layer_plan(base_network_config, max(feature_layers))
    else:
        raise ValueError(
            f"Unknown base network config; expected 'mobilenet*' or 'convnet*', got "
            f"{base_network_config!r}"
        )

    dims = tuple(input_size)
    channels_prev = None
    fmap_dims, channels = {}, {}
    for i, spec in enumerate(plan):
        dims = tuple(_conv_out(d, s) for d, s in zip(dims, spec["strides"]))
        c = channels_prev if spec["kind"] == "maxpool" else spec["features"]
        channels_prev = c
        fmap_dims[i] = dims
        channels[i] = c
    return fmap_dims, channels


def default_scales(feature_layers, input_size, min_object_size: float, max_object_size: float):
    """scales = linspace(min/input0, max/input0, n_maps)."""
    values = np.linspace(
        min_object_size / input_size[0], max_object_size / input_size[0], len(feature_layers)
    )
    return {layer: float(s) for layer, s in zip(sorted(feature_layers), values)}


def generate_priors(fmap_dims: dict, scales: dict, aspect_ratios: dict,
                    boxes_per_location: int = 2) -> np.ndarray:
    """Dense prior grid in center form, clamped to [0, 1]; shape (P, 6) float32.

    Only ratio == 1 receives the extra boxes, as in the reference.
    """
    all_priors = []
    for layer in sorted(aspect_ratios.keys()):
        d0, d1, d2 = fmap_dims[layer]
        s = scales[layer]
        ii, jj, kk = np.meshgrid(np.arange(d0), np.arange(d1), np.arange(d2), indexing="ij")
        cx = (jj + 0.5) / d1
        cy = (ii + 0.5) / d0
        cz = (kk + 0.5) / d2
        centers = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)  # (L, 3)

        per_loc = []
        for ratio in aspect_ratios[layer]:
            per_loc.append(np.full(3, s))
            if ratio == 1.0:
                for div in range(1, boxes_per_location):
                    per_loc.append(np.full(3, s + s / div))
        sizes = np.asarray(per_loc)  # (n_boxes, 3)

        n_loc, n_boxes = centers.shape[0], sizes.shape[0]
        all_priors.append(np.concatenate(
            [np.repeat(centers, n_boxes, axis=0), np.tile(sizes, (n_loc, 1))], axis=1
        ))

    priors = np.concatenate(all_priors, axis=0).astype(np.float32)
    return np.clip(priors, 0.0, 1.0)


def priors_per_feature_map(fmap_dims, scales, aspect_ratios, boxes_per_location=2):
    """Per-layer dict variant of :func:`generate_priors`."""
    return {
        layer: generate_priors(
            {layer: fmap_dims[layer]}, {layer: scales[layer]},
            {layer: aspect_ratios[layer]}, boxes_per_location,
        )
        for layer in sorted(aspect_ratios.keys())
    }
