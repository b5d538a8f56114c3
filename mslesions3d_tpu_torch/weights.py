"""Carry weights across from the JAX package's variable trees.

:func:`from_jax_variables` is the inverse of the JAX package's
``train/torch_import.py::convert_torch_state_dict``: it takes the
``{"params", "batch_stats"}`` trees of ``SSD3D(config)`` as numpy arrays
(``jax.device_get`` of the variables) and returns this package's
``state_dict``, which is the reference checkpoint schema.

  layer_<i>/conv/kernel (3,3,3,I,O)     -> base.features.<i>.0.weight (O,I,3,3,3)
  layer_<i>/bn                          -> base.features.<i>.1.*
  layer_<i>/dw_conv/kernel (3,3,3,1,C)  -> base.features.<i>.conv1.weight (C,1,3,3,3)
  layer_<i>/pw_conv/kernel (1,1,1,I,O)  -> base.features.<i>.conv2.weight (O,I,1,1,1)
  layer_<i>/{dw_bn,pw_bn}               -> base.features.<i>.{bn1,bn2}.*
  heads/{loc,cls}_<layer>               -> pred_convs.{loc,cl}_convs.<j>, ascending layer
  rescale_factors (C,)                  -> rescale_factors (1,C,1,1,1)

BN scale/bias become weight/bias and batch_stats mean/var become
running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_weight(kernel) -> torch.Tensor:
    # (kD, kH, kW, I, O) -> (O, I, kD, kH, kW); depthwise (k,k,k,1,C) -> (C,1,k,k,k)
    return _tensor(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _batchnorm(prefix: str, params: dict, stats: dict) -> dict:
    return {
        f"{prefix}.weight": _tensor(params["scale"]),
        f"{prefix}.bias": _tensor(params["bias"]),
        f"{prefix}.running_mean": _tensor(stats["mean"]),
        f"{prefix}.running_var": _tensor(stats["var"]),
        f"{prefix}.num_batches_tracked": torch.zeros((), dtype=torch.long),
    }


def from_jax_variables(params: dict, batch_stats: dict, config) -> dict:
    """JAX SSD3D ``params`` / ``batch_stats`` trees -> this package's state_dict."""
    state: dict = {}
    backbone, backbone_stats = params["backbone"], batch_stats["backbone"]
    i = 0
    while f"layer_{i}" in backbone:
        layer, stats = backbone[f"layer_{i}"], backbone_stats[f"layer_{i}"]
        prefix = f"base.features.{i}"
        if "conv" in layer:  # stem ConvBNReLU
            state[f"{prefix}.0.weight"] = _conv_weight(layer["conv"]["kernel"])
            state.update(_batchnorm(f"{prefix}.1", layer["bn"], stats["bn"]))
        else:  # DepthwiseSeparableBlock
            state[f"{prefix}.conv1.weight"] = _conv_weight(layer["dw_conv"]["kernel"])
            state.update(_batchnorm(f"{prefix}.bn1", layer["dw_bn"], stats["dw_bn"]))
            state[f"{prefix}.conv2.weight"] = _conv_weight(layer["pw_conv"]["kernel"])
            state.update(_batchnorm(f"{prefix}.bn2", layer["pw_bn"], stats["pw_bn"]))
        i += 1

    heads = params["heads"]
    for j, layer in enumerate(sorted(config.feature_layers)):
        for ours, theirs in (("loc_convs", "loc"), ("cl_convs", "cls")):
            state[f"pred_convs.{ours}.{j}.weight"] = _conv_weight(heads[f"{theirs}_{layer}"]["kernel"])
            state[f"pred_convs.{ours}.{j}.bias"] = _tensor(heads[f"{theirs}_{layer}"]["bias"])

    state["rescale_factors"] = _tensor(params["rescale_factors"]).reshape(1, -1, 1, 1, 1)
    return state
