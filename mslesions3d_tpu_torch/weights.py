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
  ConvNet: layer_<i>/conv/{kernel,bias} -> base.features.<i>.conv.{weight,bias}
           layer_<i>/prelu_alpha (1,)   -> base.features.<i>.adn.A.weight (1,)
  heads/{loc,cls}_<layer>               -> pred_convs.{loc,cl}_convs.<j>, ascending layer
  rescale_factors (C,)                  -> rescale_factors (1,C,1,1,1)

BN scale/bias become weight/bias and batch_stats mean/var become
running_mean/running_var. The ConvNet's blocks follow MONAI's
``Convolution`` (``conv``, then ``adn`` whose PReLU is ``A``); its
max-pool layers hold no variables, and it has no ``batch_stats``.
:func:`from_jax_params` maps a tree shaped like ``params`` alone, such as a
gradient tree, onto the parameter names.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_weight(kernel) -> torch.Tensor:
    # (kD, kH, kW, I, O) -> (O, I, kD, kH, kW); depthwise (k,k,k,1,C) -> (C,1,k,k,k)
    return _tensor(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _layers(backbone: dict):
    """(index, variables) of every backbone layer that holds some, in order
    (a ConvNet's max-pool layers hold none)."""
    indices = sorted(int(k.split("_")[1]) for k in backbone if k.startswith("layer_"))
    for i in indices:
        yield i, backbone[f"layer_{i}"]


def _bn_children(layer: dict):
    """(port child, JAX child) of each BN of a backbone layer."""
    if "prelu_alpha" in layer:  # ConvNet block: no BN
        return ()
    if "conv" in layer:  # stem ConvBNReLU
        return (("1", "bn"),)
    return (("bn1", "dw_bn"), ("bn2", "pw_bn"))


def from_jax_params(params: dict, config) -> dict:
    """A tree shaped like the JAX SSD3D ``params`` -> {port parameter name: tensor}."""
    out: dict = {}
    for i, layer in _layers(params["backbone"]):
        prefix = f"base.features.{i}"
        if "prelu_alpha" in layer:
            out[f"{prefix}.conv.weight"] = _conv_weight(layer["conv"]["kernel"])
            out[f"{prefix}.conv.bias"] = _tensor(layer["conv"]["bias"])
            out[f"{prefix}.adn.A.weight"] = _tensor(layer["prelu_alpha"])
        elif "conv" in layer:
            out[f"{prefix}.0.weight"] = _conv_weight(layer["conv"]["kernel"])
        else:
            out[f"{prefix}.conv1.weight"] = _conv_weight(layer["dw_conv"]["kernel"])
            out[f"{prefix}.conv2.weight"] = _conv_weight(layer["pw_conv"]["kernel"])
        for ours, theirs in _bn_children(layer):
            out[f"{prefix}.{ours}.weight"] = _tensor(layer[theirs]["scale"])
            out[f"{prefix}.{ours}.bias"] = _tensor(layer[theirs]["bias"])

    heads = params["heads"]
    for j, layer in enumerate(sorted(config.feature_layers)):
        for ours, theirs in (("loc_convs", "loc"), ("cl_convs", "cls")):
            out[f"pred_convs.{ours}.{j}.weight"] = _conv_weight(heads[f"{theirs}_{layer}"]["kernel"])
            out[f"pred_convs.{ours}.{j}.bias"] = _tensor(heads[f"{theirs}_{layer}"]["bias"])

    out["rescale_factors"] = _tensor(params["rescale_factors"]).reshape(1, -1, 1, 1, 1)
    return out


def from_jax_batch_stats(params: dict, batch_stats: dict) -> dict:
    """JAX ``batch_stats`` -> {port running_mean / running_var name: tensor}."""
    out: dict = {}
    stats = batch_stats.get("backbone", {})
    for i, layer in _layers(params["backbone"]):
        for ours, theirs in _bn_children(layer):
            prefix = f"base.features.{i}.{ours}"
            out[f"{prefix}.running_mean"] = _tensor(stats[f"layer_{i}"][theirs]["mean"])
            out[f"{prefix}.running_var"] = _tensor(stats[f"layer_{i}"][theirs]["var"])
    return out


def from_jax_variables(params: dict, batch_stats: dict, config) -> dict:
    """JAX SSD3D ``params`` / ``batch_stats`` trees -> this package's state_dict."""
    state = {**from_jax_params(params, config), **from_jax_batch_stats(params, batch_stats)}
    for key in [k for k in state if k.endswith(".running_var")]:
        state[key.replace(".running_var", ".num_batches_tracked")] = torch.zeros(
            (), dtype=torch.long)
    return state
