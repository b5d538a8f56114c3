"""Import reference PyTorch LSSD3D checkpoints.

Counterpart of ``mslesions3d_tpu/train/torch_import.py``. The port keeps
the reference's ``state_dict`` schema (lesions3d/ssd3d.py LSSD3D with
MobileNetBase + PredictionConvolutions), so importing needs no transposes:
it loads the ``state_dict`` of a Lightning ``.ckpt`` (or a bare one) and
checks it name by name and shape by shape against ``SSD3D(config)``:

  base.features.0.0.weight                conv_bn stem conv   (O,I,3,3,3)
  base.features.0.1.{weight,bias,running_mean,running_var}   stem BN
  base.features.<i>.conv1.weight          depthwise conv      (C,1,3,3,3)
  base.features.<i>.{bn1,bn2}.*           depthwise / pointwise BN
  base.features.<i>.conv2.weight          pointwise conv      (O,C,1,1,1)
  pred_convs.{loc,cl}_convs.<j>.{weight,bias}   heads, ascending feature layer
  rescale_factors                         (1,C,1,1,1)

``num_batches_tracked`` is dropped and entries the model does not have are
ignored, as the JAX import ignores them. One reference quirk is kept: the
reference sizes ``rescale_factors`` with ``width_mult`` applied twice, so
for width_mult != 1 its length differs from the model's; the import then
keeps the model's initialization and warns (the parameter is inert unless
``use_l2_rescale``).
"""

from __future__ import annotations

import warnings

import torch

from ..models.ssd3d import SSD3D


def load_torch_state_dict(path) -> dict:
    """Load a torch checkpoint file (Lightning ``.ckpt`` with "state_dict",
    or a bare state_dict) into {name: CPU tensor}."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu() for k, v in state.items()}


def convert_torch_state_dict(state: dict, config) -> dict:
    """A reference state_dict -> the entries of ``SSD3D(config).state_dict()``
    it supplies, as float32 tensors (all of them but ``num_batches_tracked``,
    and ``rescale_factors`` only when its length matches)."""
    schema = {k: v.shape for k, v in SSD3D(config).state_dict().items()
              if not k.endswith("num_batches_tracked")}
    missing = sorted(k for k in schema if k not in state and k != "rescale_factors")
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} of the model's entries, e.g. "
                       f"{missing[:5]}")
    out = {}
    for name, shape in schema.items():
        if name not in state:
            continue
        value = torch.as_tensor(state[name]).to(torch.float32)
        if name == "rescale_factors":
            if value.numel() != shape.numel():
                warnings.warn(
                    f"rescale_factors length {value.numel()} != expected {shape.numel()} "
                    "(reference double-applies width_mult); keeping the framework "
                    "initialization (param is inert unless use_l2_rescale)"
                )
                continue
            value = value.reshape(shape)
        elif value.shape != shape:
            raise ValueError(f"checkpoint {name}: shape {tuple(value.shape)}, the model's "
                             f"{tuple(shape)}")
        out[name] = value
    return out


def import_torch_checkpoint(path, config) -> dict:
    """Torch .ckpt -> the state_dict entries it supplies for SSD3D(config)."""
    return convert_torch_state_dict(load_torch_state_dict(path), config)
