"""SSD3D written out in plain PyTorch: the benchmark's reference forward.

A backbone tower truncated after its last feature layer, and a 3^3 loc and
class head on each feature layer (Medical-Image-Analysis-Laboratory/MSLesions3D,
lesions3d/ssd3d.py). It reads a ``state_dict`` in that repository's schema,
computes in float32 whatever dtype the weights are stored in, and imports
nothing of the program under test.

The tower is its family's: the module ``reference/<family>.py`` named by the
first word of the configuration's ``base_network_config`` (``mobilenet`` ->
``mobilenet.py``, ``convnet_maxpool_double`` -> ``convnet.py``), found by
name as the harness finds traffic modules and metric readers, so that a
family is added as one file. A family module gives:

* ``tower_plan(cfg)``: [(kind, in channels, out channels, stride)] of the
  truncated tower, max-pools included, from which ``boxes.fmap_dims`` and
  ``boxes.priors`` take the maps' sizes;
* ``tower_specs(cfg)``: [(name, shape, kind, fan_in)] of the tower's
  state-dict entries, in the schema's order;
* ``KINDS``: {kind: (value under "init", value under "served", role)} of the
  kinds it adds beside the shared ``conv_w``, ``conv_b`` and ``rescale``; a
  value is a constant or a (low, high) uniform draw, a role ``trained``,
  ``statistic`` or ``counter``;
* ``forward(sd, cfg, x, train, moved, dtype, generator)``: {feature layer:
  map (B, C, D, H, W)} of ``x`` in ``dtype``; in training mode it writes the
  moved statistics into ``moved`` and draws what it draws from
  ``generator``;
* ``DOUBLE_LEAF``: the leaf that the ``double`` fault moves twice.

The heads, the rescale factors and the output layout are shared, here.
Images are (B, D, H, W, C); locs come out (B, P, 6) and class logits
(B, P, n_classes) in prior order (feature layer, then voxel in D, H, W
order, then box).
"""

from __future__ import annotations

import importlib
from pathlib import Path

import torch
import torch.nn.functional as F

SHARED_KINDS = {"conv_w": "trained", "conv_b": "trained", "rescale": "trained"}


class float32_exact:
    """TF32 off for cuDNN and cuBLAS inside the block: the reference computes
    in IEEE float32."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def family_name(cfg: dict) -> str:
    return str(cfg["base_network_config"]).split("_")[0]


def family(cfg: dict):
    """The module of the configuration's backbone family."""
    name = family_name(cfg)
    if not (Path(__file__).parent / f"{name}.py").is_file():
        raise FileNotFoundError(f"no reference for the backbone family {name!r} "
                                "under perfbench/reference")
    return importlib.import_module(f"{__package__}.{name}")


def tower_plan(cfg: dict) -> list:
    """[(kind, in channels, out channels, stride)] of the truncated tower."""
    return family(cfg).tower_plan(cfg)


def feature_layers(cfg: dict) -> list:
    return sorted(int(k) for k in cfg["aspect_ratios"])


def boxes_per_map(cfg: dict, layer: int) -> int:
    return len(cfg["aspect_ratios"][str(layer)]) + int(cfg["boxes_per_location"]) - 1


def roles(cfg: dict) -> dict:
    """{kind: role} of every kind of the configuration's state dict."""
    return {**SHARED_KINDS, **{k: v[2] for k, v in family(cfg).KINDS.items()}}


def param_specs(cfg: dict) -> list:
    """[(name, shape, kind, fan_in)] of the state dict, in the schema's order:
    the tower's, then the heads' and the rescale factors."""
    specs = list(family(cfg).tower_specs(cfg))
    channels = {i: cout for i, (_, _, cout, _) in enumerate(tower_plan(cfg))}
    for head, per_box in (("loc_convs", 6), ("cl_convs", int(cfg["n_classes"]))):
        for j, layer in enumerate(feature_layers(cfg)):
            c, out = channels[layer], boxes_per_map(cfg, layer) * per_box
            specs.append((f"pred_convs.{head}.{j}.weight", (out, c, 3, 3, 3), "conv_w", c * 27))
            specs.append((f"pred_convs.{head}.{j}.bias", (out,), "conv_b", c * 27))
    specs.append(("rescale_factors", (1, channels[min(feature_layers(cfg))], 1, 1, 1),
                  "rescale", 0))
    return specs


def forward(sd: dict, cfg: dict, images: torch.Tensor, train: bool = False,
            moved: dict | None = None, dtype: torch.dtype = torch.float32,
            generator: torch.Generator | None = None):
    """(locs (B, P, 6), logits (B, P, n_classes)) in float32. With ``train``
    the tower runs in training mode: given ``moved`` it writes the moved
    statistics into it, and it draws from ``generator``. ``dtype`` other than
    float32 runs the convs and keeps every activation in it (normalisation
    in float32, its output rounded back), as a program served in that dtype
    does."""
    x = images.to(dtype).permute(0, 4, 1, 2, 3)
    features = family(cfg).forward(sd, cfg, x, train, moved, dtype, generator)
    b = images.shape[0]
    locs, logits = [], []
    for j, layer in enumerate(feature_layers(cfg)):
        f = features[layer]
        for head, per_box, out in (("loc_convs", 6, locs),
                                   ("cl_convs", int(cfg["n_classes"]), logits)):
            y = F.conv3d(f, sd[f"pred_convs.{head}.{j}.weight"].to(dtype),
                         sd[f"pred_convs.{head}.{j}.bias"].to(dtype), 1, 1)
            out.append(y.float().permute(0, 2, 3, 4, 1).reshape(b, -1, per_box))
    return torch.cat(locs, 1), torch.cat(logits, 1)
