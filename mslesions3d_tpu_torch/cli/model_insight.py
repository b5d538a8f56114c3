"""Model-insight tools: prior-box visualization + parameter histograms.

Usage:
  python -m mslesions3d_tpu_torch.cli.model_insight priors [-cp <checkpoint_dir>] [-o DIR]
  python -m mslesions3d_tpu_torch.cli.model_insight histograms -cp <checkpoint_dir> [-o DIR]

Counterpart of ``mslesions3d_tpu/cli/model_insight.py`` (the reference's
lesions3d/model_insight.py): it renders each feature map's prior boxes as
wireframe NIfTI volumes (show_prior_boxes/save_prior_boxes,
model_insight.py:72-172), which needs no plotting package, and draws one
histogram PNG per parameter tensor of a port checkpoint
(model_insight.py:33-69), which needs matplotlib. Both run on the host; the
JAX CLI's ``--platform`` has nothing to choose here and is not taken.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.boxes_from_seg import segmentation_from_boxes
from ..data.nifti import save_nifti
from ..models.priors import feature_map_infos, priors_per_feature_map
from ..models.ssd3d import SSD3DConfig
from ..ops.boxes import center_to_corner
from ..train.checkpoints import load_checkpoint


def require(package: str, purpose: str):
    """Import an optional plotting package, or raise an ImportError naming it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{purpose} needs the {package.split('.')[0]!r} package, which is "
                          "not installed") from e


def save_prior_boxes(config: SSD3DConfig, output_dir, max_boxes_per_map: int = 200):
    """Write one wireframe NIfTI per feature map showing its prior grid."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    fmap_dims, _ = feature_map_infos(
        config.base_network_config, config.input_size, config.feature_layers,
        config.width_mult,
    )
    per_map = priors_per_feature_map(
        {k: fmap_dims[k] for k in config.feature_layers}, config.scales_dict,
        config.aspect_ratios_dict, config.boxes_per_location,
    )
    paths = []
    for layer, priors in per_map.items():
        corners = center_to_corner(torch.from_numpy(priors)).numpy()[:max_boxes_per_map]
        instances, _ = segmentation_from_boxes(
            np.clip(corners, 0, 1), np.ones(len(corners)), config.input_size
        )
        path = output_dir / f"prior_boxes_layer_{layer}.nii.gz"
        save_nifti(path, instances)
        paths.append(path)
        print(f"[model_insight] layer {layer}: {len(priors)} priors -> {path}")
    return paths


def parameter_histograms(checkpoint_dir, output_dir):
    """Histogram every parameter tensor of a checkpoint (matplotlib PNGs)."""
    matplotlib = require("matplotlib", "model_insight histograms")
    matplotlib.use("Agg")
    plt = require("matplotlib.pyplot", "model_insight histograms")

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    _, payload, _ = load_checkpoint(checkpoint_dir)

    params = payload["params"]
    for key, leaf in params.items():
        name = key.replace(".", "_")
        plt.figure(figsize=(4, 3))
        plt.hist(leaf.float().numpy().ravel(), bins=50)
        plt.title(name, fontsize=7)
        plt.tight_layout()
        plt.savefig(output_dir / f"hist_{name}.png", dpi=80)
        plt.close()
    print(f"[model_insight] wrote {len(params)} histograms to {output_dir}")


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("command", choices=["priors", "histograms"])
    p.add_argument("-o", "--output_dir", type=str, default="./model_insight")
    p.add_argument("-cp", "--checkpoint", type=str, default=None)
    p.add_argument("-is", "--input_size", type=int, nargs=3, default=[64, 64, 64])
    p.add_argument("-pl", "--prediction_layers", type=str, default="3 5 7")
    p.add_argument("-bpl", "--boxes_per_location", type=int, default=2)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "priors":
        if args.checkpoint:
            config, _, _ = load_checkpoint(args.checkpoint)
        else:
            layers = [int(x) for x in args.prediction_layers.split()]
            config = SSD3DConfig.create(
                input_size=tuple(args.input_size),
                aspect_ratios={l: [1.0] for l in layers},
                boxes_per_location=args.boxes_per_location,
            )
        return save_prior_boxes(config, args.output_dir)
    if not args.checkpoint:
        raise SystemExit("histograms requires --checkpoint")
    return parameter_histograms(args.checkpoint, args.output_dir)


if __name__ == "__main__":
    main()
