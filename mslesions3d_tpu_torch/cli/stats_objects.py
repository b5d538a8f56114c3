"""Dataset statistics: histograms of GT box length/width/depth/volume.

Usage:
  python -m mslesions3d_tpu_torch.cli.stats_objects -d <dataset_root> [-o DIR]

Counterpart of ``mslesions3d_tpu/cli/stats_objects.py`` (the reference's
lesions3d/stats_objects.py:7-47, run over a datamodule's training
subjects). ``collect_box_stats`` is host numpy; ``main`` draws with
matplotlib, which it imports when it runs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .model_insight import require


def collect_box_stats(datamodule, subjects=None):
    lengths, widths, depths, volumes = [], [], [], []
    for subj in subjects if subjects is not None else datamodule.trainsubs:
        sample = datamodule.get_sample(subj)
        boxes = sample["boxes"]
        shape = np.asarray(sample["img"].shape[:3], np.float32)
        for b in boxes:
            dims = (b[3:] - b[:3]) * shape
            lengths.append(float(dims[0]))
            widths.append(float(dims[1]))
            depths.append(float(dims[2]))
            volumes.append(float(dims[0] * dims[1] * dims[2]))
    return {"length": lengths, "width": widths, "depth": depths, "volume": volumes}


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-d", "--dataset_path", type=str, required=True)
    p.add_argument("-dn", "--dataset_name", type=str, default=None)
    p.add_argument("-c", "--n_classes", type=int, default=1)
    p.add_argument("-p", "--percentage", type=float, default=1.0)
    p.add_argument("-o", "--output_dir", type=str, default="./stats")
    return p


def main(argv=None):
    matplotlib = require("matplotlib", "stats_objects")
    matplotlib.use("Agg")
    plt = require("matplotlib.pyplot", "stats_objects")

    from ..data.datasets import SyntheticDataModule

    args = build_parser().parse_args(argv)
    dm = SyntheticDataModule(
        data_dir=args.dataset_path, dataset_name=args.dataset_name,
        n_classes=args.n_classes, percentage=args.percentage, cache=False,
    )
    dm.setup("fit")
    stats = collect_box_stats(dm)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for key, values in stats.items():
        plt.figure(figsize=(5, 3))
        plt.hist(values, bins=30)
        plt.title(f"GT box {key} (n={len(values)})")
        plt.tight_layout()
        plt.savefig(out / f"boxes_{key}.png", dpi=100)
        plt.close()
        print(f"[stats] {key}: mean={np.mean(values):.2f} min={np.min(values):.2f} "
              f"max={np.max(values):.2f}")
    return stats


if __name__ == "__main__":
    main()
