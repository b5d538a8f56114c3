"""Metric plots: heatmaps of mAP/precision/recall/F1 vs (IoU x score threshold).

Usage:
  python -m mslesions3d_tpu_torch.cli.plots -pd <prediction_dir> [-o DIR]

Counterpart of ``mslesions3d_tpu/cli/plots.py`` (the reference's
lesions3d/plots.py:57-129): it reads ``cli.eval``'s
metrics_(min_IoU=<x>_min_score=<y>).json files from a prediction directory
and renders one heatmap per metric, and found / not-found lesion-size
boxplots. Reading the files is plain Python; drawing needs matplotlib,
seaborn, pandas and scipy, imported by the functions that draw.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from .model_insight import require

METRIC_FILE = re.compile(r"metrics_\(min_IoU=(?P<iou>[\d.]+)_min_score=(?P<score>[\d.]+)\)\.json")


def metric_files(prediction_dir):
    """Yield (iou, score, metrics dict) for each ``cli.eval`` metric file,
    in file-name order."""
    for path in sorted(Path(prediction_dir).glob("metrics_*.json")):
        m = METRIC_FILE.match(path.name)
        if m:
            yield float(m["iou"]), float(m["score"]), json.loads(path.read_text())


def load_metric_grid(prediction_dir):
    """Collect metric JSONs into {metric: {(iou, score): value}}."""
    grids: dict = {}
    for iou, score, data in metric_files(prediction_dir):
        for key in ("mAP", "precision", "recall", "f1_score"):
            if isinstance(data.get(key), (int, float)):
                grids.setdefault(key, {})[(iou, score)] = float(data[key])
    return grids


def operating_points(prediction_dir) -> dict:
    """One scored run reduced as tools/quality_stats.py reduces it (without
    its rounding): per IoU, the largest mAP and the best F1 over the score
    grid, with the scores they are at. A per-class F1 dict counts as its mean."""
    by_iou: dict = {}
    for iou, score, data in metric_files(prediction_dir):
        by_iou.setdefault(iou, {})[score] = data
    out = {}
    for iou, by_score in sorted(by_iou.items()):
        f1 = {sc: (sum(d["f1_score"].values()) / max(len(d["f1_score"]), 1)
                   if isinstance(d["f1_score"], dict) else float(d["f1_score"]))
              for sc, d in by_score.items()}
        mAP = {sc: d["mAP"] for sc, d in by_score.items()}
        best_map, best_f1 = max(mAP, key=mAP.get), max(f1, key=f1.get)
        out[f"mAP@{iou}"], out[f"mAP@{iou}_at_score"] = mAP[best_map], best_map
        out[f"best_f1@{iou}"], out[f"best_f1@{iou}_at_score"] = f1[best_f1], best_f1
    return out


def _pyplot():
    matplotlib = require("matplotlib", "plots")
    matplotlib.use("Agg")
    return require("matplotlib.pyplot", "plots")


def plot_metric(grids, metric, output_dir):
    plt = _pyplot()
    pd = require("pandas", "plots' heatmaps")
    sns = require("seaborn", "plots' heatmaps")

    cells = grids[metric]
    ious = sorted({k[0] for k in cells})
    scores = sorted({k[1] for k in cells})
    table = pd.DataFrame(
        [[cells.get((i, s), float("nan")) for s in scores] for i in ious],
        index=ious, columns=scores,
    )
    plt.figure(figsize=(1 + len(scores), 1 + 0.6 * len(ious)))
    sns.heatmap(table, annot=True, fmt=".3f", cmap="viridis", vmin=0, vmax=1)
    plt.xlabel("min score")
    plt.ylabel("min IoU")
    plt.title(metric)
    plt.tight_layout()
    out = Path(output_dir) / f"heatmap_{metric}.png"
    plt.savefig(out, dpi=110)
    plt.close()
    return out


def _volume_lists(data):
    """Extract (found, not_found) volume lists from an eval metrics dict.

    Binary collapse stores flat lists; multi-class stores per-class dicts
    (ops/metrics.py) — flatten either form.
    """
    def flat(v):
        if isinstance(v, dict):
            return [x for lst in v.values() for x in lst]
        return list(v or [])

    return (flat(data.get("found_boxes_volumes_per_class")),
            flat(data.get("not_found_boxes_volumes_per_class")))


def plot_found_volumes(prediction_dir, output_dir, volume_size: int = 64):
    """Found vs not-found lesion-volume boxplots with one-sided t-tests.

    Parity target: the reference's commented-out boxplot block
    (lesions3d/plots.py:85-129): per (IoU, score) metrics file, paired
    green/red boxplots of found / not-found GT box edge length in voxels
    (volumes are fractional; edge = (v * S^3)^(1/3) with S=volume_size,
    matching the reference's v() helper), annotated with the p-value of
    ttest_ind(found > not_found).
    """
    import numpy as np

    plt = _pyplot()
    mpatches = require("matplotlib.patches", "plots")
    ttest_ind = require("scipy.stats", "plots' t-tests").ttest_ind

    def edge(lst):
        return (np.asarray(lst, np.float64) * volume_size**3) ** (1.0 / 3.0)

    groups = []  # (iou, score, found_edges, not_found_edges, pvalue)
    for iou, score, data in metric_files(prediction_dir):
        found, not_found = _volume_lists(data)
        if not found and not not_found:
            continue
        f, nf = edge(found), edge(not_found)
        if f.size > 1 and nf.size > 1:
            p = float(ttest_ind(f, nf, alternative="greater").pvalue)
        else:
            p = float("nan")
        groups.append((iou, score, f, nf, p))
    if not groups:
        return None

    fig, ax = plt.subplots(figsize=(2 + 2.2 * len(groups), 5))
    positions, centers = [], []
    data = []
    for g, (_iou, _score, f, nf, _p) in enumerate(groups):
        base = 1 + 1.5 * g
        positions += [base, base + 0.6]
        centers.append(base + 0.3)
        data += [f, nf]
    boxes = ax.boxplot(data, positions=positions, patch_artist=True,
                       labels=["Found", "Not Found"] * len(groups))
    for i, box in enumerate(boxes["boxes"]):
        box.set(color="limegreen" if i % 2 == 0 else "tomato")
    for med in boxes["medians"]:
        med.set(color="black")
    ax.set_xticks(centers)
    ax.set_xticklabels([
        f"IoU > {iou}\nScore > {sc}\np-value(v(F) > v(NF))={p:.3g}"
        for iou, sc, _f, _nf, p in groups
    ])
    green = mpatches.Patch(color="limegreen", label="Found boxes")
    red = mpatches.Patch(color="tomato", label="Not found boxes")
    ax.legend(handles=[green, red], loc="upper right")
    ax.set_title("Boxes Volume")
    ax.set_ylabel("Edge length in voxels")
    plt.tight_layout()
    out = Path(output_dir) / "boxplot_found_volumes.png"
    plt.savefig(out, dpi=110)
    plt.close(fig)
    return out


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-pd", "--prediction_dir", type=str, required=True,
                   help="directory containing metrics_(min_IoU=..._min_score=...).json files")
    p.add_argument("-o", "--output_dir", type=str, default=None)
    p.add_argument("--volume_size", type=int, default=64,
                   help="cube edge used to convert fractional volumes to "
                        "voxel edge lengths in the found/not-found boxplot")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_dir = Path(args.output_dir or args.prediction_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    grids = load_metric_grid(args.prediction_dir)
    if not grids:
        raise SystemExit(f"no metrics_*.json files found in {args.prediction_dir}")
    for metric in grids:
        path = plot_metric(grids, metric, out_dir)
        print(f"[plots] {metric} -> {path}")
    bp = plot_found_volumes(args.prediction_dir, out_dir, args.volume_size)
    if bp is not None:
        print(f"[plots] found/not-found volumes -> {bp}")


if __name__ == "__main__":
    main()
