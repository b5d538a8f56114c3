"""Eval CLI: offline metric recomputation from saved prediction JSONs.

Usage:
  python -m mslesions3d_tpu_torch.cli.eval -d <dataset_root> -pd <prediction_dir> -sc 0.3 -iou 0.5

Counterpart of ``mslesions3d_tpu/cli/eval.py``, with the same flags and
files: it reads the min_score_0.0 prediction run of ``cli.predict`` (a hard
requirement, as in the reference's eval.py:87-90), re-filters detections at
a confidence threshold, pairs them with the dataset's ground truth, and
writes metrics_(min_IoU=<x>_min_score=<y>).json beside them. It runs on the
host: nothing here touches the card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.datasets import SyntheticDataModule
from ..ops import metrics as metrics_lib
from .predict import build_datamodule, subject_id


def retrieve_boxes(path_to_dir, subject, confidence_threshold=0.5):
    """Re-filter one subject's saved detections (eval.py:42-58)."""
    path = Path(path_to_dir) / f"sub-{subject_id(subject)}_preds.json"
    with open(path) as f:
        infos = json.load(f).values()

    det_boxes, det_labels, det_scores = [], [], []
    for det_box_frac, _, det_label, det_score in infos:
        if det_score >= confidence_threshold:
            det_boxes.append(det_box_frac)
            det_labels.append(det_label)
            det_scores.append(det_score)
    return (
        np.asarray(det_boxes, np.float32).reshape(-1, 6),
        np.asarray(det_labels, np.int64),
        np.asarray(det_scores, np.float32),
    )


def evaluate(prediction_dir, dataset_path, model_name=None, dataset_name=None,
             predict_subset="train", n_classes=1, percentage=1.0,
             confidence_threshold=0.5, min_iou=0.5, subject=None, datamodule=None,
             channels=None):
    dataset = datamodule or SyntheticDataModule(
        channels=channels,
        data_dir=dataset_path, dataset_name=dataset_name, n_classes=n_classes,
        percentage=percentage, batch_size=32, cache=False, subject=subject,
    )
    dataset.setup("predict")

    prediction_dir = Path(prediction_dir)
    if dataset_name:
        prediction_dir = prediction_dir / dataset_name
    if model_name:
        prediction_dir = prediction_dir / model_name
    prediction_dir = prediction_dir / f"{predict_subset}_set" / "min_score_0.0"
    if not prediction_dir.exists():
        raise FileNotFoundError(
            "Prediction directory does not exist: predictions at min_score=0.0 "
            f"must be generated beforehand ({prediction_dir})"
        )

    gt_boxes, gt_labels = [], []
    det_boxes, det_labels, det_scores = [], [], []
    for batch in dataset.predict_batches(predict_subset):
        for i, subj in enumerate(batch["subjects"]):
            if subj is None or not batch["batch_mask"][i]:
                continue
            try:
                db, dl, ds = retrieve_boxes(prediction_dir, subj, confidence_threshold)
            except FileNotFoundError:
                continue
            mask = batch["box_mask"][i]
            gt_boxes.append(batch["boxes"][i][mask])
            gt_labels.append(batch["labels"][i][mask])
            det_boxes.append(db)
            det_labels.append(dl)
            det_scores.append(ds)

    diffs = [np.zeros(len(l), bool) for l in gt_labels]
    print("\n+-+-+- Computing metrics! +-+-+-+")
    metrics = metrics_lib.calculate_mAP(
        det_boxes, det_labels, det_scores, gt_boxes, gt_labels, diffs,
        n_classes=n_classes + 1, min_overlap=min_iou, return_detail=True,
    )

    print(f"\nAP for IoU = {min_iou} / min score = {confidence_threshold}")
    for key in ("mAP", "precision", "recall", "f1_score"):
        print(f"{key}: ", metrics[key])

    metrx = metrics_lib.to_jsonable(metrics)

    out = prediction_dir / f"metrics_(min_IoU={min_iou}_min_score={confidence_threshold}).json"
    with open(out, "w") as f:
        json.dump(metrx, f, indent=4)
    print(f"[eval] wrote {out}")
    return metrx


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-d", "--dataset_path", type=str, default="../data/artificial_dataset")
    p.add_argument("-dn", "--dataset_name", type=str, default=None)
    p.add_argument("--channels", type=int, nargs="*", default=None,
                   help="channel subset of multi-contrast volumes (e.g. 0 for FLAIR-only)")
    p.add_argument("-mn", "--model_name", type=str, default=None)
    p.add_argument("-p", "--percentage", type=float, default=1.0)
    p.add_argument("-c", "--n_classes", type=int, default=1)
    p.add_argument("-nw", "--num_workers", type=int, default=8)
    p.add_argument("-ps", "--predict_subset", type=str,
                   choices=["train", "validation", "test", "all"], default="train")
    p.add_argument("-sc", "--min_score", type=float, default=0.5)
    p.add_argument("-iou", "--min_iou", type=float, default=0.5)
    p.add_argument("-k", "--top_k", type=int, default=100)
    p.add_argument("-pd", "--prediction_dir", type=str, default="../data/predictions/")
    p.add_argument("-dt", "--dataset_type", type=str, default="synthetic",
                   choices=["synthetic", "lesions"])
    p.add_argument("-su", "--subject", type=str, default=None)
    p.add_argument("--centers", type=str, nargs="*",
                   default=["CHUV_RIM_OK", "BASEL_INSIDER_OK"])
    p.add_argument("--input_images", type=str, nargs="*", default=["FLAIR"])
    p.add_argument("--segmentation", type=str, default="labeled_lesions")
    p.add_argument("--spatial_size", type=int, nargs=3, default=[250, 300, 300])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(f"Confidence threshold set to {args.min_score}")
    return evaluate(
        args.prediction_dir, args.dataset_path, model_name=args.model_name,
        dataset_name=args.dataset_name, predict_subset=args.predict_subset,
        n_classes=args.n_classes, percentage=args.percentage,
        confidence_threshold=args.min_score, min_iou=args.min_iou,
        datamodule=build_datamodule(args) if args.dataset_type == "lesions" else None,
        channels=args.channels,
    )


if __name__ == "__main__":
    main()
