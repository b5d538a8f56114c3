"""Predict CLI: checkpoint -> saved detections + per-subject metrics.

Usage:
  python -m mslesions3d_tpu_torch.cli.predict -d <dataset_root> -m <checkpoint_dir> [...]

Counterpart of ``mslesions3d_tpu/cli/predict.py`` with the same flags,
defaults and files, except that the JAX package's ``--platform`` is
``--device`` here: the card (``cuda``, the default; it raises without one)
or ``cpu``. Per subject it writes:
  sub-<id>_preds.nii.gz   wireframe NIfTI of detected boxes (instance ids)
  sub-<id>_preds.csv      (label_id, score) table, as pandas' ``to_csv`` writes it
  sub-<id>_preds.json     {id: (frac_box, voxel_box, label, score)}
plus aa_metrics_per_subject_(min_IoU=0.5).json / (min_IoU=0.1).json, under
the reference layout <out>/<dataset>/<model>/<subset>_set/min_score_<s>/.
Each predict batch runs the predict step, whose ``detect_objects`` launches
the NMS kernel K1 on the card (and K2 / K3 when the checkpoint's config sets
``use_pallas`` / ``use_pallas_tail``). With ``-sw 1`` each volume is tiled
into the checkpoint's input size and stitched (``sliding_window.py``: K1
on every chunk of patches and at the stitch); ``-vb N`` buffers N
same-shape volumes and runs their patch grids in shared device batches. A
float32 checkpoint is scored in IEEE float32: TF32 is off for convolutions
and matmuls, as in training. ``--sw_data_parallel 1`` shards every chunk of
sliding-window patches over all visible devices of ``--device``'s kind
(``parallel.visible_devices``), as the JAX CLI shards over all chips; the
files are those of the run without it.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from ..data.boxes_from_seg import segmentation_from_boxes
from ..data.datasets import LesionsDataModule, SyntheticDataModule
from ..data.nifti import save_nifti
from ..data.transforms import inverse_map_boxes
from ..models.ssd3d import SSD3D, model_priors
from ..ops import metrics as metrics_lib
from ..ops.nms import detections_to_lists
from ..parallel.mesh import visible_devices
from ..sliding_window import make_sliding_window_detector
from ..train.checkpoints import load_checkpoint
from ..train.state import (create_train_state, eval_view, resolve_device,
                           use_ieee_float32)
from ..train.steps import make_predict_step
from ..utils.prefetch import prefetch

PREDICT_SEED = 970205


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-d", "--dataset_path", type=str, default="../data/artificial_dataset")
    p.add_argument("-dn", "--dataset_name", type=str, default=None)
    p.add_argument("--channels", type=int, nargs="*", default=None,
                   help="channel subset of multi-contrast volumes (e.g. 0 for FLAIR-only)")
    p.add_argument("-m", "--model_path", type=str, required=True,
                   help="path to a checkpoint directory")
    p.add_argument("-mn", "--model_name", type=str, default=None)
    p.add_argument("-p", "--percentage", type=float, default=1.0)
    p.add_argument("-su", "--subject", type=str, default=None)
    p.add_argument("-c", "--n_classes", type=int, default=1)
    p.add_argument("-nw", "--num_workers", type=int, default=8)
    p.add_argument("-ps", "--predict_subset", type=str,
                   choices=["train", "validation", "test", "all"], default="train")
    p.add_argument("-sc", "--min_score", type=float, default=0.5)
    p.add_argument("-k", "--top_k", type=int, default=100)
    p.add_argument("-mo", "--max_overlap", type=float, default=None,
                   help="NMS suppression IoU (default: the checkpoint's "
                        "trained config value)")
    p.add_argument("-o", "--output_dir", type=str, default="../data/predictions/")
    p.add_argument("-si", "--save_images", type=int, default=1)
    p.add_argument("-sw", "--sliding_window", type=int, default=0,
                   help="tile volumes larger than the model input with "
                        "overlapping patches + on-device stitching")
    p.add_argument("--overlap", type=float, default=0.25,
                   help="sliding-window patch overlap fraction")
    p.add_argument("-vb", "--volume_batch", type=int, default=1,
                   help="sliding-window throughput mode: batch this many "
                        "same-shape volumes' patch grids into shared device batches")
    p.add_argument("--per_patch_k", type=int, default=None,
                   help="sliding-window: detections kept per patch before "
                        "stitching (default max(top_k // 2, 16))")
    p.add_argument("--sw_data_parallel", type=int, default=0,
                   help="sliding-window: shard patch batches over all "
                        "visible cards (multi-card full-volume serving)")
    p.add_argument("--use_ema", type=int, default=1,
                   help="score the EMA weights when the checkpoint carries "
                        "them (training with --ema_decay > 0); 0 = raw params")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host batches assembled ahead on a background thread "
                        "while the device runs (0 = off)")
    p.add_argument("-dt", "--dataset_type", type=str, default="synthetic",
                   choices=["synthetic", "lesions"])
    p.add_argument("--centers", type=str, nargs="*",
                   default=["CHUV_RIM_OK", "BASEL_INSIDER_OK"])
    p.add_argument("--input_images", type=str, nargs="*", default=["FLAIR"])
    p.add_argument("--segmentation", type=str, default="labeled_lesions")
    p.add_argument("--spatial_size", type=int, nargs=3, default=[250, 300, 300])
    p.add_argument("--device", type=str, default="cuda",
                   help="where to predict: cuda (the card; raises without one) or cpu")
    return p


def build_datamodule(args):
    if args.dataset_type == "lesions":
        return LesionsDataModule(
            data_dir=args.dataset_path, centers=tuple(args.centers),
            input_images=tuple(args.input_images), segmentation=args.segmentation,
            subject=args.subject, percentage=args.percentage, batch_size=1,
            cache=True, spatial_size=tuple(args.spatial_size),
        )
    return SyntheticDataModule(
        channels=args.channels,
        data_dir=args.dataset_path, dataset_name=args.dataset_name,
        n_classes=args.n_classes, subject=args.subject, percentage=args.percentage,
        batch_size=1, cache=True,
    )


def subject_id(subj) -> str:
    """Filename-safe subject id ((center, sub) tuples -> center_sub)."""
    if isinstance(subj, (tuple, list)):
        return "_".join(str(s) for s in subj)
    return str(subj)


def write_scores_csv(path, scores_map) -> None:
    """The (label_id, score) table byte for byte as pandas'
    ``DataFrame(scores_map, columns=["label_id", "score"]).to_csv(path)``
    writes it: an unnamed index column, "\\n" line ends, ints and floats by
    their shortest repr."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["", "label_id", "score"])
        for i, (label_id, score) in enumerate(scores_map):
            writer.writerow([i, int(label_id), float(score)])


def save_subject_predictions(output_dir, subject, image_shape, boxes, labels, scores,
                             affine=None, min_score=0.5, save_images=True,
                             transform_meta=None, orig_shape=None,
                             orig_affine=None):
    """Write the reference's three per-subject artifacts (predict.py:155-232).

    When the sample was preprocessed with recorded transform_meta (BIDS
    pipeline), two more artifacts are written in the original space, the
    equivalents of the reference's MONAI inverse-transform save path
    (predict.py:284-304):
      sub-<id>_preds_origspace.json     inverse-mapped voxel boxes on the
                                        original on-disk grid
      sub-<id>_preds_origspace.nii.gz   the detection wireframes painted on
                                        that grid, saved with the original
                                        affine (requires orig_shape)
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    stem = output_dir / f"sub-{subject_id(subject)}_preds"

    scores_map = []
    all_infos = {}
    keep_boxes, keep_labels = [], []
    for j in range(len(boxes)):
        score = float(scores[j])
        scores_map.append((j + 1, score))
        if score < min_score or int(labels[j]) == 0:
            continue
        frac = [float(v) for v in boxes[j]]
        vox = (np.clip(boxes[j], 0, 1) * np.asarray(image_shape * 2)).astype(int).tolist()
        all_infos[j + 1] = (frac, vox, int(labels[j]), score)
        keep_boxes.append(boxes[j])
        keep_labels.append(j + 1)  # instance ids in the wireframe volume

    if save_images:
        if keep_boxes:
            # class_map paints the label value, i.e. the original detection id
            _, painted = segmentation_from_boxes(
                np.asarray(keep_boxes), keep_labels, tuple(image_shape)
            )
        else:
            painted = np.zeros(image_shape, np.float32)
        # the wireframe lives on the preprocessed grid; an anatomical affine
        # would misplace it over the raw image, so identity unless the grid
        # is the original one (no recorded transforms)
        wire_affine = affine if (affine is not None and not transform_meta) else np.eye(4)
        save_nifti(f"{stem}.nii.gz", painted, wire_affine)

    write_scores_csv(f"{stem}.csv", scores_map)
    with open(f"{stem}.json", "w") as f:
        json.dump(all_infos, f)

    if transform_meta and keep_boxes:
        orig = inverse_map_boxes(np.asarray(keep_boxes), image_shape, transform_meta)
        orig_infos = {j: [float(v) for v in box] for j, box in zip(keep_labels, orig)}
        with open(f"{stem}_origspace.json", "w") as f:
            json.dump(orig_infos, f)

        if save_images and orig_shape is not None:
            # the wireframes painted on the original on-disk grid and saved
            # with the original affine overlay the raw image
            orig_shape = tuple(int(s) for s in orig_shape)
            frac = np.clip(
                orig / np.asarray(orig_shape * 2, np.float64), 0.0, 1.0
            ).astype(np.float32)
            nondegenerate = np.all(frac[:, 3:] > frac[:, :3], axis=-1)
            if nondegenerate.any():
                _, painted_orig = segmentation_from_boxes(
                    frac[nondegenerate],
                    [l for l, nd in zip(keep_labels, nondegenerate) if nd],
                    orig_shape,
                )
            else:
                painted_orig = np.zeros(orig_shape, np.float32)
            save_nifti(f"{stem}_origspace.nii.gz", painted_orig,
                       orig_affine if orig_affine is not None else np.eye(4))


def predict_dataset(dataset, state, config, predict_subset="train", min_score=0.5,
                    top_k=100, output_dir=None, save_images=True,
                    sliding_window=False, overlap=0.25, max_overlap=None,
                    volume_batch=1, per_patch_k=None, prefetch_depth=2, mesh=None,
                    predict_step=None):
    """Run detection over a subset on the state's device; returns
    per-subject ragged results and their ground truth.

    With ``sliding_window`` volumes are tiled into model-sized patches and
    stitched on the device (``sliding_window.py``), one detector per volume
    shape. ``volume_batch > 1`` is the sliding-window throughput mode:
    same-shape subjects are buffered and their patch grids run through one
    detector in shared device batches (a last partial stack is padded with
    empty volumes whose results are dropped). ``max_overlap`` overrides the
    checkpoint's NMS suppression IoU. ``prefetch_depth`` assembles host
    batches (NIfTI load, box derivation) on a background thread while the
    card runs (``utils/prefetch.py``); 0 disables it. ``mesh`` (a tuple of
    devices) shards the sliding window's patches over them. ``predict_step``
    (fn(state, images) -> padded detections) scores the model-sized batches
    in place of the model's own step: an int8 program, for one.
    """
    step = predict_step or make_predict_step(config, SSD3D(config), model_priors(config),
                                             min_score=min_score, top_k=top_k,
                                             max_overlap=max_overlap)
    sw_detectors = {}

    def sw_detect(images, n_volumes):  # (V, D, H, W, C), stacked same-shape volumes
        key = (tuple(images.shape[1:4]), n_volumes)
        if key not in sw_detectors:
            sw_detectors[key] = make_sliding_window_detector(
                config, key[0], overlap=overlap, min_score=min_score, top_k=top_k,
                max_overlap=max_overlap, per_patch_k=per_patch_k, volume_batch=n_volumes,
                mesh=mesh)
        return sw_detectors[key](state, images)

    results, gt = {}, {}

    def emit(subj, db, dl, ds, gt_boxes, gt_labels):
        results[subj] = (db, dl, ds)
        gt[subj] = (gt_boxes, gt_labels)
        if output_dir is not None:
            sample = dataset.get_sample(subj)
            save_subject_predictions(
                output_dir, subj, sample["img"].shape[:3], db, dl, ds,
                affine=sample.get("affine"), min_score=min_score,
                save_images=save_images,
                transform_meta=sample.get("transform_meta"),
                orig_shape=sample.get("orig_shape"),
                orig_affine=sample.get("orig_affine"),
            )

    batches = prefetch(dataset.predict_batches(predict_subset), prefetch_depth)
    if sliding_window and volume_batch > 1:
        pending: dict = {}

        def flush(entries):
            imgs = np.stack([e[1] for e in entries])
            v = imgs.shape[0]
            if v < volume_batch:  # pad the last partial stack, drop its results
                imgs = np.concatenate(
                    [imgs, np.zeros((volume_batch - v, *imgs.shape[1:]), imgs.dtype)])
            db, dl, ds = detections_to_lists(sw_detect(imgs, volume_batch))
            for i, (subj, _img, gb, gl) in enumerate(entries):
                emit(subj, db[i], dl[i], ds[i], gb, gl)

        for batch in batches:
            for i, subj in enumerate(batch["subjects"]):
                if subj is None or not batch["batch_mask"][i]:
                    continue
                mask = batch["box_mask"][i]
                image = batch["image"][i]
                shape = image.shape[:3]
                pending.setdefault(shape, []).append(
                    (subj, image, batch["boxes"][i][mask], batch["labels"][i][mask]))
                if len(pending[shape]) == volume_batch:
                    flush(pending.pop(shape))
        for entries in pending.values():
            flush(entries)
        return results, gt

    for batch in batches:
        images = batch["image"]
        if sliding_window:
            dets = [sw_detect(images[i][None], 1) for i in range(images.shape[0])]
            det = {k: torch.cat([d[k] for d in dets]) for k in dets[0]}
        else:
            if tuple(images.shape[1:4]) != tuple(config.input_size):
                raise SystemExit(
                    f"volumes are {tuple(images.shape[1:4])} but the "
                    f"checkpoint's input size is {tuple(config.input_size)} "
                    "(e.g. a patch-trained model) — run full volumes with "
                    "sliding-window inference: predict -sw 1"
                )
            det = step(state, images)
        db, dl, ds = detections_to_lists(det)
        for i, subj in enumerate(batch["subjects"]):
            if subj is None or not batch["batch_mask"][i]:
                continue
            mask = batch["box_mask"][i]
            emit(subj, db[i], dl[i], ds[i], batch["boxes"][i][mask], batch["labels"][i][mask])
    return results, gt


def compute_subjects_mAP(results, gt, n_classes, min_iou, output_dir=None):
    """Per-subject detail metrics (predict.py:87-152)."""
    all_metrics = {}
    for subj, (db, dl, ds) in results.items():
        gb, gl = gt[subj]
        detail = metrics_lib.calculate_mAP(
            [db], [dl], [ds], [gb], [gl], [np.zeros(len(gl), bool)],
            n_classes=n_classes, min_overlap=min_iou, return_detail=True,
        )
        all_metrics[subject_id(subj)] = metrics_lib.to_jsonable(
            {k: v for k, v in detail.items() if k != "sorted_det_scores"}
        )
    if output_dir is not None:
        path = Path(output_dir) / f"aa_metrics_per_subject_(min_IoU={min_iou}).json"
        with open(path, "w") as f:
            json.dump(all_metrics, f, indent=4)
    return all_metrics


def load_predict_state(model_path, device, use_ema=True):
    """(config, the state predict scores) from a checkpoint directory, on
    ``device``: the EMA view when ``use_ema`` and the checkpoint carries one."""
    config, _, _ = load_checkpoint(model_path)
    template = create_train_state(config, seed=0, device=device)
    _, state, _ = load_checkpoint(model_path, state_template=template)
    return config, eval_view(state) if use_ema else state


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "cli.predict")
    use_ieee_float32()
    mesh = None
    if args.sw_data_parallel:
        mesh = visible_devices(device)
        print(f"[predict] sliding-window patches sharded over {len(mesh)} device(s): "
              f"{', '.join(str(d) for d in mesh)}")
    np.random.seed(PREDICT_SEED)

    subsets = (["train", "validation", "test"] if args.predict_subset == "all"
               else [args.predict_subset])

    out_root = Path(args.output_dir)
    if args.dataset_name:
        out_root = out_root / args.dataset_name
    if args.model_name:
        out_root = out_root / args.model_name
    out_root.mkdir(parents=True, exist_ok=True)
    ckpt_copy = out_root / Path(args.model_path).name
    if not ckpt_copy.exists():
        shutil.copytree(args.model_path, ckpt_copy)

    dataset = build_datamodule(args)
    dataset.setup("predict")
    config, state = load_predict_state(args.model_path, device, bool(args.use_ema))

    for subset in subsets:
        output_dir = out_root / f"{subset}_set" / f"min_score_{args.min_score}"
        results, gt = predict_dataset(
            dataset, state, config, subset, args.min_score, args.top_k,
            output_dir, bool(args.save_images),
            sliding_window=bool(args.sliding_window), overlap=args.overlap,
            max_overlap=args.max_overlap, volume_batch=args.volume_batch,
            per_patch_k=args.per_patch_k, prefetch_depth=args.prefetch, mesh=mesh,
        )
        for min_iou in (0.5, 0.1):
            m = compute_subjects_mAP(results, gt, config.n_classes, min_iou, output_dir)

            def _scalar_f1(v):
                f1 = v["f1_score"]
                return np.mean(list(f1.values())) if isinstance(f1, dict) else f1

            mean_f1 = np.mean([_scalar_f1(v) for v in m.values()]) if m else float("nan")
            print(f"[predict] subset={subset} IoU={min_iou} min_score={args.min_score} "
                  f"subjects={len(m)} mean_f1={mean_f1:.3f}")
    return 0


if __name__ == "__main__":
    main()
