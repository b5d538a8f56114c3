"""The JAX package's 4k headline recipe, in the port's CLI flags.

Its dataset (quality_artifacts/README.md:41-44), its training flags
(tools/quality_r5_campaign.sh:11) at 4000 steps, and its scoring (:15-24):
predict the validation split at min_score 0.0 and top_k 100, then
``cli.eval`` over IoU {0.1, 0.5} x min_score {0.1, 0.2, 0.3, 0.5, 0.7}.
``cli.plots.operating_points`` reduces one scored run as the JAX package's
quality summary does.
"""

from __future__ import annotations

DATA = dict(num_images=200, image_size=(64, 64, 64), object_size=(6, 14), num_objects=(1, 5),
            seed=0)
TRAIN_FLAGS = ["-b", "8", "-lr", "0.003", "-th", "0.1", "0.2", "-bpl", "3", "--alpha", "2",
               "-a", "flip", "rotate90", "zoom", "-sr", "cosine_annealed",
               "--hard_negative_mining", "1", "-es", "0"]  # the step count goes in -mi
STEPS = 4000
PREDICT_FLAGS = ["-ps", "validation", "-sc", "0.0", "-k", "100"]
EVAL_GRID = tuple((iou, sc) for iou in (0.1, 0.5) for sc in (0.1, 0.2, 0.3, 0.5, 0.7))


def evaluate_grid(dataset_path, prediction_dir) -> None:
    """``cli.eval`` of a validation run at every grid point; the metric files
    land beside the predictions (``<prediction_dir>/validation_set/min_score_0.0``)."""
    from . import eval as eval_cli

    for iou, sc in EVAL_GRID:
        eval_cli.main(["-d", str(dataset_path), "-pd", str(prediction_dir), "-ps", "validation",
                       "-sc", str(sc), "-iou", str(iou)])
