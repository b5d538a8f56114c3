"""Training loop: epochs, validation, detection metrics, checkpoints, early stop.

Counterpart of ``mslesions3d_tpu/train/loop.py``, which replaces pl.Trainer
and the LSSD3D Lightning hooks (lesions3d/train.py:182-188,
ssd3d.py:467-691) with an explicit loop around the steps:

* per-step cosine schedule (inside the optimizer: the scheduler-stepped-
  every-step quirk, ssd3d.py:527-529);
* validation every epoch, scored on ``eval_view`` (the EMA when carried):
  losses averaged over batches weighted by the real sample count, so a
  padded partial batch does not bias the mean -> avg_val_loss;
* detection metrics (mAP/P/R/F1 at IoU 0.1 and 0.5) on validation every
  ``compute_metric_every_n_epochs`` epochs and on train every 2n epochs
  (ssd3d.py:499, 563), computed per batch and averaged over batches like
  the reference's *_epoch_end hooks (ssd3d.py:588-690); train metrics come
  from the training forward (the augmented batch). Each of these steps
  runs ``detect_objects``, so on the card it launches the NMS kernel K1;
* gradient histograms every ``grad_hist_every_n_steps`` steps and the
  parameter-L1 scalar hp_metric/parameter_sizes on train-metric epochs
  (ssd3d.py:689-690, 729-738);
* ModelCheckpoint(top-3, avg_val_loss, min) + EarlyStopping(patience 5)
  (train.py:171-180); resume from a checkpoint directory;
* stop on max_steps (default 4000) or max_epochs (train.py:57-58, 182).

The dataset is held on the device when it fits (``materialize`` once,
batches gathered there by index); otherwise batches stream from the host
through ``data/prefetch.py``. Per-step metrics stay on the device: the host
reads them on the logging cadence and once at the end of an epoch, so the
steps queue ahead of the card. The non-finite-loss streak is carried on the
device in the TrainState and checked on the same cadence.

With ``epoch_scan`` (the default) an epoch that logs no train metrics, on a
device-resident cache without a mesh, runs as one whole-epoch program
(``steps.make_gathered_train_epoch``), as the JAX package scans it: on the
card one captured CUDA graph replayed a batch, on the CPU a plain loop. Its
metrics come back in one transfer at the end, are logged on the same
cadence, and no gradient histograms are logged in it (the JAX package's
scanned epoch logs none). Both give the stepped loop's numbers.

With ``patch_training`` the dataset holds full-resolution volumes: each
train step crops fresh lesion-biased patches of ``config.input_size`` on
the device, validation's loss takes a deterministic crop, and on metric
epochs (``patch_val_full_volume``) every validation volume is also scored
whole through the sliding window (``sliding_window.py``), logged as
``mAP/validation_full_*``; the crop's loss stays the checkpoint monitor.

``data_parallel`` trains over a data mesh (``parallel.make_mesh``: one
rank a card, under ``torchrun``, or a world of one without it), as the JAX
package's data mesh does. The dataset is sharded over the ranks' cards
(``n_local = ceil(n_train / W)`` volumes a rank, padded with wrap-around
duplicates; each rank materializes only its shard) and every epoch each
rank shuffles its shard, from the JAX package's index stream (with
``grad_accum > 1`` the ranks then exchange rows so that each holds its share
of every micro-batch); without the cache, every rank streams its rows of
each global batch. A batch (or micro-batch) that does not divide over the ranks
raises before anything is loaded. Validation streams
the same way; its losses are the global batch's and the detections and
ground truth of every rank are gathered for the host mAP. Rank 0 alone
writes checkpoints, ``metrics.jsonl``, TensorBoard and the printed lines;
every rank resumes from the same checkpoint, and the steps keep the states
equal, so early stopping, ``max_steps`` and the non-finite abort end every
rank on the same step (the decision to stop is rank 0's, broadcast).

``spatial_shards`` = S > 1 trains on a data x spatial mesh
(``parallel.make_mesh_2d``), as the JAX package does: the world (torchrun's)
must divide by S, the config's depth too, and the data axis is the world's
ranks / S with ``data_parallel`` (else 1). A batch that does not divide
over the data axis raises, naming the world to launch (the JAX package
caps the axis by ``gcd`` and leaves the other devices idle; here the world
is the mesh), and so does a world larger than the mesh. The batches
stream, as the JAX package keeps no device cache under a spatial mesh;
each rank takes its rows of every batch (``parallel.shard_batch``) and the
steps keep its depth slab.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..data.augment import AugmentConfig
from ..data.prefetch import prefetch_batches
from ..models.ssd3d import SSD3D, SSD3DConfig, model_priors
from ..ops import metrics as metrics_lib
from ..ops.nms import detections_to_lists
from ..parallel.collectives import broadcast, gather_rows
from ..parallel.mesh import make_mesh, make_mesh_2d, replicate, row_runs, shard_batch
from ..sliding_window import make_sliding_window_detector
from .checkpoints import CheckpointManager, load_checkpoint
from .graphs import EPOCH_METRICS
from .logging import MetricsLogger
from .state import create_train_state, eval_view, make_optimizer
from .steps import (
    make_eval_step,
    make_gathered_eval_step,
    make_gathered_train_epoch,
    make_gathered_train_step,
    make_sharded_gathered_train_step,
    make_train_step,
)


LOSSES = ("total_loss", "conf_loss", "loc_loss")


def array_batch(batch: dict) -> dict:
    """Array-only view of a batch dict (drops the subject ids)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


@dataclasses.dataclass
class TrainerConfig:
    logdir: str = "./logs"
    experiment_name: str = "default"
    max_epochs: int | None = None
    max_steps: int = 4000
    early_stopping: bool = True
    early_stopping_patience: int = 5
    compute_metric_every_n_epochs: int = 1
    save_top_k: int = 3
    seed: int = 970205
    use_wandb: bool = False
    # one rank a card over a data mesh (parallel/mesh.py); a world of one
    # outside torchrun
    data_parallel: bool = False
    # > 1 splits the volume depth over that many ranks (a data x spatial mesh)
    spatial_shards: int = 1
    # train on random lesion-biased patches of config.input_size cropped on
    # the device from full-resolution volumes (data/patches.py); validation
    # uses a deterministic lesion-centred crop. The datamodule must yield
    # volumes >= the patch on every axis.
    patch_training: bool = False
    patch_pos_fraction: float = 0.7
    # > 1 splits each batch into that many micro-batches whose gradients
    # are averaged before ONE optimizer update (steps.py)
    grad_accum: int = 1
    # under patch training, also score whole validation volumes through the
    # sliding window on the metric cadence (mAP/validation_full_*); the
    # crop's loss stays the checkpoint monitor
    patch_val_full_volume: bool = True
    hard_negative_mining: bool = False
    # keep the materialized dataset on the device and gather batches there
    # by index; streaming (with prefetch) for datasets over the byte cap or
    # under one full batch
    device_data_cache: bool = True
    device_cache_max_bytes: int = 4 << 30
    # run each non-metric epoch on the device cache as one whole-epoch
    # program (steps.make_gathered_train_epoch: a CUDA graph replayed a
    # batch on the card), with the stepped loop's numbers and no gradient
    # histograms in it
    epoch_scan: bool = True
    log_every_n_steps: int = 10
    grad_hist_every_n_steps: int = 25  # TB grad histograms (0 = off)
    # abort after this many consecutive non-finite steps; detected on the
    # log_every_n_steps cadence and at the end of every epoch
    max_nonfinite_streak: int = 25
    verbose: bool = True
    device: str = "cuda"  # the card unless the caller asks for the CPU


def _make_trainer_mesh(cfg: TrainerConfig, config: SSD3DConfig, datamodule):
    """The mesh of a fit: none, the data mesh, or the data x spatial mesh of
    ``spatial_shards`` > 1 with the JAX package's checks and messages (a
    world that cannot hold the mesh raises before any group is formed)."""
    spatial = max(1, int(cfg.spatial_shards))
    if spatial == 1:
        return make_mesh(device=cfg.device) if cfg.data_parallel else None
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world % spatial:
        raise ValueError(f"spatial_shards={spatial} does not divide the {world} ranks of the "
                         "world (torchrun --nproc_per_node)")
    if config.input_size[0] % spatial:
        raise ValueError(f"volume depth {config.input_size[0]} is not divisible by "
                         f"spatial_shards={spatial}")
    n_data = world // spatial if cfg.data_parallel else 1
    batch_size = datamodule.batch_size
    if batch_size % n_data:
        fits = math.gcd(n_data, batch_size) * spatial
        raise ValueError(f"batch {batch_size} is not divisible by the data axis's {n_data} ranks "
                         f"(a world of {world} / spatial_shards={spatial}): launch {fits} ranks "
                         f"(torchrun --nproc_per_node {fits})")
    return make_mesh_2d(n_data, spatial, device=cfg.device)


class _NoLogger:
    """MetricsLogger's place on the ranks other than 0, which write nothing."""

    def log(self, metrics: dict, step: int):
        pass

    def log_histograms(self, tree: dict, step: int, prefix: str = "epoch/"):
        pass

    def close(self):
        pass


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class Trainer:
    def __init__(self, trainer_config: TrainerConfig):
        self.cfg = trainer_config

    def _detection_metrics(self, detections, boxes, labels, box_mask, batch_mask,
                           prefix, accum):
        """Queue one batch's detections + GT for the epoch's metrics; no
        device sync here, _finalize_detection_metrics reads them at the end."""
        accum[prefix].append(
            {"det": detections, "boxes": boxes, "labels": labels,
             "box_mask": box_mask, "batch_mask": batch_mask}
        )

    def _finalize_detection_metrics(self, accum, prefix, config, logs, tag):
        """Per-batch mAP/P/R/F1 averaged over batches (reference parity:
        *_epoch_end averages the per-batch metric dicts, ssd3d.py:588-690 —
        a different number than one global mAP over pooled detections)."""
        per_iou = {0.1: [], 0.5: []}
        for b in accum[prefix]:
            keep = _host(b["batch_mask"]).astype(bool)
            det = {k: _host(v)[keep] for k, v in b["det"].items()}
            db, dl, ds = detections_to_lists(det)
            boxes = _host(b["boxes"])[keep]
            labels = _host(b["labels"])[keep]
            mask = _host(b["box_mask"])[keep]
            gt_b = [boxes[i][mask[i]] for i in range(boxes.shape[0])]
            gt_l = [labels[i][mask[i]] for i in range(labels.shape[0])]
            diffs = [np.zeros(len(l), bool) for l in gt_l]
            for iou in per_iou:
                detail = metrics_lib.calculate_mAP(
                    db, dl, ds, gt_b, gt_l, diffs,
                    n_classes=config.n_classes, min_overlap=iou,
                    return_detail=True,
                )
                per_iou[iou].append(detail)
        for iou, suffix in ((0.1, "IoU_0.1"), (0.5, "IoU_0.5")):
            details = per_iou[iou]
            if not details:
                continue
            logs[f"mAP/{tag}_{suffix}"] = float(np.mean([d["mAP"] for d in details]))
            if config.n_classes == 2:
                for key in ("precision", "recall", "f1_score"):
                    logs[f"{key}/{tag}_{suffix}"] = float(
                        np.mean([d[key] for d in details])
                    )

    def fit(self, config: SSD3DConfig, datamodule, augment: AugmentConfig | None = None,
            resume: str | None = None):
        """Train ``config`` on ``datamodule``; returns (final state, result).

        The result has the JAX package's keys (history, best_val_loss,
        checkpoint_dir, best_checkpoint) and the port's ``timings``: the
        seconds ``materialize`` took and, per epoch, its steps, whether they
        ran as the whole-epoch program (``scanned``), its train and
        validation seconds (host clock; the train part ends with a read of
        the state, so it waits for the card) and its training losses.
        """
        cfg = self.cfg
        mesh = _make_trainer_mesh(cfg, config, datamodule)
        spatial = cfg.spatial_shards > 1
        lead = mesh is None or mesh.rank == 0  # the rank that writes and prints
        verbose = cfg.verbose and lead
        if mesh is not None and cfg.verbose:
            print(f"[mesh] {mesh.describe()}", flush=True)
        model = SSD3D(config)
        priors = model_priors(config)
        state = create_train_state(config, seed=cfg.seed,
                                   device=cfg.device if mesh is None else mesh.device)
        device = state.device
        start_epoch = 0
        if resume:
            _, state, meta = load_checkpoint(resume, state_template=state)
            start_epoch = meta["extra"].get("epoch", 0) + 1
            if verbose:
                print(f"[resume] from {resume} at step {int(state.step)}")
        grad_accum = max(1, int(cfg.grad_accum))
        if mesh is not None:
            state = replicate(state, mesh)
            # every path shards each global batch: one that does not divide raises now
            row_runs(datamodule.batch_size, mesh, grad_accum)

        kw = dict(hard_negative_mining=cfg.hard_negative_mining,
                  grad_accum=grad_accum, patch_training=cfg.patch_training,
                  patch_pos_fraction=cfg.patch_pos_fraction)
        instr_kw = dict(kw, with_detections=True,
                        return_grads=cfg.grad_hist_every_n_steps > 0)
        eval_kw = dict(with_detections=True, hard_negative_mining=cfg.hard_negative_mining,
                       patch_training=cfg.patch_training)
        train_step = make_train_step(config, model, priors, augment, mesh=mesh, **kw)
        # instrumented variant: detections of the training forward (train
        # metric epochs) and the raw gradients (TB histograms)
        train_step_instr = make_train_step(config, model, priors, augment, mesh=mesh,
                                           **instr_kw)
        eval_step = make_eval_step(config, model, priors, mesh=mesh, **eval_kw)

        # ---- data path ----
        # The dataset on the device when it fits: materialize once, copy
        # once, gather batches there by index, so a step sends the card one
        # small index vector. Streaming with prefetch for oversized datasets
        # or sub-batch-size debug runs.
        train_data = val_data = host_val = None
        n_train = n_val = 0
        can_materialize = all(
            hasattr(datamodule, a) for a in ("materialize", "trainsubs", "testsubs")
        )  # duck-typed custom datamodules stream
        materialize_s = 0.0
        sharded_cache = False
        if spatial:
            if verbose:
                print("[data] streaming each rank's rows of every batch (a spatial mesh keeps "
                      "no device cache); the steps keep its depth slab")
        elif mesh is not None:
            # the dataset sharded over the ranks' cards: rank r holds the
            # padded rows [r n_local, (r + 1) n_local), materialized alone
            B, n_train = datamodule.batch_size, len(getattr(datamodule, "trainsubs", ()))
            why_not = ("the data module cannot materialize" if not can_materialize
                       else "device_data_cache is off" if not cfg.device_data_cache
                       else f"fewer than {B} training volumes" if n_train < B else None)
            if why_not is None:
                n_local = -(-n_train // mesh.size)
                mine = [datamodule.trainsubs[i % n_train]
                        for i in range(mesh.rank * n_local, (mesh.rank + 1) * n_local)]
                t_data = time.perf_counter()
                host_train = datamodule.materialize(mine)
                materialize_s = time.perf_counter() - t_data
                nbytes = sum(v.nbytes for v in host_train.values() if isinstance(v, np.ndarray))
                if nbytes <= cfg.device_cache_max_bytes:
                    train_data = {k: torch.from_numpy(v).to(device)
                                  for k, v in host_train.items() if isinstance(v, np.ndarray)}
                    sharded_cache = True
                else:
                    why_not = f"a shard of {nbytes / 2**20:.0f} MiB is over the cache's cap"
            if verbose:
                print(f"[data] sharded device cache: {n_local} volumes a rank x {mesh.size} "
                      f"ranks ({n_train} train volumes)" if sharded_cache else
                      f"[data] streaming each rank's rows of every batch: {why_not}")
        elif cfg.device_data_cache and can_materialize:
            t_data = time.perf_counter()
            host_train = datamodule.materialize(datamodule.trainsubs)
            host_val = datamodule.materialize(datamodule.testsubs)
            materialize_s = time.perf_counter() - t_data
            nbytes = sum(
                v.nbytes for d in (host_train, host_val)
                for v in d.values() if isinstance(v, np.ndarray)
            )
            n_train = host_train["image"].shape[0]
            n_val = host_val["image"].shape[0]
            if nbytes <= cfg.device_cache_max_bytes and n_train >= datamodule.batch_size:
                def on_device(d):
                    return {k: torch.from_numpy(v).to(device) for k, v in d.items()
                            if isinstance(v, np.ndarray)}

                train_data = on_device(host_train)
                val_data = on_device(host_val)
                # the validation batches' rows and masks, padded to whole
                # batches (a last partial batch repeats the last row, masked)
                B = datamodule.batch_size
                val_rows = np.arange(-(-n_val // B) * B).reshape(-1, B)
                val_valid = val_rows < n_val
                val_rows = np.minimum(val_rows, n_val - 1)
                val_on_device = on_device({"rows": val_rows, "valid": val_valid})
                if verbose:
                    print(f"[data] device-resident cache: {n_train} train / {n_val} val "
                          f"volumes, {nbytes / 2**20:.0f} MiB on {device}")
            else:
                host_val = None
        if sharded_cache:
            train_step_g = make_sharded_gathered_train_step(config, model, priors, mesh, augment,
                                                            **kw)
            train_step_instr_g = make_sharded_gathered_train_step(config, model, priors, mesh,
                                                                  augment, **instr_kw)
        elif train_data is not None:
            train_step_g = make_gathered_train_step(config, model, priors, augment, **kw)
            train_step_instr_g = make_gathered_train_step(config, model, priors, augment,
                                                          **instr_kw)
            eval_step_g = make_gathered_eval_step(config, model, priors, **eval_kw)
            train_epoch_g = make_gathered_train_epoch(config, model, priors, augment, **kw)

        # whole validation volumes under patch training: sliding-window
        # detectors built at first use, by (volume shape, volumes at once)
        sw_val_detectors: dict = {}

        def sw_val_detect(val_state, images):
            key = (tuple(images.shape[1:4]), images.shape[0])
            if key not in sw_val_detectors:
                sw_val_detectors[key] = make_sliding_window_detector(
                    config, key[0], volume_batch=key[1])
            return sw_val_detectors[key](val_state, images)

        sw_val_on = cfg.patch_training and cfg.patch_val_full_volume

        def record(det, boxes, labels, box_mask, batch_mask, prefix, accum):
            """Queue a batch for the epoch's detection metrics; under a mesh
            every rank's rows are gathered first (over the data axis), and
            rank 0 keeps them."""
            if mesh is not None:
                rows = gather_rows({**{f"det.{k}": v for k, v in det.items()}, "boxes": boxes,
                                    "labels": labels, "box_mask": box_mask,
                                    "batch_mask": batch_mask}, mesh.rows)
                det = {k[4:]: v for k, v in rows.items() if k.startswith("det.")}
                boxes, labels, box_mask, batch_mask = (
                    rows[k] for k in ("boxes", "labels", "box_mask", "batch_mask"))
            if lead:
                self._detection_metrics(det, boxes, labels, box_mask, batch_mask, prefix, accum)

        checkpoint_dir = Path(cfg.logdir) / cfg.experiment_name / "checkpoints"
        logger, ckpt = _NoLogger(), None
        if lead:
            logger = MetricsLogger(cfg.logdir, cfg.experiment_name, cfg.use_wandb,
                                   wandb_config=config.to_json_dict())
            ckpt = CheckpointManager(checkpoint_dir, monitor="avg_val_loss", mode="min",
                                     save_top_k=cfg.save_top_k)
        _, schedule = make_optimizer(config.lr, config.scheduler, t_max=config.t_max)

        best_val = float("inf")
        patience_left = cfg.early_stopping_patience
        step = int(state.step)
        epoch = start_epoch
        done = False
        history, epoch_times = [], []
        # the epochs' draws: one generator on the device, seeded seed + epoch
        # at the start of each (a captured epoch program stays registered to it)
        generator = torch.Generator(device=device)

        def check_streak(streak):
            streak = int(streak)
            if streak >= cfg.max_nonfinite_streak:
                raise FloatingPointError(
                    f"{streak} consecutive non-finite losses at step {step} "
                    f"— aborting (try a lower learning rate)"
                )

        def log_step(m: dict):
            """The logging cadence's check and record of one step's metrics (floats)."""
            check_streak(m["nonfinite_streak"])
            logger.log({"total_loss/training": m["total_loss"],
                        "confidence_loss/training": m["conf_loss"],
                        "localization_loss/training": m["loc_loss"],
                        "grad_norm/training": m["grad_norm"]}, step)

        try:
            while not done:
                if cfg.max_epochs is not None and epoch >= cfg.max_epochs:
                    break

                # ---- train epoch ----
                # interval 0 = never (the reference has no disable switch)
                metric_interval = cfg.compute_metric_every_n_epochs
                compute_train_metrics = (
                    metric_interval > 0 and epoch % (metric_interval * 2) == 0
                )
                accum = {"train": [], "val": [], "val_full": []}
                t0 = time.perf_counter()
                train_losses = []
                if sharded_cache:
                    # each rank shuffles its own shard: one permutation a rank,
                    # drawn in rank order from the epoch's stream, block r of
                    # each global index vector being rank r's (the JAX
                    # package's sharded-cache stream)
                    b_local = datamodule.batch_size // mesh.size
                    rg = np.random.default_rng((cfg.seed or 0) + epoch)
                    perms = [rg.permutation(n_local) for _ in range(mesh.size)]
                    perm = torch.from_numpy(perms[mesh.rank]).to(device)
                    batches = [perm[s * b_local:(s + 1) * b_local]
                               for s in range(n_local // b_local)]
                elif train_data is not None:
                    # device-resident path: shuffle indices on the host, gather
                    # on the device. The permutation goes to the device once an
                    # epoch: a copy from pageable host memory waits for the
                    # card's queue, so one a step would stall every step.
                    B = datamodule.batch_size
                    rg = np.random.default_rng((cfg.seed or 0) + epoch)
                    perm = torch.from_numpy(rg.permutation(n_train)).to(device)
                    batches = [perm[i:i + B] for i in range(0, n_train - B + 1, B)]
                else:
                    # streaming path: host batch assembly and the copy to the
                    # device overlap the previous step (the DataLoader analog);
                    # under a mesh each rank keeps its rows of every batch
                    host = (array_batch(b) for b in datamodule.train_batches(epoch=epoch))
                    if mesh is not None:
                        host = (shard_batch(b, mesh, grad_accum) for b in host)
                    batches = prefetch_batches(host, prefetch=2, device=device)
                generator.manual_seed((cfg.seed or 0) + epoch)

                # the whole-epoch program where the JAX package scans
                # (its loop.py:444-454): the device cache, no mesh, no train metrics
                scan = (cfg.epoch_scan and train_data is not None and not sharded_cache
                        and mesh is None and not compute_train_metrics)
                if scan and cfg.max_steps > 0:
                    batches = batches[:max(cfg.max_steps - step, 0)]
                scanned = bool(scan and batches)
                if scanned:
                    n = len(batches)
                    # the batches are the permutation's consecutive rows
                    idx_matrix = perm[:n * B].view(n, B)
                    state, ms = train_epoch_g(state, train_data, idx_matrix, generator)
                    # one read of the epoch's metrics
                    rows = torch.stack([ms[k].float() for k in EPOCH_METRICS], 1).tolist()
                    for row in rows:
                        step += 1
                        m = dict(zip(EPOCH_METRICS, row))
                        train_losses.append({k: m[k] for k in LOSSES})
                        if step % cfg.log_every_n_steps == 0:
                            log_step(m)
                    batches = []  # consumed

                for batch in batches:
                    grad_hist = (
                        cfg.grad_hist_every_n_steps > 0
                        and step % cfg.grad_hist_every_n_steps == 0
                    )
                    instrumented = compute_train_metrics or grad_hist
                    if train_data is not None:
                        fn = train_step_instr_g if instrumented else train_step_g
                        state, m = fn(state, train_data, batch, generator)
                        batch_mask = np.ones(len(batch), bool)
                    else:
                        fn = train_step_instr if instrumented else train_step
                        state, m = fn(state, batch, generator)
                        batch_mask = batch["batch_mask"]
                    step += 1
                    # device tensors only, read in bulk at the end of the epoch
                    train_losses.append({k: m[k] for k in LOSSES})
                    if grad_hist:
                        logger.log_histograms(m["grads"], step - 1, prefix="epoch/")
                    if compute_train_metrics:
                        record(m["detections"], m["aug_boxes"], m["aug_labels"],
                               m["aug_box_mask"], batch_mask, "train", accum)
                    if step % cfg.log_every_n_steps == 0:
                        log_step({k: float(m[k]) for k in EPOCH_METRICS})
                    if cfg.max_steps > 0 and step >= cfg.max_steps:
                        done = True
                        break
                if cfg.max_steps > 0 and step >= cfg.max_steps:
                    done = True  # also an epoch that a resume past max_steps left empty
                # epoch boundary: one authoritative streak check (covers runs
                # whose divergence never lands on the logging cadence)
                check_streak(state.nonfinite_streak)  # waits for the epoch's steps
                train_s, steps_run = time.perf_counter() - t0, len(train_losses)

                epoch_logs = {}
                if compute_train_metrics and accum["train"]:  # rank 0's alone
                    self._finalize_detection_metrics(accum, "train", config, epoch_logs,
                                                     "training")
                    # parameter L1 scalar, logged with train metrics like the
                    # reference's training_epoch_end (ssd3d.py:689-690)
                    epoch_logs["hp_metric/parameter_sizes"] = float(torch.stack(
                        [p.abs().sum(dtype=torch.float64) for p in state.params.values()]).sum())

                # ---- validation ----
                t_val = time.perf_counter()
                compute_val_metrics = (
                    cfg.compute_metric_every_n_epochs > 0
                    and epoch % cfg.compute_metric_every_n_epochs == 0
                )
                val_state = eval_view(state)
                val_losses = []
                if val_data is not None:
                    for j, (ids, valid) in enumerate(zip(val_rows, val_valid)):
                        ev = eval_step_g(val_state, val_data, val_on_device["rows"][j],
                                         val_on_device["valid"][j])
                        val_losses.append(
                            {k: ev[k] for k in ("total_loss", "conf_loss", "loc_loss", "n_valid")}
                        )
                        if compute_val_metrics:
                            # a patch eval hands back the patch-frame GT of
                            # its patch-frame detections
                            gt = {k: ev.get(f"gt_{k}", host_val[k][ids])
                                  for k in ("boxes", "labels", "box_mask")}
                            record(ev["detections"], gt["boxes"], gt["labels"],
                                   _host(gt["box_mask"]) & valid[:, None], valid, "val", accum)
                            if sw_val_on:
                                rows = ids[valid]
                                det = sw_val_detect(val_state,
                                                    val_data["image"][torch.from_numpy(rows)
                                                                      .to(device)])
                                record(det, host_val["boxes"][rows], host_val["labels"][rows],
                                       host_val["box_mask"][rows], np.ones(len(rows), bool),
                                       "val_full", accum)
                else:
                    for batch in datamodule.val_batches():
                        batch = array_batch(batch)
                        if mesh is not None:
                            batch = shard_batch(batch, mesh)
                        ev = eval_step(val_state, batch)
                        val_losses.append(
                            {k: ev[k] for k in ("total_loss", "conf_loss", "loc_loss", "n_valid")}
                        )
                        if compute_val_metrics:
                            gt = {k: ev.get(f"gt_{k}", batch[k])
                                  for k in ("boxes", "labels", "box_mask")}
                            record(ev["detections"], gt["boxes"], gt["labels"], gt["box_mask"],
                                   batch["batch_mask"], "val", accum)
                            keep = batch["batch_mask"].astype(bool)
                            if sw_val_on and mesh is not None:
                                # every rank scores all its rows (the same count
                                # on each), so that the rows gather; the mask
                                # drops the padding
                                record(sw_val_detect(val_state, batch["image"]), batch["boxes"],
                                       batch["labels"], batch["box_mask"], keep, "val_full",
                                       accum)
                            elif sw_val_on and keep.any():
                                det = sw_val_detect(val_state, batch["image"][keep])
                                record(det, batch["boxes"][keep], batch["labels"][keep],
                                       batch["box_mask"][keep], np.ones(int(keep.sum()), bool),
                                       "val_full", accum)

                # one read of the epoch's train and val losses
                train_losses = [{k: float(v) for k, v in m.items()} for m in train_losses]
                val_losses = [{k: float(v) for k, v in m.items()} for m in val_losses]

                def weighted_val(key):
                    # per-batch losses are means over valid samples; weight by
                    # that count so a padded partial final batch does not skew
                    # the epoch mean (and checkpoint selection with it)
                    if not val_losses:
                        return float("nan")
                    w = np.asarray([v["n_valid"] for v in val_losses], np.float64)
                    x = np.asarray([v[key] for v in val_losses], np.float64)
                    return float((x * w).sum() / max(w.sum(), 1.0))

                avg_val = weighted_val("total_loss")
                epoch_logs.update(
                    {
                        "avg_val_loss": avg_val,
                        "total_loss/validation": avg_val,
                        "confidence_loss/validation": weighted_val("conf_loss"),
                        "localization_loss/validation": weighted_val("loc_loss"),
                        "hp_metric/lr": float(schedule(torch.tensor(step))),
                    }
                )
                if compute_val_metrics and accum["val"]:
                    self._finalize_detection_metrics(accum, "val", config, epoch_logs,
                                                     "validation")
                if compute_val_metrics and accum["val_full"]:
                    self._finalize_detection_metrics(accum, "val_full", config, epoch_logs,
                                                     "validation_full")
                epoch_times.append({"epoch": epoch, "steps": steps_run, "scanned": scanned,
                                    "train_s": train_s,
                                    "val_s": time.perf_counter() - t_val,
                                    "train_losses": [m["total_loss"] for m in train_losses]})

                logger.log(epoch_logs, step)
                history.append({"epoch": epoch, **epoch_logs})
                if verbose:
                    train_loss = (float(np.mean([m["total_loss"] for m in train_losses]))
                                  if train_losses else float("nan"))
                    msg = (f"[epoch {epoch:3d}] step {step} train_loss={train_loss:.4f} "
                           f"val_loss={avg_val:.4f} ({time.perf_counter() - t0:.1f}s)")
                    if "mAP/validation_IoU_0.1" in epoch_logs:
                        msg += f" mAP@0.1={epoch_logs['mAP/validation_IoU_0.1']:.3f}"
                    if "mAP/validation_full_IoU_0.1" in epoch_logs:
                        msg += (" full-vol mAP@0.1="
                                f"{epoch_logs['mAP/validation_full_IoU_0.1']:.3f}")
                    print(msg, flush=True)

                # ---- checkpoint + early stopping ----
                if np.isfinite(avg_val):
                    if ckpt is not None:
                        ckpt.save(state, config, {"avg_val_loss": avg_val}, epoch)
                    if avg_val < best_val:
                        best_val = avg_val
                        patience_left = cfg.early_stopping_patience
                    elif cfg.early_stopping:
                        patience_left -= 1
                        if patience_left <= 0:
                            if verbose:
                                print(f"[early stopping] at epoch {epoch}")
                            done = True
                if mesh is not None:  # every rank stops where rank 0 does
                    flag = torch.tensor([int(done)], dtype=torch.int32, device=device)
                    done = bool(broadcast([flag], mesh)[0])

                epoch += 1

        finally:
            logger.close()
        return state, {"history": history, "best_val_loss": best_val,
                       "checkpoint_dir": str(checkpoint_dir),
                       "best_checkpoint": None if ckpt is None else str(ckpt.best),
                       "timings": {"materialize_s": materialize_s, "epochs": epoch_times}}
