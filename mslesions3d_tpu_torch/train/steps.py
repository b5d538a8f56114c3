"""Train, eval and predict steps on the state's device.

Counterpart of ``mslesions3d_tpu/train/steps.py``. Each step is a function
of a :class:`..train.state.TrainState` and a batch that returns a new state
(the old one is left as it was) and device tensors: nothing waits for the
card. The model passed in is the module the steps call with the state's
tensors (``torch.func.functional_call``); its own weights are not used.
The forward runs on the float32 masters rounded to the model's parameter
dtypes, and autograd's gradients reach the masters in float32.

A batch is a dict of arrays or tensors: ``image`` (B, D, H, W, C),
``boxes`` (B, M, 6) corner form, ``labels`` (B, M), ``box_mask`` (B, M)
and optionally ``batch_mask`` (B,). With ``patch_training`` the images are
full-resolution volumes and the steps crop ``config.input_size`` patches
from them on the device (``data/patches.py``).

Data parallelism: given a data mesh (``parallel.make_mesh``, one rank a
card), a step takes this rank's rows of the global batch
(``parallel.shard_batch``) and computes what the JAX package's sharded
program computes on the whole of it: every random draw is the global
batch's, of which the rank keeps its rows; BatchNorm takes the global
batch's statistics; the loss divides by the global positives; the
gradients, losses and counts are summed over the ranks, so the update, the
metrics and the non-finite select are the same on every rank. Detections
stay per rank, for the caller to gather (``parallel.gather_rows``).

Spatial sharding: given a data x spatial mesh (``parallel.make_mesh_2d``),
a step takes this rank's rows as whole volumes (``parallel.shard_batch``:
its data rank's share of every micro-batch), which the patch crop and the
augmentation (flips, rot90 and the affine all mix depth) take; then it
keeps its depth slab. Where a micro-batch does not divide over the data
ranks, the rows are its data rank's block and the step first gathers the
whole batch over the data group: every data rank runs every row, as the
JAX package's ``pin_micro`` does. The forward runs depth-split up to the
cut (``parallel/spatial.py``); the losses and positives are summed over the
data group, and each rank's loss is divided by n_spatial (and by n_data
where the rows are whole on every data rank) before the backward, so the
gradients summed over the world count the replicated part once.

Tensor parallelism: given a data x spatial x model mesh
(``parallel.make_mesh_3d``) and a state of this rank's parameter slices
(``parallel.shard_tree``), a step runs as under its data x spatial mesh,
with the layers' channels split over the model group
(``parallel/tensor.py``). Every model rank computes the whole loss, so the
gradients are summed over the rank's data x spatial group only
(``mesh.replicas``), and the gradient norm joins the sharded leaves' squares
over the model group.

The whole-epoch program (:func:`make_gathered_train_epoch`, the JAX
package's ``lax.scan`` of an epoch's steps) runs the gathered step once a
batch: on the card as a CUDA graph captured once and replayed
(``train/graphs.py``), on the CPU as a plain loop. Both give the stepped
loop's numbers.
"""

from __future__ import annotations

import functools

import torch
from torch.func import functional_call

from ..data.augment import AugmentConfig, augment_batch
from ..data.patches import (
    boxes_to_patch,
    crop_patches,
    deterministic_patch_starts,
    sample_patch_starts,
)
from ..models.losses import multibox_loss_from_config
from ..models.ssd3d import SSD3D, SSD3DConfig
from ..ops.nms import detect_objects
from ..parallel.collectives import all_reduce_sum, data_parallel, exchange_rows, gather_rows
from ..parallel.mesh import SpatialMesh, TensorMesh, local_row_runs, rows_split
from ..parallel.spatial import depth_slab
from ..utils.profiling import phases, span
from .graphs import GraphedEpoch, split_metrics, stack_metrics
from .state import TrainState


def _batch_on(batch: dict, device) -> dict:
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if "batch_mask" not in out:
        out["batch_mask"] = torch.ones(out["image"].shape[0], dtype=torch.bool, device=device)
    return out


def _priors_by_device(priors_center):
    """fn(device) -> the float32 priors there, copied once per device: a copy
    from pageable host memory would wait for the card's queue every step."""
    return functools.cache(torch.as_tensor(priors_center, dtype=torch.float32).to)


def _cast(model: SSD3D, params: dict) -> dict:
    """The masters rounded to the model's parameter dtypes (autograd-visible)."""
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    return {n: p.to(dtypes[n]) for n, p in params.items()}


def eval_forward(model: SSD3D, state: TrainState, images: torch.Tensor):
    """(locs, scores) of ``model`` in eval mode on the state's weights and BN
    statistics; the caller decides whether autograd records it."""
    model.eval()
    return functional_call(model, (_cast(model, state.params), state.batch_stats), (images,))


def _detect(config: SSD3DConfig, locs, scores, priors):
    return detect_objects(locs, scores, priors, n_classes=config.n_classes,
                          min_score=config.min_score, max_overlap=config.max_overlap,
                          top_k=config.top_k)


def _crop(images, boxes, box_mask, starts, patch):
    """The patches at ``starts`` and the ground truth re-mapped into them."""
    full = tuple(images.shape[1:4])
    boxes, box_mask = boxes_to_patch(boxes, box_mask, starts, full, patch)
    return crop_patches(images, starts, patch), boxes, box_mask


def _needs_dropout(config: SSD3DConfig) -> bool:
    return "convnet" in config.base_network_config and config.convnet_dropout > 0.0


def make_train_step(config: SSD3DConfig, model: SSD3D, priors_center,
                    augment: AugmentConfig | None = None, hard_negative_mining: bool = False,
                    skip_nonfinite: bool = True, with_detections: bool = False,
                    return_grads: bool = False, grad_accum: int = 1,
                    patch_training: bool = False, patch_pos_fraction: float = 0.7,
                    mesh=None):
    """Returns fn(state, batch, generator=None) -> (new state, metrics).

    ``generator`` (a ``torch.Generator`` on the state's device) draws, in
    this order, the patch starts (``patch_training``), the augmentation and
    the ConvNet's dropout masks (one set per micro-batch); it is required
    when any of them is on. With ``patch_training`` each sample is cropped
    to ``config.input_size`` at a lesion-biased start
    (``patch_pos_fraction``, ``data/patches.py``) before augmentation, and
    its boxes re-mapped into the patch. After augmentation boxes are
    clipped to [0, 1] and degenerate ones masked.

    With ``skip_nonfinite`` a non-finite loss keeps the old params,
    optimizer state, BN statistics and EMA (a select on the card, no host
    sync) while ``step`` and ``nonfinite_streak`` advance. ``grad_accum``
    splits the batch into micro-batches whose BN statistics chain and whose
    gradients are averaged before one update. ``with_detections`` adds the
    detections of the training forward (K1 on the card) and the ground
    truth it saw (patch frame, augmented); ``return_grads`` adds the
    gradients by parameter name.

    Metrics: total_loss, conf_loss, loc_loss, n_positives (valid boxes after
    augmentation, the JAX package's metric), nonfinite, nonfinite_streak and
    grad_norm (over every parameter).

    The step is marked in phases (``utils.profiling.phases``): from its
    start (the batch's draws and augmentation included) to each
    micro-batch's loss ``msl.step.forward``, to its gradients
    ``msl.step.backward`` (the last one's through the gradients' sum over
    the mesh), and to the step's end ``msl.step.update`` (the optimizer,
    EMA, non-finite select, metrics and any detections): timed inside a
    CUDA graph's replay (``train/graphs.py``), spans in an eager trace.

    With a ``mesh`` the batch is this rank's rows of a global batch
    (``parallel.shard_batch``: with ``grad_accum`` its share of every
    micro-batch; under a data x spatial mesh see the module docstring) and
    the generator is in the same state on every rank; the metrics,
    gradients and new state are the global batch's on every rank, the
    detections and ground truth those of the rows this rank was given.
    """
    augment = augment or AugmentConfig()
    priors_on = _priors_by_device(priors_center)
    grad_accum = max(1, int(grad_accum))
    patch = tuple(config.input_size)
    random = patch_training or not augment.identity or _needs_dropout(config)
    spatial = isinstance(mesh, SpatialMesh)

    def loss_fn(leaves: dict, stats: dict, mb: dict, priors: torch.Tensor, generator, rows):
        locs, scores = functional_call(model, (_cast(model, leaves), stats), (mb["image"],),
                                       {"generator": generator})
        conf_loss, loc_loss = multibox_loss_from_config(
            config, locs, scores, mb["boxes"], mb["labels"], mb["box_mask"],
            priors, batch_mask=mb["batch_mask"], hard_negative_mining=hard_negative_mining,
            mesh=rows,
        )
        return conf_loss + config.alpha * loc_loss, conf_loss, loc_loss, locs, scores

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        with phases("msl.step.forward") as phase:
            return phased_step(state, batch, generator, phase)

    def phased_step(state: TrainState, batch: dict, generator, phase):
        device = state.device
        priors = priors_on(device)
        batch = _batch_on(batch, device)
        b = batch["image"].shape[0]
        # the view the rows are split over (None: whole on this rank), the
        # share of the loss this rank's backward takes, the rows it reports
        rows = None if mesh is None else mesh.rows
        scale, mine = None, slice(None)
        if spatial:
            scale = 1.0 / mesh.n_spatial
            if not rows_split(b * mesh.n_data, mesh, grad_accum):
                # every row on every data rank: the data group's blocks, gathered
                mine = slice(mesh.data.rank * b, (mesh.data.rank + 1) * b)
                batch = gather_rows(batch, mesh.data)
                b, rows, scale = b * mesh.n_data, None, scale / mesh.n_data
        images, boxes, box_mask = batch["image"], batch["boxes"], batch["box_mask"]
        if random and generator is None:
            raise ValueError("make_train_step: patch training, augmentation and dropout "
                             "need a generator")
        if b % grad_accum:
            raise ValueError(f"batch size {b} is not divisible by grad_accum={grad_accum}")
        # under a mesh: the global batch's draws, of which this rank keeps its rows
        draw = {} if rows is None else dict(
            global_batch=b * rows.size, rows=local_row_runs(b * rows.size, rows, grad_accum))
        if patch_training:
            starts = sample_patch_starts(generator, tuple(images.shape[1:4]), patch, boxes,
                                         box_mask, patch_pos_fraction, **draw)
            images, boxes, box_mask = _crop(images, boxes, box_mask, starts, patch)
        if not augment.identity:
            images, boxes = augment_batch(generator, images, boxes, augment, **draw)
            boxes = torch.clamp(boxes, 0.0, 1.0)
            box_mask = box_mask & ~(boxes[..., 3:] <= boxes[..., :3]).any(dim=-1)
        if spatial:  # the whole volumes took the draws: now this rank's slab
            images = depth_slab(images, mesh)
        full = {"image": images, "boxes": boxes, "labels": batch["labels"],
                "box_mask": box_mask, "batch_mask": batch["batch_mask"]}

        model.train()
        names = list(state.params)
        leaves = {n: p.detach().requires_grad_() for n, p in state.params.items()}
        # the BN running statistics are moved in place: work on copies
        stats = {n: s.clone() for n, s in state.batch_stats.items()}
        m = b // grad_accum
        gsum, losses, locs_out, scores_out = None, [], [], []
        with data_parallel(mesh, rows=rows is not None):
            for i in range(grad_accum):
                if i:
                    phase.next("msl.step.forward")
                mb = {k: v[i * m:(i + 1) * m] for k, v in full.items()}
                total, conf, loc, locs, scores = loss_fn(leaves, stats, mb, priors, generator,
                                                         rows)
                phase.next("msl.step.backward")
                g = torch.autograd.grad(total if scale is None else total * scale,
                                        [leaves[n] for n in names], allow_unused=True)
                g = [torch.zeros_like(leaves[n]) if gi is None else gi for n, gi in zip(names, g)]
                gsum = g if gsum is None else torch._foreach_add(gsum, g)
                losses.append(torch.stack([total, conf, loc]).detach())
                locs_out.append(locs.detach())
                scores_out.append(scores.detach())
        grads = gsum if grad_accum == 1 else torch._foreach_div(gsum, float(grad_accum))
        # this rank's shares of the losses and gradients -> the global batch's
        losses, n_pos = all_reduce_sum([torch.stack(losses), box_mask.sum().float()], rows)
        grads = dict(zip(names, all_reduce_sum(grads, None if mesh is None else mesh.replicas)))
        phase.next("msl.step.update")
        total, conf_loss, loc_loss = losses[0] if grad_accum == 1 else losses.mean(0)

        updated = state.apply_gradients(grads, new_batch_stats=stats)
        decay = float(config.ema_decay)
        if decay > 0.0 and state.ema_params is not None:
            ema = torch._foreach_mul(list(state.ema_params.values()), decay)
            torch._foreach_add_(ema, torch._foreach_mul(
                [updated.params[n] for n in state.ema_params], 1.0 - decay))
            updated = updated.replace(ema_params=dict(zip(state.ema_params, ema)))

        if skip_nonfinite:
            finite = torch.isfinite(total)
            new_state = _select(finite, updated, state)
        else:
            finite = torch.ones((), dtype=torch.bool, device=device)
            new_state = updated
        streak = torch.where(finite, 0, state.nonfinite_streak + 1).to(torch.int32)
        new_state = new_state.replace(nonfinite_streak=streak)

        grad_norm = _global_norm(grads, model, mesh)
        metrics = {
            "total_loss": total,
            "conf_loss": conf_loss,
            "loc_loss": loc_loss,
            "n_positives": n_pos,
            "nonfinite": (~finite).float(),
            "nonfinite_streak": streak,
            "grad_norm": grad_norm,
        }
        if with_detections:
            with torch.no_grad():
                metrics["detections"] = _detect(config, torch.cat(locs_out)[mine],
                                                torch.cat(scores_out)[mine], priors)
            metrics["aug_boxes"] = boxes[mine]
            metrics["aug_labels"] = batch["labels"][mine]
            metrics["aug_box_mask"] = box_mask[mine]
        if return_grads:
            metrics["grads"] = grads
        return new_state, metrics

    return step


def _global_norm(grads: dict, model: SSD3D, mesh) -> torch.Tensor:
    """The norm of the whole gradient vector: under a model split the
    squares of the sharded leaves (slices of the model's whole parameters)
    summed over the model group, the replicated ones counted once."""
    norms = torch._foreach_norm(list(grads.values()))
    if not isinstance(mesh, TensorMesh):
        return torch.linalg.vector_norm(torch.stack(norms))
    zero = torch.zeros((), dtype=norms[0].dtype, device=norms[0].device)
    squares = {True: [zero], False: [zero]}
    for (n, g), norm in zip(grads.items(), norms):
        squares[g.shape != model.get_parameter(n).shape].append(norm * norm)
    (split,) = all_reduce_sum([torch.stack(squares[True]).sum()], mesh.model)
    return torch.sqrt(split + torch.stack(squares[False]).sum())


def _select(finite: torch.Tensor, new: TrainState, old: TrainState) -> TrainState:
    """new where the loss was finite, else old with ``step`` advanced."""
    def pick(a: dict, b: dict) -> dict:
        return {k: torch.where(finite, a[k], b[k]) for k in a}

    opt = new.opt_state.__class__(
        count=torch.where(finite, new.opt_state.count, old.opt_state.count),
        mu=pick(new.opt_state.mu, old.opt_state.mu),
        nu=pick(new.opt_state.nu, old.opt_state.nu),
    )
    return new.replace(
        params=pick(new.params, old.params),
        batch_stats=pick(new.batch_stats, old.batch_stats),
        opt_state=opt,
        ema_params=None if new.ema_params is None else pick(new.ema_params, old.ema_params),
        step=old.step + 1,
    )


def _gather_rows(data: dict, idx) -> dict:
    """Rows ``idx`` of a dataset held on the device, indexed as the JAX
    package's ``dynamic_index_in_dim``: a negative index counts once from the
    end, then every index is clamped to the first or last row."""
    some = next(iter(data.values()))
    n = some.shape[0]
    idx = torch.as_tensor(idx, device=some.device).long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return {k: v[idx] for k, v in data.items()}


def make_gathered_train_step(config: SSD3DConfig, model: SSD3D, priors_center,
                             augment: AugmentConfig | None = None, **kwargs):
    """Train step over a dataset held on the device: fn(state, data, idx, generator=None).

    ``data`` holds image / boxes / labels / box_mask rows; ``idx`` (B,)
    selects the batch on the device. make_train_step's options pass through;
    with ``patch_training`` the rows are full volumes, cropped afresh each
    step.
    """
    body = make_train_step(config, model, priors_center, augment, **kwargs)

    def step(state, data, idx, generator=None):
        batch = _gather_rows(data, idx)
        batch["batch_mask"] = torch.ones(batch["image"].shape[0], dtype=torch.bool,
                                         device=batch["image"].device)
        return body(state, batch, generator)

    return step


def make_gathered_train_epoch(config: SSD3DConfig, model: SSD3D, priors_center,
                              augment: AugmentConfig | None = None, **kwargs):
    """Whole-epoch train program: fn(state, data, idx_matrix, generator=None)
    -> (state, metrics).

    ``idx_matrix`` (n_batches, B) integers, on the state's device, selects
    every batch of the epoch from ``data`` (as :func:`make_gathered_train_step`);
    the steps run back to back, drawing from ``generator`` in the stepped
    loop's order, and ``metrics`` holds total_loss, conf_loss, loc_loss,
    grad_norm and nonfinite_streak as (n_batches,) tensors on the device, to
    be read in one transfer. make_train_step's options pass through.

    On the card the step is captured into a CUDA graph at the first call for
    a key (``train/graphs.py``) and replayed once a row; the capture is kept
    on ``fn.graphed`` for later calls. On the CPU the steps run in a plain
    loop. The state returned shares no memory with a later call's. A call
    runs under the span ``msl.epoch`` (``utils.profiling.span``).
    """
    step = make_gathered_train_step(config, model, priors_center, augment, **kwargs)
    graphed = GraphedEpoch(step)

    def epoch(state, data, idx_matrix, generator=None):
        if state.device.type not in ("cuda", "cpu"):
            raise ValueError(f"make_gathered_train_epoch: no epoch program on {state.device}")
        with span("msl.epoch"):
            if state.device.type == "cuda":
                return graphed(state, data, idx_matrix, generator)
            rows = []
            for idx in torch.as_tensor(idx_matrix, device=state.device):
                state, m = step(state, data, idx, generator)
                rows.append(stack_metrics(m))
            return state, split_metrics(torch.stack(rows))

    epoch.graphed = graphed
    return epoch


def make_sharded_gathered_train_step(config: SSD3DConfig, model: SSD3D, priors_center, mesh,
                                     augment: AugmentConfig | None = None, **kwargs):
    """Data-parallel train step over a dataset sharded over the mesh:
    fn(state, data, idx, generator=None).

    Each rank holds its shard of the materialized dataset on its card
    (``data``) and ``idx`` (B / W,) holds indices local to it; the global
    batch is the ranks' gathered rows in rank order, as the JAX package's
    ``make_sharded_gathered_train_step`` (block d of its index vector is
    shard d's). The gather touches no other rank; the step is
    :func:`make_train_step`'s under ``mesh``. With ``grad_accum > 1`` the JAX
    program's micro-batch i is the global rows [i m, (i + 1) m), which lie
    in other ranks' blocks: after the gather the ranks exchange rows
    (``parallel.collectives.exchange_rows``) so that each holds its share of
    every micro-batch (``parallel.local_row_runs``).
    """
    grad_accum = max(1, int(kwargs.get("grad_accum", 1)))
    body = make_train_step(config, model, priors_center, augment, mesh=mesh, **kwargs)

    def step(state, data, idx, generator=None):
        batch = _gather_rows(data, idx)
        if mesh.size > 1 and grad_accum > 1:
            b = batch["image"].shape[0] * mesh.size
            batch = exchange_rows(batch, mesh, [local_row_runs(b, mesh, grad_accum, rank=r)
                                                for r in range(mesh.size)])
        batch["batch_mask"] = torch.ones(batch["image"].shape[0], dtype=torch.bool,
                                         device=batch["image"].device)
        return body(state, batch, generator)

    return step


def make_eval_step(config: SSD3DConfig, model: SSD3D, priors_center,
                   with_detections: bool = True, hard_negative_mining: bool = False,
                   patch_training: bool = False, mesh=None):
    """Returns fn(state, batch) -> metrics (+ padded detections).

    The model runs in eval mode on the running BN statistics, so the
    config's ``use_pallas`` / ``use_pallas_tail`` send its layers to K2 / K3
    on the card. ``hard_negative_mining`` should match the training flag.
    ``n_valid`` counts the batch's real rows. ``patch_training`` scores a
    deterministic crop of each full volume, centred on its boxes
    (``data/patches.py``), so the monitored loss repeats; the detections are
    then in the patch frame, and ``gt_boxes`` / ``gt_labels`` /
    ``gt_box_mask`` hand back the ground truth re-mapped into it.

    With a ``mesh`` the batch is this rank's rows of the global batch
    (``parallel.shard_batch``): the losses and ``n_valid`` are the global
    batch's on every rank, the detections this rank's. Under a data x
    spatial mesh the forward runs on the rows' depth slabs up to the cut,
    and the detections come from the whole maps past it.
    """
    priors_on = _priors_by_device(priors_center)
    patch = tuple(config.input_size)
    spatial = isinstance(mesh, SpatialMesh)

    @torch.no_grad()
    def step(state: TrainState, batch: dict) -> dict:
        device = state.device
        priors = priors_on(device)
        rows = None if mesh is None else mesh.rows
        batch = _batch_on(batch, device)
        images, boxes, box_mask = batch["image"], batch["boxes"], batch["box_mask"]
        if patch_training:
            starts = deterministic_patch_starts(tuple(images.shape[1:4]), patch, boxes,
                                                box_mask)
            images, boxes, box_mask = _crop(images, boxes, box_mask, starts, patch)
        if spatial:
            with data_parallel(mesh):
                locs, scores = eval_forward(model, state, depth_slab(images, mesh))
        else:
            locs, scores = eval_forward(model, state, images)
        conf_loss, loc_loss = multibox_loss_from_config(
            config, locs, scores, boxes, batch["labels"], box_mask,
            priors, batch_mask=batch["batch_mask"], hard_negative_mining=hard_negative_mining,
            mesh=rows,
        )
        total = conf_loss + config.alpha * loc_loss
        n_valid = batch["batch_mask"].sum().float()
        if rows is not None:
            total, conf_loss, loc_loss, n_valid = all_reduce_sum(
                [torch.stack([total, conf_loss, loc_loss, n_valid])], rows)[0]
        out = {
            "total_loss": total,
            "conf_loss": conf_loss,
            "loc_loss": loc_loss,
            "n_valid": n_valid,
        }
        if with_detections:
            out["detections"] = _detect(config, locs, scores, priors)
            if patch_training:
                out["gt_boxes"] = boxes
                out["gt_labels"] = batch["labels"]
                out["gt_box_mask"] = box_mask
        return out

    return step


def make_gathered_eval_step(config: SSD3DConfig, model: SSD3D, priors_center, **kwargs):
    """Eval step over a dataset held on the device: fn(state, data, idx, valid).

    ``valid`` (B,) masks the padded rows of a last partial batch (their
    clamped indices repeat a real row, masked out of every loss and metric).
    """
    body = make_eval_step(config, model, priors_center, **kwargs)

    def step(state, data, idx, valid):
        batch = _gather_rows(data, idx)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=batch["image"].device)
        batch["batch_mask"] = valid
        batch["box_mask"] = batch["box_mask"] & valid[:, None]
        return body(state, batch)

    return step


def make_predict_step(config: SSD3DConfig, model: SSD3D, priors_center,
                      min_score=None, max_overlap=None, top_k=None):
    """Returns fn(state, images) -> padded detections."""
    priors_on = _priors_by_device(priors_center)

    @torch.no_grad()
    def step(state: TrainState, images) -> dict:
        device = state.device
        locs, scores = eval_forward(model, state, torch.as_tensor(images, device=device))
        return detect_objects(
            locs, scores, priors_on(device), n_classes=config.n_classes,
            min_score=config.min_score if min_score is None else min_score,
            max_overlap=config.max_overlap if max_overlap is None else max_overlap,
            top_k=config.top_k if top_k is None else top_k,
        )

    return step
