"""Sliding-window inference over full-resolution volumes, stitched on the device.

Counterpart of ``mslesions3d_tpu/sliding_window.py`` (BASELINE config #3:
train on patches, predict whole volumes). A volume larger than the model's
input is tiled into overlapping model-sized patches; the patches run
through the detector in device batches, each patch's detections are mapped
to the volume's fractional coordinates, and a second class-wise greedy NMS
stitches the overlapping patches' detections into one result.

NMS runs at two call sites, both through ``ops/nms.py`` and
``kernels/nms.py``: ``detect_objects`` on every chunk of patches (N =
patches, K = min(10 x per_patch_k, priors)) and the stitch (N = volumes x
(n_classes - 1), K = min(10 x top_k, patches x per_patch_k)). On CUDA
tensors both launch the kernel K1; on CPU tensors they take the plain NMS.

The JAX package runs every chunk in one jitted scan; here the chunks loop
in Python with the same work list, batches and results, and nothing waits
for the card until the caller reads the output.

With a ``mesh`` (a tuple of devices: every visible card, as the JAX
package's data mesh over all devices) each chunk of patches is split into
one contiguous shard a device; each device crops and runs its shard on its
own copy of the weights, with its own per-patch ``detect_objects`` (K1 on
that card), and the candidates come back to the first device in patch
order. The stitch's NMS rows are split over the devices too when they
divide (as the JAX package shards the stitch, ``sliding_window.py:229``).
One process drives every card; a card's launches queue without waiting for
the others'.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.patches import crop_patches
from .kernels.nms import greedy_nms_cuda
from .models.ssd3d import SSD3D, SSD3DConfig, model_priors
from .ops.nms import detect_objects, select_detections, top_k_stable
from .train.steps import eval_forward


def patch_offsets(volume_shape, patch_size, overlap: float = 0.25) -> np.ndarray:
    """Grid of patch start offsets (n, 3) covering the volume.

    Stride = patch x (1 - overlap); the last patch of each axis is moved back
    so that the window never leaves the volume (full coverage, with more
    overlap at the far edge).
    """
    per_axis = []
    for size, patch in zip(volume_shape, patch_size):
        if size < patch:
            raise ValueError(f"volume {volume_shape} smaller than patch {patch_size}")
        stride = max(int(round(patch * (1.0 - overlap))), 1)
        starts = list(range(0, size - patch + 1, stride))
        if starts[-1] != size - patch:
            starts.append(size - patch)
        per_axis.append(starts)
    offsets = [(x, y, z) for x in per_axis[0] for y in per_axis[1] for z in per_axis[2]]
    return np.asarray(offsets, np.int32)


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_sliding_window_detector(
    config: SSD3DConfig,
    volume_shape: tuple[int, int, int],
    overlap: float = 0.25,
    patch_batch: int | None = None,
    min_score: float | None = None,
    max_overlap: float | None = None,
    top_k: int | None = None,
    per_patch_k: int | None = None,
    volume_batch: int = 1,
    mesh=None,
    patch_forward=None,
):
    """Build fn(state, volume) -> stitched padded detections.

    ``state`` is a ``TrainState`` (its params and BN statistics are used);
    ``volume`` is (D, H, W, C), or (V, D, H, W, C) with V = ``volume_batch``,
    a numpy array or a tensor; it goes to the state's device. The result has
    boxes (V, top_k, 6) in the volume's fractional corner coordinates,
    labels, scores (V, top_k) and count (V,), on that device.

    ``patch_batch`` defaults to the padded patch grid rounded up to a
    multiple of 8, at most 32, or at most 128 with ``volume_batch > 1``
    (the throughput variant: V volumes' grids share device batches).
    ``per_patch_k`` caps the detections a patch keeps before the stitch
    (default max(top_k // 2, 16)); it is announced when the detector is
    built. ``patch_forward`` is an optional (state, patches) -> (locs,
    scores) in place of the model's eval forward. ``mesh``, a tuple of
    devices, shards every chunk over them (``patch_batch`` is rounded up to
    a multiple of their count, and an explicit one that does not divide
    raises); the result is on the first and equals the unsharded detector's.
    Each device's copy of the weights is made at the first call with a
    state and kept while the caller passes the same state.
    """
    shards = None if mesh is None else [_indexed(d) for d in mesh]
    n_shards = 1 if shards is None else len(shards)
    if patch_forward is None:
        model = SSD3D(config)

        def patch_forward(state, patches):
            return eval_forward(model, state, patches)

    patch = tuple(config.input_size)
    offsets = patch_offsets(volume_shape, patch, overlap)
    n_patches = offsets.shape[0]
    n_volumes = int(volume_batch)
    total = n_volumes * n_patches
    if patch_batch is None:
        patch_batch = min(-(-total // 8) * 8, 32 if n_volumes == 1 else 128)
        patch_batch = -(-patch_batch // n_shards) * n_shards
    if patch_batch % n_shards:
        raise ValueError(
            f"patch_batch={patch_batch} not divisible by the mesh's "
            f"{n_shards} devices"
        )
    shard_rows = patch_batch // n_shards
    # flat (volume, offset) work list, padded to whole device batches with
    # copies of the last patch of volume 0, masked out of the result
    n_padded = -(-total // patch_batch) * patch_batch
    vol_idx = np.concatenate([np.repeat(np.arange(n_volumes, dtype=np.int64), n_patches),
                              np.zeros(n_padded - total, np.int64)])
    offsets_padded = np.concatenate([np.tile(offsets, (n_volumes, 1)),
                                     np.repeat(offsets[-1:], n_padded - total, axis=0)])
    patch_valid = np.arange(n_padded) < total

    min_score = config.min_score if min_score is None else min_score
    max_overlap = config.max_overlap if max_overlap is None else max_overlap
    top_k = config.top_k if top_k is None else top_k
    if per_patch_k is None:
        per_patch_k = max(top_k // 2, 16)
    print(
        f"[sliding_window] {n_patches} patches of {tuple(patch)} over "
        f"{tuple(volume_shape)}; keeping <= {per_patch_k} detections/patch "
        f"before stitching (pass per_patch_k to raise)",
        flush=True,
    )
    priors_np = model_priors(config)
    on_device = {}

    def tables(device):
        """The work list, priors and sizes on ``device``, copied once."""
        if device not in on_device:
            def put(a, dtype=None):
                return torch.as_tensor(a, dtype=dtype).to(device)

            on_device[device] = dict(
                offsets=put(offsets_padded), vol_idx=put(vol_idx), valid=put(patch_valid),
                priors=put(priors_np, torch.float32),
                vol_size=put(volume_shape, torch.float32),
                patch_size=put(patch, torch.float32))
        return on_device[device]

    copies = {"state": None, "on": {}}

    def state_on(state, device):
        """``state``'s params and BN statistics on ``device``, copied once a state."""
        if device == state.device:
            return state
        if copies["state"] is not state:
            copies["state"], copies["on"] = state, {}
        if device not in copies["on"]:
            copies["on"][device] = state.replace(
                step=state.step.to(device),
                params={k: v.to(device) for k, v in state.params.items()},
                batch_stats={k: v.to(device) for k, v in state.batch_stats.items()})
        return copies["on"][device]

    def patch_candidates(state, volumes, chunk, device):
        """The patches ``chunk`` of the work list on ``device``: their
        detections in the volume's fractional coordinates, masked."""
        t = tables(device)
        scale = t["patch_size"] / t["vol_size"]
        offs = t["offsets"][chunk]
        patches = crop_patches(volumes, offs, patch, rows=t["vol_idx"][chunk])
        locs, scores = patch_forward(state, patches)
        det = detect_objects(locs, scores, t["priors"], n_classes=config.n_classes,
                             min_score=min_score, max_overlap=max_overlap,
                             top_k=per_patch_k)
        # to the volume's fractional coordinates, clipped to it (the
        # reference clips at save time, predict.py:195)
        off_frac = offs.float() / t["vol_size"]
        lo_c = det["boxes"][..., :3] * scale + off_frac[:, None, :]
        hi_c = det["boxes"][..., 3:] * scale + off_frac[:, None, :]
        k_slots = det["scores"].shape[-1]
        det_valid = ((torch.arange(k_slots, device=device)[None, :] < det["count"][:, None])
                     & t["valid"][chunk][:, None])
        return (torch.clamp(torch.cat([lo_c, hi_c], dim=-1), 0.0, 1.0),
                torch.where(det_valid, det["labels"], 0),
                torch.where(det_valid, det["scores"], 0.0))

    @torch.no_grad()
    def run(state, volume) -> dict:
        device = state.device if shards is None else shards[0]
        volumes = torch.as_tensor(volume).to(device)
        if volumes.ndim == 4:
            volumes = volumes[None]
        if tuple(volumes.shape[:4]) != (n_volumes, *volume_shape):
            raise ValueError(f"volumes {tuple(volumes.shape)} do not match the detector's "
                             f"{n_volumes} x {tuple(volume_shape)}")
        boxes_l, labels_l, scores_l = [], [], []
        if shards is None:
            for lo in range(0, n_padded, patch_batch):
                b, lab, sc = patch_candidates(state, volumes, slice(lo, lo + patch_batch), device)
                boxes_l.append(b)
                labels_l.append(lab)
                scores_l.append(sc)
        else:
            on = {d: (state_on(state, d), volumes.to(d)) for d in dict.fromkeys(shards)}
            for lo in range(0, n_padded, patch_batch):
                for i, d in enumerate(shards):
                    part = slice(lo + i * shard_rows, lo + (i + 1) * shard_rows)
                    for out, v in zip((boxes_l, labels_l, scores_l),
                                      patch_candidates(*on[d], part, d)):
                        out.append(v.to(device))
        # (padded patches, K, ...) -> drop the padding -> (V, per-volume candidates, ...)
        k_slots = boxes_l[0].shape[1]  # detect_objects may return < per_patch_k
        per_vol = n_patches * k_slots
        boxes = torch.cat(boxes_l).reshape(-1, 6)[: total * k_slots].reshape(
            n_volumes, per_vol, 6)
        labels = torch.cat(labels_l).reshape(-1)[: total * k_slots].reshape(n_volumes, per_vol)
        scores = torch.cat(scores_l).reshape(-1)[: total * k_slots].reshape(n_volumes, per_vol)

        # the stitch: each (volume, class) row's top-k candidates through one
        # batched greedy NMS, then each volume's global top-k across classes
        k = min(10 * top_k, per_vol)
        cand_boxes, cand_scores = [], []
        for c in range(1, config.n_classes):
            # overlapping patches report equal scores, and the NMS keeps the
            # first of them: ties go to the lower index on any device
            c_scores, c_idx = top_k_stable(torch.where(labels == c, scores, 0.0), k)
            cand_scores.append(c_scores)
            cand_boxes.append(torch.gather(boxes, 1, c_idx[..., None].expand(-1, -1, 6)))
        cm = config.n_classes - 1
        cand_boxes = torch.stack(cand_boxes, dim=1).reshape(n_volumes * cm, k, 6).contiguous()
        cand_scores = torch.stack(cand_scores, dim=1).reshape(n_volumes * cm, k)
        cand_valid = cand_scores > min_score
        if shards is not None and (n_volumes * cm) % n_shards == 0:
            rows = n_volumes * cm // n_shards
            keep = torch.cat([
                greedy_nms_cuda(cand_boxes[i * rows:(i + 1) * rows].to(d),
                                cand_valid[i * rows:(i + 1) * rows].to(d), max_overlap).to(device)
                for i, d in enumerate(shards)])
        else:
            keep = greedy_nms_cuda(cand_boxes, cand_valid, max_overlap)
        return select_detections(cand_boxes, cand_scores, keep, n_classes=config.n_classes,
                                 top_k=top_k)

    run.n_patches = n_patches
    run.volume_batch = n_volumes
    run.patch_batch = patch_batch
    return run
