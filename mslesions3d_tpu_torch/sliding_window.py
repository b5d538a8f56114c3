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
    scores) in place of the model's eval forward. ``mesh`` (patches over
    several cards) is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a sliding-window detector over several cards (mesh) is not ported yet "
            "(ROADMAP item 17b)")
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

    @torch.no_grad()
    def run(state, volume) -> dict:
        device = state.device
        t = tables(device)
        volumes = torch.as_tensor(volume).to(device)
        if volumes.ndim == 4:
            volumes = volumes[None]
        if tuple(volumes.shape[:4]) != (n_volumes, *volume_shape):
            raise ValueError(f"volumes {tuple(volumes.shape)} do not match the detector's "
                             f"{n_volumes} x {tuple(volume_shape)}")
        scale = t["patch_size"] / t["vol_size"]
        boxes_l, labels_l, scores_l = [], [], []
        for lo in range(0, n_padded, patch_batch):
            chunk = slice(lo, lo + patch_batch)
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
            boxes_l.append(torch.clamp(torch.cat([lo_c, hi_c], dim=-1), 0.0, 1.0))
            k_slots = det["scores"].shape[-1]
            det_valid = ((torch.arange(k_slots, device=device)[None, :] < det["count"][:, None])
                         & t["valid"][chunk][:, None])
            scores_l.append(torch.where(det_valid, det["scores"], 0.0))
            labels_l.append(torch.where(det_valid, det["labels"], 0))
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
        cand_boxes = torch.stack(cand_boxes, dim=1).reshape(n_volumes * cm, k, 6)
        cand_scores = torch.stack(cand_scores, dim=1).reshape(n_volumes * cm, k)
        keep = greedy_nms_cuda(cand_boxes.contiguous(), cand_scores > min_score, max_overlap)
        return select_detections(cand_boxes, cand_scores, keep, n_classes=config.n_classes,
                                 top_k=top_k)

    run.n_patches = n_patches
    run.volume_batch = n_volumes
    run.patch_batch = patch_batch
    return run
