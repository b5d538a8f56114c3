#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit; TF32 off for convs and matmuls.
2. build: nvcc builds every CUDA kernel of the served paths from ``csrc/``
   (K1 NMS, K2 fused depthwise, K3 fused tail, Q1 int8 conv), all at once, and
   ptxas's register, shared-memory and spill lines are printed; the tensor-
   core instructions (HMMA) in the built K3 library's SASS are counted per
   kernel function (cuobjdump -sass): the bf16 product must reach them.
3. K1 (greedy 3D NMS) against its plain torch version on the card, with
   exact equality of the keep masks, on synthetic cases and on the real
   candidate sets of the 96^3 model, at K = 1000 (the warp walk), at K =
   3942 on every wide walk (3, 2, 1 and 0 staged words) and at K = 28545,
   the first K past what one staged word holds (rows from global memory;
   its device time is taken there, while the card is empty). K2 against its plain version on the
   headline model's folded weights and real layer inputs (layers 3, 5, 7 at
   batch 8, layer 3 at batch 32, and layer 3 with the BN statistics
   calibrated on seeded volumes) and at depths 1-3, in bf16 and float32:
   0 mismatches (the design is exact). K3
   against its plain version on the headline tail (layers 4-7) and the real
   layer-3 output at batch 8 and 32, in bf16, at batch 8 once more with
   the BN statistics calibrated on seeded volumes (maps of unit scale), and
   on a seeded 24^3 input, which takes K3's per-block variant.
4. the slices, each with the launch counts set to 0 just before it and read
   just after: a ``Detector`` at the bench's headline configuration (96^3,
   bf16, full width, random weights from a seed) serves requests of 1, 3
   and 8 volumes through a ``RequestBatcher``, first on the default path
   (K1 must launch), then with ``use_pallas`` and ``use_pallas_tail`` (K1,
   K2 and K3 must launch; K2 once a forward, and 3 times a forward with
   ``use_pallas`` alone). The kernel and plain NMS give identical
   detections on the same (locs, scores); the flagged model's locs/scores
   agree with the default path's on the same weights, raw and BN-calibrated,
   and both are set beside the float32 model's; the fp32 forward on
   the card agrees with the CPU's, with and without the flags. A
   ``Detector`` with top_k = 395 (K = 3942, the wide walk) on the default
   and the fused path launches K1 once a call, and its detections equal
   the plain NMS's.
4b. the training path, with the launch counts set to 0 just before it and
   read just after, at the bench's training geometry (64^3 bf16, full
   width, lr 1e-3, soft matching [0.1, 0.2], flips and rot90 on the card):
   a ``TrainState`` from seed 0 takes 20 steps at batch 8 on a seeded batch
   (randn volumes with two painted cubes; every loss finite, the last 5
   below the first 5) and 10 at batch 64, with no kernel launched by a
   plain train step; then the ``with_detections`` train step and the eval
   step, also at min_score 0.05 so that some candidates pass (K1 must
   launch; their detections equal the plain NMS's on the same locs and
   scores, taken from the model's forward hook), and the eval step with
   ``use_pallas`` + ``use_pallas_tail``, at 0.5 and 0.05 (K1, K2 and K3
   must launch; their detections equal the plain NMS's, and K2 and K3 are
   held against their plain versions on the operands this step gave them:
   layer 3 at 8^3 and the tail from its output).
   Times: ms per step and volumes/s at batch 8 and 64 and the eval step's
   ms (CUDA events, median of 3 rounds), the peak memory, and (at the end)
   a torch.profiler breakdown of a step: top kernels, launches per step and
   the device's idle share.
4c. the training entry point, with the launch counts set to 0 just before
   it and read just after: ``data.generate`` writes the JAX package's 4k
   headline dataset (64^3, objects of 6-14 voxels, 1-5 of them, seed 0), cut
   to 40 images, into a temporary directory, and ``cli.train.main`` trains
   on it on the card with the recipe's flags (-b 8 -lr 0.003 -th 0.1 0.2
   -bpl 3 --alpha 2 -a flip rotate90 zoom -sr cosine_annealed
   --hard_negative_mining 1 -es 0), cut to -mi 24 (6 epochs of 4 steps),
   float32, full width: every loss finite, 6 history entries with mAP, the
   top-3 and ``last`` checkpoints, K1 once a validation batch and once a
   train-metric step (K2, K3 never); one validation batch from ``last``
   gives the plain NMS's detections; the bare gathered step is timed at the
   same configuration beside the trainer's ms per step; then a resume from
   ``last`` trains one more epoch. Times: generation, materialize, ms per
   step by epoch, validation seconds by epoch, the peak memory.
4d. the scoring entry points on 4c's ``last`` checkpoint, in its temporary
   directory, each run with the launch counts set to 0 just before it and
   read just after: ``cli.predict.main`` (-ps validation -sc 0.0 -k 100,
   batch 1) on the default path writes every validation subject's
   ``_preds.json`` / ``.csv`` / ``.nii.gz`` and both per-subject metric
   files, K1 launches once a predict batch, and every subject's saved
   detections equal the plain NMS's on the locs and scores its forward gave
   (a forward hook); then on a copy of the checkpoint with ``use_pallas``
   and ``use_pallas_tail`` set: K1, K2 and K3 launch as ``plan_depthwise``
   / ``plan_tail`` give for the config's dtype, K2 and K3 are held against
   their plain versions on the operands predict gave them, and the locs and
   scores, and each subject's detection count and sorted saved scores,
   agree with the default path's within 5% (relative). ``cli.eval``
   scores the default run over IoU {0.1, 0.5} x min_score {0.1, 0.2, 0.3,
   0.5, 0.7} (10 metric files, reduced to their operating-point maxima as
   tools/quality_stats.py does); ``last`` saved as a Lightning-style .ckpt
   goes through ``cli.import_torch`` and a predict on the import gives the
   original run's files byte for byte; ``cli.tune_lr`` sweeps 20 steps and
   suggests a finite lr; ``cli.model_insight priors`` writes the prior
   wireframes. Times: seconds a volume of each predict (host clock) and the
   predict step's ms (CUDA events), eval's seconds.
4e. full-resolution volumes, each run with the launch counts set to 0 just
   before it and read just after. The sliding window at BASELINE config #3
   (the headline model with its BN calibrated, seeded 192x224x192 volumes
   in 27 patches of 96^3) at volume_batch 1 and 4, on the default path and
   with both flags: every K1 launch (a chunk's per-patch ``detect_objects``
   and the stitch: 2 a call) keeps what the plain NMS keeps on the same
   candidates, K2 and K3 launch once a chunk's forward (as ``plan_tail``
   gives) and are held against their plain versions on the operands this
   path gave them; volumes/s, device ms a call and peak memory. One call at
   top_k 395, whose stitch (K = 3950) takes the wide walk. Then 32 volumes
   of 96^3 generated into the temporary directory, ``cli.train --patch_size
   64 64 64`` for 24 steps with the full-volume validation through the
   sliding window on every epoch, and ``cli.predict -sw 1`` on the
   validation volumes, every K1 launch of both held against the plain NMS;
   the 64^3 bf16 train step at batch 64 with and without ``remat`` (the
   step's peak memory must fall, and the memory the forward keeps for the
   backward is logged; the first step's loss and gradient norm and the second
   step's loss agree within 4e-3, and the BN running statistics after the
   first step within 1e-3, so they moved once); the ConvNet
   (``convnet_maxpool_double``, layers 6 and 9, 64^3 bf16, full widths,
   dropout from the step's generator): 10 steps at batch 8 (finite losses,
   the last below the first) and an eval step whose detections (K1) equal
   the plain NMS's; ``materialize`` with ``device_boxes`` (connected
   components on the card) gives the host path's boxes.
4f. deployment, each run with the launch counts set to 0 just before it and
   read just after. The headline model with its BN calibrated is exported
   (``serving.export_detector``, ``torch.export`` with K1-K3 as registered
   ops) at batch 1, 8 and 32, on the default path and with both flags,
   saved and loaded in a fresh ``ServingDetector``: requests of 1, 3 and 8
   volumes give the live ``Detector.predict``'s detections exactly, a
   bundle call launches K1 once (and K2, K3 once with both flags), and the
   bundle's size, export and load seconds and volumes/s against the live
   Detector (live, bundle, bundle, live) are logged. int8: the model
   quantized on the card from 2 seeded calibration volumes; Q1 is held
   against its plain version on every conv of one forward (0 int32
   mismatches, the epilogue bit for bit), timed by conv kind beside its
   bound, its plain version, a float64 F.conv3d of the same integers and
   ``torch._int_mm`` on the pointwise shapes; the int8 bundle (batch 8 and
   32) equals the live int8 program, launches K1 once and Q1 once a conv,
   and is set beside the bf16 bundle (relative error of locs and scores,
   detections matched at IoU > 0.5, volumes/s). The sliding-window bundle
   at config #3 (V = 1) equals the live sliding window and launches K1
   twice a call. ``cli.serve.make_http_server`` on the default bundle at
   batch 1 and 8 under 8 client threads x 4 POSTs of one volume: every
   response equals a direct predict of its volume, fewer device calls than
   requests, p50/p95 latency and volumes/s.
4g. data parallelism on the one card, each run with the launch counts set
   to 0 just before it and read just after. (a) Phase 4c's ``cli.train``
   recipe (24 steps) without ``--data_parallel``, with ``--data_parallel 1``
   (a one-rank NCCL group formed in the process, whose collectives run) and
   without it again: the training losses bit-equal and the launches equal;
   the bare gathered step at the recipe's configuration with and without
   the mesh of one (the collectives' price, in turns). (b) Two ranks
   spawned on the card under gloo (CUDA tensors; if gloo refuses them the
   phase says so and runs CPU tensors): the 64^3 bf16 step at global batch
   8 with augmentation, 4 rows a rank, against the 1-rank step on the same
   batch and generator (losses, gradient norm, the gradient vector, BN
   statistics and each rank's forward within the stated bounds, the params
   moved the 1-rank step's way wherever the gradient stands above the
   rounding noise, the ranks' states bit-equal), and the
   ``with_detections`` step (K1 once a rank, held against the plain NMS on
   each rank's locs and scores; the ranks' detections against the 1-rank
   step's: counts equal, each within the stated bound of one of the same
   volume and label). (c) The sliding window at config #3 over
   ``mesh=("cuda:0", "cuda:0")`` (V = 1 and 4, default path and both
   flags): K1 once a shard of each chunk and at each stitch shard, every
   launch held against the plain NMS, K2 and K3 once a shard and held
   against their plain versions, detections equal to the unsharded
   detector's, volumes/s in turns; ``cli.predict -sw 1 --sw_data_parallel
   1`` on phase 4e's checkpoint writes phase 4e's files byte for byte.
   (d) The ConvNet's dropout masks at 64^3 drawn for W = 1, 2 and 8 ranks'
   global batch. The phase's checks are all made, and any failure fails it.
4h. spatial sharding on the one card: two ranks spawned on it under gloo
   form a 1 x 2 data x spatial mesh (``parallel.make_mesh_2d``), MobileNet
   at full width in bf16, each run with the launch counts set to 0 in the
   ranks just before it and read just after. (a) The train step at BASELINE
   config #3's volume (batch 2 of 192x224x192, flips) against the unsharded
   step on the same card: losses, gradient norm, the gradient vector, each
   leaf's norm and the BN statistics within the stated bounds; each rank's
   peak memory beside the unsharded step's; ms a step; the same step with
   ``remat`` (the blocks recomputed in the backward under their forward's
   split) held to the same bounds against the unsharded step without it,
   with its peak memory. (b) The sharded eval
   forward (``make_spatially_sharded_forward``) and eval step at batch 1 of
   the 96^3 headline with its BN calibrated, default path and both flags:
   K2 once a forward a rank on its haloed slab of layer 3 (0 mismatches
   against its plain version; its middle planes against the unsharded
   K2's), K3 once a forward a rank past the cut (within its bound), K1 once
   an eval step (equal to the plain NMS), the locs, scores and detections
   against the unsharded detector's. (c) ``cli.train --spatial_shards 2`` on
   phase 4c's recipe cut to 4 steps, streaming, beside the 1-rank streaming
   run: its validation loss within the JAX trainer test's tolerance. The
   phase's checks are all made, and any failure fails it.
4i. tensor parallelism on the one card: gloo ranks spawned on it form data x
   spatial x model meshes (``parallel.make_mesh_3d``), MobileNet at full
   width in bf16, each run with the launch counts set to 0 in the ranks just
   before it and read just after. (a) Two ranks on a 1 x 1 x 2 mesh: the
   forward (``make_tensor_parallel_forward``) and the eval step at batch 8
   of the 96^3 headline with its BN calibrated, default path and both flags,
   against the unsharded model on the same card: locs, scores and
   detections within the stated bounds; K2 once a forward a rank on its 64
   channels of layer 3 (0 mismatches against its plain version; its
   channels against the unsharded K2's), K3 once a forward a rank on the
   gathered 128 channels (within its bound), K1 once an eval step (equal to
   the plain NMS); each rank's parameter bytes, peak memory and ms a
   forward beside the unsharded model's. (b) Four ranks on a 1 x 2 x 2
   mesh: the 64^3 bf16 train step at global batch 2 with flips against the
   unsharded step (losses, gradient norm, the gradient vector, each leaf's
   norm and the BN statistics within the stated bounds; each rank's peak
   memory and ms a step). (c) ``materialize`` of phase 4c's 40 volumes with
   the native NIfTI loader and with its plain version (the Python decode
   and normalisation), in turns, the arrays held against each other. The
   phase's checks are all made, and any failure fails it. It runs after
   phase 5's times: the rank processes it starts on the card would make
   the profiler of this process drop kernel records from later traces.
5. times on the card: K1 (at K = 1000, and at K = 3942 for N = 8 and 32;
   on the full-volume path: a chunk's per-patch NMS at N = 32, K = 500 and
   the stitch at V = 1 and 4, K = 1000, and at top_k 395, K = 3950),
   K2 and K3 beside their plain versions and bounds (and K2 at layers
   3/5/7 at batch 8 and layer 3 at batch 32 beside the cuDNN conv + BN +
   ReLU it replaces, its first version (the direct variant) and one
   F.conv3d with the BN folded in), each as device
   time (torch.profiler; a kernel's the median of 3 rounds, beside the card's
   SM clock) and per call (CUDA events), the device time split
   by kernel function (K1's mask and walk launches, K3's kernel) and K3's
   by block (chain prefixes at batch 8), the detect path
   for the four flag settings, end-to-end volumes/s at batch 1, 8 and 32 on
   the default and the fused path, the host time the registered ops add a
   call at batch 1 (K1-K3: the wrapper against the launch function alone),
   and torch.profiler breakdowns of the device time by kernel with the
   device's idle share.
6. one JSON line listing every ported kernel, then the card line, then the
   result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from mslesions3d_tpu_torch.cli import import_torch as import_cli
from mslesions3d_tpu_torch.cli import model_insight as insight_cli
from mslesions3d_tpu_torch.cli import plots, recipe
from mslesions3d_tpu_torch.cli import predict as predict_cli
from mslesions3d_tpu_torch.cli.serve import make_http_server
from mslesions3d_tpu_torch.cli import train as train_cli
from mslesions3d_tpu_torch.cli import tune_lr as tune_lr_cli
from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.data.boxes_from_seg import boxes_from_segmentation
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.data.nifti import load_nifti
from mslesions3d_tpu_torch.data.transforms import t_normalize_intensity
from mslesions3d_tpu_torch.kernels.build import build, find_nvcc
from mslesions3d_tpu_torch.kernels.depthwise import (
    depthwise_bn_relu,
    depthwise_taps,
    fused_depthwise_bn_relu_cuda,
    plan_depthwise,
)
from mslesions3d_tpu_torch import kernels, quant
from mslesions3d_tpu_torch.kernels.nms import greedy_nms, greedy_nms_cuda, plan_nms
from mslesions3d_tpu_torch.kernels.qconv import (
    qconv_cuda,
    qconv_epilogue,
    qconv_s32,
    qconv_s32_cuda,
)
from mslesions3d_tpu_torch.kernels.tail import fused_tail_cuda, plan_tail, tail_reference
from mslesions3d_tpu_torch.models.losses import multibox_loss_from_config
from mslesions3d_tpu_torch.native import load_nifti_fast
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch import sliding_window
from mslesions3d_tpu_torch.models import layers as model_layers
from mslesions3d_tpu_torch.models import mobilenet as model_mobilenet
from mslesions3d_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    make_spatially_sharded_forward,
    make_tensor_parallel_forward,
    shard_batch,
    shard_tree,
    tensor_sharding,
    unshard_tree,
)
from mslesions3d_tpu_torch.ops import nms as nms_ops
from mslesions3d_tpu_torch.ops.metrics import calculate_mAP
from mslesions3d_tpu_torch.ops.boxes import pairwise_iou
from mslesions3d_tpu_torch.ops.nms import (
    detect_objects,
    detections_to_lists,
    nms_candidates,
    select_detections,
)
from mslesions3d_tpu_torch.serving import (
    DetectionProgram,
    Detector,
    RequestBatcher,
    ServingDetector,
    export_detector,
    export_sliding_window_detector,
    save_bundle,
)
from mslesions3d_tpu_torch.train import (
    create_train_state,
    eval_view,
    load_checkpoint,
    make_eval_step,
    make_gathered_eval_step,
    make_gathered_train_step,
    make_predict_step,
    make_sharded_gathered_train_step,
    make_train_step,
)
from mslesions3d_tpu_torch.train.state import BIAS_MULT, is_bias
from mslesions3d_tpu_torch.train.steps import _cast
from mslesions3d_tpu_torch.utils import profiling

# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bf16 on the tensor cores, and device memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per candidate pair in csrc/nms.cu: per axis min, max,
# sub, clamp (12); two products; add, sub and div for the union and IoU;
# the compare.
NMS_OPS_PER_PAIR = 18
# float32 operations per output element of a depthwise 3^3 + BN + ReLU:
# 27 products, 27 sums, the BN product and sum, the ReLU.
DW_OPS_PER_ELEMENT = 57
HEADLINE = dict(n_classes=2, input_channels=1, input_size=(96, 96, 96), dtype="bfloat16",
                min_score=0.5, max_overlap=0.5, top_k=100)
FLAG_SETTINGS = {
    "off": {}, "use_pallas": dict(use_pallas=True),
    "use_pallas_tail": dict(use_pallas_tail=True),
    "both": dict(use_pallas=True, use_pallas_tail=True),
}
KERNELS = ("nms", "depthwise", "tail", "qconv")
# K1 past the warp walk: the 96^3 model's every prior (top_k >= 395), and the
# first K past what one staged word of the wide walk holds (plan_nms)
WIDE_K, FAR_K = 3942, 28545
# the bench's training geometry (bench.py build_train) and its augmentation
TRAIN = dict(n_classes=2, input_channels=1, input_size=(64, 64, 64), dtype="bfloat16", lr=1e-3,
             threshold=[0.1, 0.2])
TRAIN_AUGMENT = dict(flip_axes=(0, 1, 2), rot90_planes=((1, 2),))
TRAIN_BOXES = ((0.2, 0.2, 0.2, 0.5, 0.5, 0.5), (0.6, 0.6, 0.6, 0.8, 0.8, 0.8))
# the JAX package's 4k headline recipe (cli/recipe.py): its dataset cut to
# 40 images, its training flags cut to 24 steps (6 epochs of 4), full
# width, float32; scored as the recipe scores
RECIPE_DATA = {**recipe.DATA, "num_images": 40}
RECIPE_STEPS = 24
TUNE_LR_STEPS = 20
# BASELINE config #3 (bench.py:204-233): the headline model over whole
# 192x224x192 volumes in 96^3 patches; patch training from disk on 96^3
# volumes of the recipe's objects (64^3 was the 4k recipe's whole volume),
# cut to 32 volumes and 24 steps; the ConvNet at the training geometry
FULL_VOLUME = (192, 224, 192)
PATCH_DATA = {**recipe.DATA, "num_images": 32, "image_size": (96, 96, 96)}
PATCH_STEPS = 24
CONVNET = dict(TRAIN, base_network_config="convnet_maxpool_double",
               aspect_ratios={6: [1.0], 9: [1.0]})
# remat against the plain step, bf16: the first step's loss and gradient
# norm and the second step's loss (one bf16 ulp: the same arithmetic but
# for the order of cuDNN's sums in the recompute); the BN running statistics
# after the first step (moved twice, their means would be 90% off)
REMAT_RTOL = 4e-3
REMAT_STATS_RTOL = 1e-3
# K3 in float32 against its plain version (tests/test_torch_gpu_tail.py)
TAIL_F32_RTOL = TAIL_F32_ATOL = 1e-5
# K3 in bf16 against its plain version: share of differing elements per
# emitted map (5, 7); tests/test_torch_port_tail.py sets out why
TAIL_MAX_DIFFERING = (0.01, 0.15)
# K3 in bf16 against the float64 chain, in bf16 ulps (compare_tail_exact)
TAIL_EXACT_ULPS = 2.0
# the flagged model's locs/scores against the default path's, bf16 at 96^3:
# relative Frobenius error. The two round differently (K2 once instead of
# twice, K3 keeps float32 between blocks), each about bf16's 2^-8 per step.
PATHS_MAX_REL_ERR = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def log(*parts) -> None:
    print("#", *parts, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clocks() -> str:
    """The card's SM clock (now and its maximum), power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def device_ms(fn, iters: int) -> tuple[float, dict]:
    """``utils.profiling.device_ms``, reporting through :func:`log`."""
    return profiling.device_ms(fn, iters, log=log)


def device_ms_rounds(fn, iters: int, rounds: int = 3) -> tuple[list, dict]:
    """``utils.profiling.device_ms_rounds``, reporting through :func:`log`."""
    return profiling.device_ms_rounds(fn, iters, rounds, log=log)


def profile_calls(label, what, fn, card, calls=3, top=12) -> dict:
    """``utils.profiling.profile_calls``, reporting through :func:`log`."""
    return profiling.profile_calls(label, what, fn, card, calls, top, log=log)


def hmma_counts(library) -> dict:
    """Tensor-core (HMMA) instructions per kernel function in a library's SASS."""
    sass = subprocess.run([str(find_nvcc().with_name("cuobjdump")), "-sass", str(library)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            function = line.split("Function : ")[1].strip()
            counts[function] = 0
        elif function is not None and "HMMA" in line:
            counts[function] += 1
    return counts


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at the magnitude of v (float32 tensor)."""
    tiny = torch.finfo(dtype).tiny
    return torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(tiny))))


def bound(ops_by_peak: dict, nbytes: float):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    each kind of operations over its peak rate."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = max((ops / peak * 1e3 for peak, ops in ops_by_peak.items()), default=0.0)
    return max(bytes_ms, ops_ms), ("operations" if ops_ms > bytes_ms else "bytes")


# ---------------------------------------------------------------- NMS cases
def clustered_case(rng, n=4, k=200):
    """K=200, not a multiple of 32 or 128; random validity."""
    centers = rng.uniform(0.2, 0.8, size=(n, 25, 3))
    idx = rng.integers(0, 25, size=(n, k))
    lo = np.clip(np.take_along_axis(centers, idx[..., None], 1)
                 + rng.normal(0, 0.03, (n, k, 3)) - 0.04, 0, 1)
    hi = np.clip(lo + rng.uniform(0.04, 0.12, (n, k, 3)), 0, 1)
    return np.concatenate([lo, hi], -1), rng.uniform(size=(n, k)) > 0.15


def prefix_case(rng, n=3, k=384):
    """Validity a prefix of 90, 200 and all 384 candidates."""
    lo = rng.uniform(0, 0.7, (n, k, 3))
    hi = np.clip(lo + rng.uniform(0.05, 0.3, (n, k, 3)), 0, 1)
    valid = np.zeros((n, k), bool)
    valid[0, :90], valid[1, :200], valid[2, :] = True, True, True
    return np.concatenate([lo, hi], -1), valid


def random_case(rng, n=128, k=1000):
    """Clustered boxes with a random valid prefix per row, some rows empty."""
    boxes, _ = clustered_case(rng, n, k)
    valid = np.arange(k)[None, :] < rng.integers(0, k + 1, size=(n, 1))
    valid[0], valid[1:4] = False, True  # an empty row and full rows
    return boxes, valid


def near_threshold_case():
    """Unit cubes offset by the float32 neighbours of 1/3: IoU straddles 0.5."""
    third = np.float32(1) / np.float32(3)
    shifts = [third]
    for _ in range(6):
        shifts = [np.nextafter(shifts[0], np.float32(0)), *shifts,
                  np.nextafter(shifts[-1], np.float32(1))]
    rows = []
    for j, s in enumerate(shifts):
        scale = np.float32([0.125, 0.25, 0.1, 0.3][j % 4])
        a = np.float32([0.1, 0.2, 0.05, 0.1 + scale, 0.2 + scale, 0.05 + scale])
        b = a.copy()
        b[j % 3] += s * scale
        b[j % 3 + 3] += s * scale
        empty = np.float32([0.1, 0.2, 0.05, 0.1, 0.2, 0.05])
        rows.append(np.stack([a, b, empty, empty]))
    boxes = np.stack(rows)
    return boxes, np.ones(boxes.shape[:2], bool)


def compare_nms(name, boxes, valid, max_overlap=0.5, plan=None) -> int:
    """Run K1 and the plain version on the same card tensors; returns mismatches."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device="cuda").contiguous()
    valid = torch.as_tensor(valid, dtype=torch.bool, device="cuda").contiguous()
    keep = greedy_nms_cuda(boxes, valid, max_overlap, plan=plan)
    torch.cuda.synchronize()
    plain = greedy_nms(boxes, valid, max_overlap)
    mismatches = int((keep != plain).sum())
    plan = plan or plan_nms(boxes.shape[1])
    log(f"K1 vs plain [{name}]: N={boxes.shape[0]} K={boxes.shape[1]} "
        f"valid share {float(valid.float().mean()):.3f} kept {int(keep.sum())} "
        f"mismatches {mismatches} ({describe_nms(plan)})")
    check(mismatches == 0, f"K1 disagrees with the plain NMS on {name}")
    return mismatches


def describe_nms(plan) -> str:
    walk = ("warp walk" if plan.walk == "warp" else
            f"wide walk, {plan.stages} staged words" if plan.stages else
            "wide walk, kept rows from global memory")
    return (f"{walk}, {plan.smem:,} B shared memory, mask grid {plan.mask_grid[0]} x "
            f"{plan.mask_grid[1]} blocks a row")


def nms_bound(valid: torch.Tensor):
    """(bound ms, bound_by, operations, bytes) of greedy NMS on these candidates.

    The work depends on the data: only pairs below each row's last valid
    candidate are counted, as the kernel skips the rest.
    """
    n, k = valid.shape
    pos = torch.arange(1, k + 1, device=valid.device)
    last = torch.where(valid, pos, 0).amax(dim=1).double()
    ops = float((last * (last - 1) / 2).sum()) * NMS_OPS_PER_PAIR
    nbytes = n * k * (6 * 4 + 1) + n * k  # boxes and valid in, keep out
    return (*bound({PEAK_FP32_FLOPS: ops}, nbytes), ops, nbytes)


# ---------------------------------------------------------------- K2 and K3
def block_dw_operands(block, dtype):
    """(weights, gamma, beta) of a block's depthwise half, weights in dtype."""
    gamma, beta = block.bn1.folded()
    return block._dw_weights().to(dtype), gamma, beta


def describe(plan) -> str:
    if plan.variant == "direct":
        return "direct variant (the first version)"
    return (f"tiled: {plan.td} depths x {plan.th} rows x {plan.cs} channels a CTA, {plan.grid} "
            f"CTAs of {plan.threads} threads, {plan.smem:,} B shared memory, {plan.vec}-byte "
            "copies")


def compare_dw(name, x, weights, gamma, beta):
    """K2 and its plain version on the same card tensors: (mismatches, max abs
    err). The design is exact, so the tolerance is 0 mismatches."""
    out = fused_depthwise_bn_relu_cuda(x, weights, gamma, beta)
    torch.cuda.synchronize()
    plain = depthwise_bn_relu(x, weights, gamma, beta)
    mismatches = int((out != plain).sum())
    err = float((out.float() - plain.float()).abs().max())
    log(f"K2 vs plain [{name}] {tuple(x.shape)} {str(x.dtype)[6:]} "
        f"({describe(plan_depthwise(x.dtype, x.shape))}): mismatches {mismatches} of "
        f"{out.numel():,}, max abs err {err:.3e} (tolerance: 0 mismatches)")
    check(mismatches == 0, f"K2 disagrees with its plain version on {name}")
    return mismatches, err


def merge_dw_checks(prev, new):
    """Two K2 checks' (mismatches, max abs err) as one: the mismatches
    summed, the larger error."""
    return new if prev is None else (prev[0] + new[0], max(prev[1], new[1]))


def dw_bound(x):
    n, c, e = x.numel(), x.shape[1], x.element_size()
    nbytes = 2 * n * e + 27 * c * e + 2 * c * 4  # x in, out, weights, gamma/beta
    return bound({PEAK_FP32_FLOPS: n * DW_OPS_PER_ELEMENT}, nbytes)


def compare_tail(name, x, layers, emit):
    """K3 and its plain version on the same card tensors: (max abs err, shares)."""
    outs = fused_tail_cuda(x, layers, emit)
    torch.cuda.synchronize()
    refs = tail_reference(x, layers, emit)
    errs, shares = [], []
    if x.dtype == torch.float32:
        for j, (out, ref) in enumerate(zip(outs, refs)):
            diff = (out - ref).abs()
            within = bool((diff <= TAIL_F32_ATOL + TAIL_F32_RTOL * ref.abs()).all())
            errs.append(float(diff.max()))
            shares.append(float((diff > 0).float().mean()))
            log(f"K3 vs plain [{name}] map {j} {tuple(out.shape)} float32: differing share "
                f"{shares[-1]:.5f}, max abs err {errs[-1]:.3e} (bound: rtol {TAIL_F32_RTOL}, "
                f"atol {TAIL_F32_ATOL}: {'met' if within else 'NOT met'})")
            check(within, f"K3 disagrees with its plain version on {name}")
        return max(errs), shares
    for j, (out, ref, max_share) in enumerate(zip(outs, refs, TAIL_MAX_DIFFERING)):
        a, b = out.float(), ref.float()
        diff = (a - b).abs()
        mag = torch.maximum(a.abs(), b.abs())
        within = bool((diff <= ulp(mag.clamp_min(float(mag.max()) / 4), x.dtype)).all())
        share = float((diff > 0).float().mean())
        errs.append(float(diff.max()))
        shares.append(share)
        log(f"K3 vs plain [{name}] map {j} {tuple(out.shape)}: differing share {share:.5f} "
            f"(bound {max_share}), max abs err {errs[-1]:.3e} (bound: one bf16 ulp at the "
            f"larger of the element's magnitude and a quarter of the map's largest, "
            f"{float(mag.max()):.4f}: {'met' if within else 'NOT met'})")
        check(within and share < max_share, f"K3 disagrees with its plain version on {name}")
    return max(errs), shares


def tail_float64(x, layers, emit) -> list:
    """K3's function in float64 with the kernel's rounding points (the
    weights and each block's depthwise output y in x's dtype), as the
    referee of ``compare_tail_exact``."""
    wdtype = x.dtype
    cur = x.permute(0, 2, 3, 4, 1).double()
    outs = []
    for i, layer in enumerate(layers):
        acc = depthwise_taps(cur, layer["dw_w"].to(wdtype).double(), int(layer["stride"]))
        y = torch.relu(acc * layer["dw_gamma"].double() + layer["dw_beta"].double())
        z = torch.matmul(y.float().to(wdtype).double(), layer["pw_w"].to(wdtype).double())
        cur = torch.relu(z * layer["pw_gamma"].double() + layer["pw_beta"].double())
        if i in emit:
            outs.append(cur.permute(0, 4, 1, 2, 3))
    return outs


def compare_tail_exact(name, x, layers, emit):
    """K3 in bf16 against its plain version, refereed by the float64 chain:
    (max abs err against the plain version, shares).

    Both are float32 sums of bf16 products in different orders, and a sum a
    float32 ulp apart can round a block's y to the other bf16 neighbour; four
    blocks on, the two may lie more than one bf16 ulp apart where each is
    over one ulp from the float64 chain (BN-calibrated operands at batch
    32). So the bound: every element of K3 within TAIL_EXACT_ULPS bf16 ulps of the
    float64 chain at the larger of its magnitude and a quarter of the map's
    largest, K3's largest such error no more than half an ulp above the
    plain version's, and the share of elements where K3 and the plain
    version differ under TAIL_MAX_DIFFERING."""
    outs = fused_tail_cuda(x, layers, emit)
    torch.cuda.synchronize()
    refs = tail_reference(x, layers, emit)
    exact = tail_float64(x, layers, emit)
    errs, shares = [], []
    for j, (out, ref, ex, max_share) in enumerate(zip(outs, refs, exact, TAIL_MAX_DIFFERING)):
        scale = ulp(torch.maximum(ex.abs(), ex.abs().max() / 4).float(), x.dtype).double()
        k3_ulps = float(((out.double() - ex).abs() / scale).max())
        plain_ulps = float(((ref.double() - ex).abs() / scale).max())
        apart = float(((out.double() - ref.double()).abs() / scale).max())
        share = float((out != ref).float().mean())
        errs.append(float((out.float() - ref.float()).abs().max()))
        shares.append(share)
        within = k3_ulps <= TAIL_EXACT_ULPS and k3_ulps <= plain_ulps + 0.5
        log(f"K3 vs plain [{name}] map {j} {tuple(out.shape)}: differing share {share:.5f} "
            f"(bound {max_share}), max abs err {errs[-1]:.3e}, {apart:.3f} bf16 ulps apart; "
            f"from the float64 chain: K3 {k3_ulps:.3f} ulps, plain {plain_ulps:.3f} (bound: "
            f"K3 within {TAIL_EXACT_ULPS} and within the plain's + 0.5: "
            f"{'met' if within else 'NOT met'})")
        check(within and share < max_share, f"K3 disagrees with its plain version on {name}")
    return max(errs), shares


def merge_tail_checks(prev, new):
    """Two K3 checks' (max abs err, differing shares) as one."""
    return new if prev is None else (max(prev[0], new[0]), [*prev[1], *new[1]])


def tail_bound(x, layers, emit):
    """Bytes: x in, emitted maps out, weights once; operations: the depthwise
    and epilogue float32 work, and the pointwise products on the tensor cores
    (bf16) or in float32."""
    e, b = x.element_size(), x.shape[0]
    dims = x.shape[2:]
    nbytes, fp32_ops, pw_ops = x.numel() * e, 0, 0
    for i, layer in enumerate(layers):
        s = int(layer["stride"])
        cin, cout = layer["pw_w"].shape
        dims = [(n - 1) // s + 1 for n in dims]
        vox = b * dims[0] * dims[1] * dims[2]
        fp32_ops += vox * cin * DW_OPS_PER_ELEMENT + vox * cout * 3
        pw_ops += vox * cin * cout * 2
        nbytes += (27 * cin + cin * cout) * e + 2 * (cin + cout) * 4
        if i in emit:
            nbytes += vox * cout * e
    pw_peak = PEAK_BF16_TENSOR_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    if pw_peak == PEAK_FP32_FLOPS:
        return bound({PEAK_FP32_FLOPS: fp32_ops + pw_ops}, nbytes)
    return bound({PEAK_FP32_FLOPS: fp32_ops, pw_peak: pw_ops}, nbytes)


@torch.no_grad()
def calibrate_bn(model, x) -> None:
    """Set every BN's running statistics of the tower to the batch statistics
    of its input on x, layer by layer, as training would leave them, so the
    activations keep unit scale through the tower. (With the init's identity
    BN they shrink about threefold a block, and the tail's maps are ~1e-4.)"""
    def fit(bn, y):
        y32 = y.float()
        bn.running_mean.copy_(y32.mean(dim=(0, 2, 3, 4)))
        bn.running_var.copy_(y32.var(dim=(0, 2, 3, 4), unbiased=False))
        return torch.relu(bn(y))

    h = x.permute(0, 4, 1, 2, 3)
    for layer in model.base.features:
        if hasattr(layer, "conv1"):
            h = fit(layer.bn2, layer.conv2(fit(layer.bn1, layer.conv1(h))))
        else:
            h = fit(layer[1], layer[0](h))


def unfused_depthwise(block, x):
    """The default path's depthwise half: cuDNN conv, BN, ReLU."""
    return torch.relu(block.bn1(block.conv1(x)))


def folded_conv_operands(weights, gamma, beta):
    """F.conv3d's weight (C, 1, 3, 3, 3) and bias with the BN folded in, in
    the weights' dtype: the one PyTorch call nearest K2's function (it
    omits the ReLU and rounds otherwise; never used by the port)."""
    w = weights.float().permute(3, 0, 1, 2).unsqueeze(1) * gamma.view(-1, 1, 1, 1, 1)
    return w.to(weights.dtype), beta.to(weights.dtype)


def layer_inputs(model, x):
    """The input of every backbone layer of the default-path model."""
    h, ins = x.permute(0, 4, 1, 2, 3), []
    for layer in model.base.features:
        ins.append(h)
        h = layer(h)
    return ins


# ---------------------------------------------------------------- profiling
def profile_detect(name, detector, x, card, calls=3):
    with torch.inference_mode():
        profile_calls(name, f"Detector.detect calls at batch {x.shape[0]}",
                      partial(detector.detect, x), card, calls)


def serve(detector, requests, counters):
    """Serve the requests through a RequestBatcher; launch counts of the run."""
    batcher = RequestBatcher(detector.predict, max_rows=32)
    try:
        for c in counters:
            c.launches = 0
        with ThreadPoolExecutor(max_workers=len(requests)) as ex:
            served = list(ex.map(batcher.submit, requests))
        launches = [c.launches for c in counters]
    finally:
        batcher.close()
    return served, launches, batcher.device_calls


def check_served(requests, served, config):
    for req, det in zip(requests, served):
        n = req.shape[0]
        check(det["boxes"].shape == (n, config.top_k, 6), f"boxes shape {det['boxes'].shape}")
        check(det["labels"].shape == det["scores"].shape == (n, config.top_k), "labels/scores shape")
        check(det["count"].shape == (n,), "count shape")
        check(all(np.isfinite(det[k]).all() for k in ("boxes", "scores")), "non-finite output")
        check(((det["count"] >= 0) & (det["count"] <= config.top_k)).all(), "count out of range")
    counts = np.concatenate([d["count"] for d in served])
    check(counts.max() > 0, "no volume has a detection")
    return counts


# ---------------------------------------------------------------- training
def train_batch(b: int, gen, size=None) -> dict:
    """bench.py's training batch, made on the card: randn volumes (of
    ``size``, default the training geometry's) with the two boxes (label 1)
    painted in (+3), so the model has something to learn."""
    size = tuple(size or TRAIN["input_size"])
    images = torch.randn((b, *size, 1), generator=gen, device="cuda")
    for box in TRAIN_BOXES:
        v = [int(c * n) for c, n in zip(box, size * 2)]
        images[:, v[0]:v[3], v[1]:v[4], v[2]:v[5]] += 3.0
    boxes = torch.tensor(TRAIN_BOXES, dtype=torch.float32, device="cuda")
    return {"image": images, "boxes": boxes.expand(b, -1, -1).contiguous(),
            "labels": torch.ones((b, 2), dtype=torch.int32, device="cuda"),
            "box_mask": torch.ones((b, 2), dtype=torch.bool, device="cuda")}


@contextmanager
def tapped(model):
    """Keeps the detached (locs, scores) of every forward of ``model``."""
    outs = []
    handle = model.register_forward_hook(
        lambda module, args, out: outs.append(tuple(t.detach() for t in out)))
    try:
        yield outs
    finally:
        handle.remove()


def _detached(params: dict) -> dict:
    return {k: v.detach() if torch.is_tensor(v) else v for k, v in params.items()}


@contextmanager
def tapped_kernel_operands(model):
    """Keeps, for every forward of a ``use_pallas`` + ``use_pallas_tail``
    model, K2's operands at its first wanted layer and K3's input, folded
    layers and emitted maps, taken while the step's weights are in place."""
    base = model.base
    first = min(base.feature_layers)
    emit = tuple(sorted(i - base.tail_from for i in base.feature_layers if i >= base.tail_from))
    dw, tail = [], []

    def on_block(block, args):
        x = args[0].detach().contiguous(memory_format=torch.channels_last_3d)
        dw.append((x, *(t.detach() for t in block_dw_operands(block, x.dtype))))

    def on_base(backbone, args, features):
        layers = [_detached(block.folded_params()) for block in backbone.features[base.tail_from:]]
        x = features[first].detach().contiguous(memory_format=torch.channels_last_3d)
        tail.append((x, layers, emit))

    handles = [base.features[first].register_forward_pre_hook(on_block),
               base.register_forward_hook(on_base)]
    try:
        yield dw, tail
    finally:
        for handle in handles:
            handle.remove()


@contextmanager
def on_first_forward(cls, enter):
    """Enters ``enter(module)`` on each instance of ``cls`` at its first
    forward inside the block, so that hooks reach the models a CLI builds
    inside a call, and exits them all at its end. Yields the list of the
    values entered, in the order the instances first ran."""
    entered, seen = [], set()
    with ExitStack() as stack:
        def pre(module, args):
            if isinstance(module, cls) and id(module) not in seen:
                seen.add(id(module))
                entered.append(stack.enter_context(enter(module)))

        handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
        try:
            yield entered
        finally:
            handle.remove()


def check_plain_detections(name, det, locs, scores, priors, config) -> None:
    """A step's detections (K1) against the plain NMS on the same locs and scores."""
    kw = dict(n_classes=config.n_classes, top_k=config.top_k)
    boxes, cscores, valid = nms_candidates(locs, scores, priors, min_score=config.min_score, **kw)
    plain = select_detections(boxes, cscores, greedy_nms(boxes, valid, config.max_overlap), **kw)
    for key in plain:
        check(torch.equal(det[key], plain[key]), f"{name}: detections with K1 != plain NMS in {key}")
    log(f"{name}: detections with K1 == the plain NMS's on the same locs and scores (all four "
        f"outputs; {int(det['count'].sum())} detections over {det['count'].shape[0]} volumes, "
        f"{int(valid.sum())} candidates above min_score)")


def step_rounds(step, state, batch, gen, iters: int, rounds: int = 3):
    """CUDA-event ms per train step over ``iters`` back-to-back steps, per round."""
    ms = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state, _m = step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / iters)
    return ms, state


def drive_training(card, counters) -> dict:
    """Phase 4b: the training path at the bench's training geometry; returns
    what the kernels line and the profile at the end need."""
    t_phase = time.perf_counter()
    config = SSD3DConfig.create(**TRAIN)
    flagged_config = SSD3DConfig.create(**TRAIN, use_pallas=True, use_pallas_tail=True)
    model, flagged_model = SSD3D(config), SSD3D(flagged_config)
    priors = torch.from_numpy(model_priors(config)).cuda()
    state = create_train_state(config, seed=0, device="cuda")
    augment = AugmentConfig(**TRAIN_AUGMENT)
    step = make_train_step(config, model, priors, augment=augment)
    metric_step = make_train_step(config, model, priors, augment=augment, with_detections=True)
    eval_step = make_eval_step(config, model, priors)
    flagged_eval = make_eval_step(flagged_config, flagged_model, priors)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data_gen = torch.Generator(device="cuda").manual_seed(1)
    batches = {b: train_batch(b, data_gen) for b in (8, 64)}
    n_params = sum(p.numel() for p in state.params.values())
    log(f"training: 64^3 bf16 MobileNet SSD3D width 1.0, {n_params:,} float32 master "
        f"parameters, {priors.shape[0]} priors, lr {config.lr}, soft matching "
        f"{list(config.threshold)}, augmentation {TRAIN_AUGMENT}, TrainState from seed 0")

    for c in counters:
        c.launches = 0
    losses, peak = {}, {}
    for b, n in ((8, 20), (64, 10)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = []
        for _ in range(n):
            state, m = step(state, batches[b], gen)
            out.append(m["total_loss"])
        losses[b] = torch.stack(out).float().cpu()
        peak[b] = torch.cuda.max_memory_allocated()
        log(f"{n} train steps at batch {b} in {time.perf_counter() - t0:.2f} s (the first "
            f"includes warm-up); losses {[round(float(v), 4) for v in losses[b]]}; peak memory "
            f"allocated {peak[b] / 2**30:.3f} GiB [{card}]")
        check(bool(torch.isfinite(losses[b]).all()), f"a non-finite loss at batch {b}")
    first, last = float(losses[8][:5].mean()), float(losses[8][-5:].mean())
    log(f"batch 8, mean loss of steps 1-5 {first:.4f}, of steps 16-20 {last:.4f}")
    check(last < first, "the loss did not fall over 20 steps on the repeated batch")
    in_train = [c.launches for c in counters]
    check(in_train == [0, 0, 0], f"a plain train step launched a kernel: {in_train}")
    check(int(state.step) == int(state.opt_state.count) == 30, "the step count is not 30")

    # the eval step once more at min_score 0.05: after 31 steps no candidate
    # of the eval forward passes the bench's 0.5, and K1 should face some
    low_config = dataclasses.replace(config, min_score=0.05)
    with tapped(model) as outs:
        state, m = metric_step(state, batches[8], gen)
        k1_metric = greedy_nms_cuda.launches
        ev = eval_step(eval_view(state), batches[8])
        k1_eval = greedy_nms_cuda.launches - k1_metric
        ev_low = make_eval_step(low_config, model, priors)(eval_view(state), batches[8])
    check(k1_metric > 0 and k1_eval > 0, "the metric or eval step did not launch K1")
    check_plain_detections("with_detections train step", m["detections"], *outs[0], priors,
                           config)
    check_plain_detections("eval step", ev["detections"], *outs[1], priors, config)
    check_plain_detections("eval step at min_score 0.05", ev_low["detections"], *outs[2],
                           priors, low_config)
    check(int(ev_low["detections"]["count"].sum()) > 0, "the eval step found no detection")
    before = [c.launches for c in counters]
    with tapped(flagged_model) as fouts, tapped_kernel_operands(flagged_model) as (dw, tail):
        fev = flagged_eval(eval_view(state), batches[8])
        fev_low = make_eval_step(dataclasses.replace(flagged_config, min_score=0.05),
                                 flagged_model, priors)(eval_view(state), batches[8])
    flagged = [c.launches - n for c, n in zip(counters, before)]
    launches = [c.launches for c in counters]
    log(f"training path launches: K1 {k1_metric} in the with_detections train step and "
        f"{k1_eval} in the eval step (and 1 at min_score 0.05); two eval steps (min_score "
        f"{config.min_score} and 0.05) with use_pallas + use_pallas_tail: K1 {flagged[0]}, "
        f"K2 {flagged[1]}, K3 {flagged[2]}; in all {launches}")
    check(min(flagged) > 0, "the flagged eval step did not launch every kernel (K1, K2, K3)")
    # K2 and K3 against their plain versions on the operands the flagged eval
    # step gave them (layer 3 at 8^3 and the tail from it); not counted above
    dw_x, *dw_ops = dw[0]
    dw_check = compare_dw("flagged eval step, layer 3", dw_x, *dw_ops)
    tail_check = compare_tail("flagged eval step, layers 4-7", *tail[0])
    check_plain_detections("flagged eval step", fev["detections"], *fouts[0], priors,
                           flagged_config)
    check_plain_detections("flagged eval step at min_score 0.05", fev_low["detections"],
                           *fouts[1], priors, dataclasses.replace(flagged_config, min_score=0.05))
    check(int(fev_low["detections"]["count"].sum()) > 0, "the flagged eval step found no detection")
    for key in ("total_loss", "conf_loss", "loc_loss"):
        a, b = float(fev[key]), float(ev[key])
        log(f"eval step {key}: {b:.5f} on the default path, {a:.5f} with both flags")
        check(np.isfinite(a) and abs(a - b) <= PATHS_MAX_REL_ERR * abs(b),
              f"the flagged eval step's {key} disagrees with the default path's")
    det_lists = detections_to_lists(ev_low["detections"])
    gt = [batches[8]["boxes"][i].cpu().numpy() for i in range(8)]
    detail = calculate_mAP(*det_lists, gt, [np.ones(2, np.int64)] * 8,
                           [np.zeros(2, bool)] * 8, n_classes=2, min_overlap=0.5,
                           return_detail=True)
    log(f"eval step (min_score 0.05) mAP@0.5 on the training batch after 31 steps: "
        f"{detail['mAP']:.4f} (recall {detail['recall']:.4f}, precision "
        f"{detail['precision']:.4f}); a check that the metric runs on the step's detections, "
        "not a quality claim")

    timings = {}
    for b, iters in ((8, 10), (64, 3)):
        ms, state = step_rounds(step, state, batches[b], gen, iters)
        med = float(np.median(ms))
        timings[b] = med
        log(f"train step batch {b}: median {med:.3f} ms per step ({b / med * 1e3:.1f} volumes/s), "
            f"rounds {[round(v, 3) for v in ms]} ms, {iters} steps a round (CUDA events) [{card}]")
    view = eval_view(state)
    eval_ms = [cuda_ms(lambda: eval_step(view, batches[8]), iters=10) for _ in range(3)]
    log(f"eval step batch 8: median {float(np.median(eval_ms)):.3f} ms, rounds "
        f"{[round(v, 3) for v in eval_ms]} (CUDA events) [{card}]")
    log(f"training phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "k1_metric": k1_metric, "k1_eval": k1_eval,
            "flagged": flagged, "dw_check": dw_check, "tail_check": tail_check, "step": step, "state": state, "batches": batches, "gen": gen,
            "step_ms": timings, "eval_ms": float(np.median(eval_ms)), "peak": peak}


def drive_training_entry(card, counters, tmp: Path) -> dict:
    """Phase 4c: the training entry point. Generate the JAX package's 4k
    headline dataset (cut to 40 images), train through ``cli.train`` on the
    card with the recipe's flags (cut to 24 steps, full width), check what
    it wrote, hold one validation batch's detections against the plain NMS,
    time the bare step at the same configuration, and resume one epoch."""
    t_phase = time.perf_counter()
    root, logs = tmp / "data", tmp / "logs"
    t0 = time.perf_counter()
    generate_dataset(root, num_processes=1, **RECIPE_DATA)
    gen_s = time.perf_counter() - t0
    log(f"generated {RECIPE_DATA['num_images']} volumes of "
        f"{RECIPE_DATA['image_size']} in {gen_s:.3f} s (one process) [{card}]")
    args = ["-d", str(root), *recipe.TRAIN_FLAGS, "-mi", str(RECIPE_STEPS), "-ld", str(logs),
            "--device", "cuda"]
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_cli.main([*args, "-en", "recipe"])
    fit_s = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    hist, timings = result["history"], result["timings"]
    epochs = timings["epochs"]
    losses = [v for e in epochs for v in e["train_losses"]]
    log(f"cli.train: {len(hist)} epochs, {len(losses)} steps in {fit_s:.3f} s (set-up, "
        f"materialize {timings['materialize_s']:.3f} s, and checkpoints included); "
        f"training losses {[round(v, 4) for v in losses]}; avg_val_loss "
        f"{[round(h['avg_val_loss'], 4) for h in hist]}; mAP@0.1 on validation "
        f"{[round(h['mAP/validation_IoU_0.1'], 4) for h in hist]}; peak memory allocated "
        f"{peak / 2**30:.3f} GiB [{card}]")
    check(len(hist) == RECIPE_STEPS // 4 and len(losses) == RECIPE_STEPS,
          f"cli.train ran {len(hist)} epochs and {len(losses)} steps")
    check(all(np.isfinite(losses)) and all(np.isfinite(h["avg_val_loss"]) for h in hist),
          "a non-finite loss in cli.train")
    check(all("mAP/validation_IoU_0.1" in h and "mAP/validation_IoU_0.5" in h for h in hist),
          "an epoch without validation mAP")
    ckpt_dir = Path(result["checkpoint_dir"])
    names = sorted(p.name for p in ckpt_dir.iterdir())
    check(names[-1] == "last" and sum(n.startswith("checkpoint-") for n in names) == 3,
          f"checkpoints {names}")
    # K1: one launch a validation batch (8 volumes: one batch) and one a
    # train step in the train-metric epochs (0, 2, 4); K2, K3 stay off
    expected = len(hist) + sum(e["steps"] for e in epochs if e["epoch"] % 2 == 0)
    log(f"cli.train launches: K1 {launches[0]} (expected {expected}: {len(hist)} validation "
        f"batches and the train-metric epochs' steps), K2 {launches[1]}, K3 {launches[2]}; "
        f"checkpoints {names}")
    check(launches[0] == expected, "K1 did not launch once per validation batch and "
          "train-metric step")
    check(launches[1] == launches[2] == 0, "K2 or K3 launched in training")
    per_step = [e["train_s"] / e["steps"] * 1e3 for e in epochs]
    val_s = [e["val_s"] for e in epochs]
    log(f"trainer wall ms per step by epoch {[round(v, 3) for v in per_step]} (epochs 0, "
        f"2, 4 take the instrumented step with detections), validation s by epoch "
        f"{[round(v, 3) for v in val_s]} [{card}]")

    # one validation batch from the last checkpoint: its detections (K1)
    # against the plain NMS on the same locs and scores
    config = SSD3DConfig.from_json_dict(
        json.loads((ckpt_dir / "last" / "meta.json").read_text())["config"])
    model = SSD3D(config)
    priors = torch.from_numpy(model_priors(config)).cuda()
    template = create_train_state(config, seed=0, device="cuda")
    _, state, _ = load_checkpoint(ckpt_dir / "last", state_template=template)
    dm = SyntheticDataModule(root, n_classes=1, batch_size=8, max_objects=16)
    dm.setup("fit")
    host_val, host_train = dm.materialize(dm.testsubs), dm.materialize(dm.trainsubs)
    val = {k: torch.from_numpy(v).cuda() for k, v in host_val.items()
           if isinstance(v, np.ndarray)}
    for min_score in (config.min_score, 0.05):
        low = dataclasses.replace(config, min_score=min_score)
        with tapped(model) as outs:
            ev = make_gathered_eval_step(low, model, priors, hard_negative_mining=True)(
                eval_view(state), val, np.arange(8), np.ones(8, bool))
        check_plain_detections(f"trainer's validation batch at min_score {min_score}",
                               ev["detections"], *outs[0], priors, low)

    # the bare gathered step at the recipe's configuration: the loop's
    # host cost is the trainer's ms per step less this
    data = {k: torch.from_numpy(v).cuda() for k, v in host_train.items()
            if isinstance(v, np.ndarray)}
    step = make_gathered_train_step(config, model, priors,
                                    AugmentConfig.from_names(["flip", "rotate90", "zoom"]),
                                    hard_negative_mining=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.arange(8, device="cuda")
    bare = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            state, _m = step(state, data, idx, gen)
        end.record()
        torch.cuda.synchronize()
        bare.append(start.elapsed_time(end) / 10)
    log(f"bare gathered train step at the recipe's configuration (float32 64^3 width 1.0, "
        f"batch 8, augmentation, hard negative mining): median {float(np.median(bare)):.3f} "
        f"ms, rounds {[round(v, 3) for v in bare]} (CUDA events) [{card}]")

    # resume from `last` for one more epoch
    for c in counters:
        c.launches = 0
    resumed = train_cli.main([*args, "-en", "recipe", "-cp", str(ckpt_dir / "last"),
                              "-me", str(len(hist) + 1)])
    r_hist = resumed["history"]
    r_losses = resumed["timings"]["epochs"][0]["train_losses"]
    log(f"resumed from last: epochs {[h['epoch'] for h in r_hist]}, losses "
        f"{[round(v, 4) for v in r_losses]}, avg_val_loss {r_hist[0]['avg_val_loss']:.4f}, "
        f"K1 launches {greedy_nms_cuda.launches}")
    check([h["epoch"] for h in r_hist] == [len(hist)] and len(r_losses) == 4
          and all(np.isfinite(r_losses)), "the resumed run did not train one more epoch")
    check(greedy_nms_cuda.launches == 5, "the resumed metric epoch did not launch K1 5 times")
    log(f"training entry phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "gen_s": gen_s, "materialize_s": timings["materialize_s"],
            "fit_s": fit_s, "per_step_ms": per_step, "val_s": val_s, "peak": peak,
            "bare_step_ms": float(np.median(bare)), "bare_rounds": bare, "root": root,
            "last": ckpt_dir / "last"}


def read_predictions(run_dir: Path, subject) -> tuple:
    """One subject's saved detections in id order: (boxes (n, 6), labels, scores)."""
    infos = json.loads((run_dir / f"sub-{subject}_preds.json").read_text())
    rows = [infos[k] for k in sorted(infos, key=int)]
    return (np.asarray([r[0] for r in rows], np.float32).reshape(-1, 6),
            np.asarray([r[2] for r in rows], np.int64), np.asarray([r[3] for r in rows],
                                                                   np.float32))


def drive_scoring(card, counters, tmp: Path, root: Path, last: Path) -> dict:
    """Phase 4d: score phase 4c's ``last`` checkpoint through the user's
    entry points on the card: ``cli.predict`` on the default path and with
    ``use_pallas`` + ``use_pallas_tail``, ``cli.eval`` over the recipe's
    grid, the reference-checkpoint import and a predict on it, then
    ``cli.tune_lr`` and ``cli.model_insight priors``."""
    t_phase = time.perf_counter()
    config = SSD3DConfig.from_json_dict(json.loads((last / "meta.json").read_text())["config"])
    priors = torch.from_numpy(model_priors(config)).cuda()
    dm = SyntheticDataModule(root, n_classes=1, batch_size=1)
    dm.setup("predict")
    subjects = list(dm.testsubs)
    check(len(subjects) == 8, f"{len(subjects)} validation subjects, not 8")
    x1 = torch.from_numpy(next(dm.predict_batches("validation"))["image"]).cuda()

    def run_predict(name, ckpt, out, kernel_operands=False):
        """cli.predict.main on the card, counted and tapped; checks its files
        and that every subject's detections equal the plain NMS's on the
        locs and scores its forward gave."""
        enters = [tapped] + ([tapped_kernel_operands] if kernel_operands else [])
        with ExitStack() as stack:
            taps = [stack.enter_context(on_first_forward(SSD3D, e)) for e in enters]
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            rc = predict_cli.main(["-d", str(root), "-m", str(ckpt), "-o", str(out),
                                   *recipe.PREDICT_FLAGS, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = [c.launches for c in counters]
        check(rc == 0 and len(taps[0]) == 1, f"predict [{name}] failed or built several models")
        outs = taps[0][0]
        run_dir = out / "validation_set" / "min_score_0.0"
        names = {p.name for p in run_dir.iterdir()}
        want = {f"sub-{s}_preds.{e}" for s in subjects for e in ("json", "csv", "nii.gz")}
        want |= {f"aa_metrics_per_subject_(min_IoU={iou}).json" for iou in (0.5, 0.1)}
        check(want <= names, f"predict [{name}] lacks {sorted(want - names)[:4]}")
        check(len(outs) == len(subjects) and launches[0] == len(subjects),
              f"predict [{name}]: {len(outs)} forwards and K1 launched {launches[0]} times for "
              f"{len(subjects)} batches of one volume")
        kw = dict(n_classes=config.n_classes, top_k=100)
        n_det = 0
        for subj, (locs, scores) in zip(subjects, outs):
            boxes, cscores, valid = nms_candidates(locs, scores, priors, min_score=0.0, **kw)
            plain = select_detections(boxes, cscores,
                                      greedy_nms(boxes, valid, config.max_overlap), **kw)
            db, dl, ds = (a[0] for a in detections_to_lists(plain))
            keep = dl != 0
            saved = read_predictions(run_dir, subj)
            for a, b in zip(saved, (db[keep], dl[keep], ds[keep])):
                check(a.shape == b.shape and np.array_equal(a, b),
                      f"predict [{name}] subject {subj}: saved detections != plain NMS")
            n_det += len(saved[0])
        log(f"cli.predict [{name}]: {len(subjects)} volumes in {wall:.3f} s "
            f"({wall / len(subjects):.4f} s a volume, host clock: the CLI's set-up, NIfTI "
            f"decode, checkpoint load and file writes included); launches K1 {launches[0]}, "
            f"K2 {launches[1]}, K3 {launches[2]}; every subject's {n_det} saved detections "
            f"== the plain NMS's on the same locs and scores [{card}]")
        return {"wall_s": wall, "s_per_volume": wall / len(subjects), "launches": launches,
                "outs": outs, "run_dir": run_dir, "taps": taps, "detections": n_det}

    def step_ms(ckpt):
        cfg, state = predict_cli.load_predict_state(ckpt, "cuda")
        step = make_predict_step(cfg, SSD3D(cfg), model_priors(cfg), min_score=0.0, top_k=100)
        return [cuda_ms(lambda: step(state, x1), iters=10) for _ in range(3)]

    # the default path
    default = run_predict("default path", last, tmp / "preds")
    check(default["launches"][1:] == [0, 0], "K2 or K3 launched on the default path")
    default["step_ms"] = step_ms(last)

    # use_pallas + use_pallas_tail: a copy of the checkpoint with the flags set
    flagged_ckpt = tmp / "last_flagged"
    shutil.copytree(last, flagged_ckpt)
    meta = json.loads((flagged_ckpt / "meta.json").read_text())
    meta["config"].update(use_pallas=True, use_pallas_tail=True)
    (flagged_ckpt / "meta.json").write_text(json.dumps(meta, indent=2))
    flagged = run_predict("use_pallas + use_pallas_tail", flagged_ckpt, tmp / "preds_flagged",
                          kernel_operands=True)
    flagged["step_ms"] = step_ms(flagged_ckpt)
    dw, tail = flagged["taps"][1][0]
    base = SSD3D(dataclasses.replace(config, use_pallas=True, use_pallas_tail=True)).base
    k2_blocks = sum(1 for blk in base.features[:base.tail_from] if getattr(blk, "use_pallas", False)
                    and blk.strides == (1, 1, 1) and blk.conv1.in_channels % 128 == 0)
    tail_x, tail_layers, tail_emit = tail[0]
    specs = [(*layer["pw_w"].shape, int(layer["stride"])) for layer in tail_layers]
    k3_plan = plan_tail(torch.float32, tuple(tail_x.shape), specs)
    k2_plan = plan_depthwise(torch.float32, tuple(dw[0][0].shape))
    expected = [len(subjects), len(subjects) * k2_blocks, len(subjects) * k3_plan.launches]
    log(f"predict [use_pallas + use_pallas_tail] at {config.input_size} {config.dtype}: K2 takes {k2_blocks} block(s) "
        f"a forward ({describe(k2_plan)}), K3 {k3_plan.launches} launch(es) a forward "
        f"({k3_plan.variant}); expected launches {expected}, counted {flagged['launches']}")
    check(flagged["launches"] == expected and k2_blocks > 0,
          "the flagged predict did not launch K1, K2 and K3 as planned")
    dw_check = compare_dw("predict, flagged, layer 3", *dw[0])
    tail_check = compare_tail("predict, flagged, layers 4-7", tail_x, tail_layers, tail_emit)
    rel = {"locs": 0.0, "scores": 0.0}
    for (fl, fs), (dl_, ds_) in zip(flagged["outs"], default["outs"]):
        for key, a, b in (("locs", fl, dl_), ("scores", fs, ds_)):
            rel[key] = max(rel[key], float((a - b).norm() / b.norm()))
    same, det_rel = 0, 0.0
    for subj in subjects:
        fs, ds_ = (read_predictions(r["run_dir"], subj)[2] for r in (flagged, default))
        same += (flagged["run_dir"] / f"sub-{subj}_preds.json").read_bytes() == (
            default["run_dir"] / f"sub-{subj}_preds.json").read_bytes()
        check(len(fs) == len(ds_), f"subject {subj}: {len(fs)} flagged detections, "
              f"{len(ds_)} on the default path")
        a, b = np.sort(fs)[::-1], np.sort(ds_)[::-1]
        det_rel = max(det_rel, float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)))
    log(f"flagged vs default path: locs/scores relative error {rel['locs']:.3e} / "
        f"{rel['scores']:.3e}, the saved detections' scores (sorted, per subject) "
        f"{det_rel:.3e}, largest over the volumes (tolerance {PATHS_MAX_REL_ERR}); equal "
        f"detection counts; {same} of {len(subjects)} subjects' files byte-equal")
    check(max(*rel.values(), det_rel) <= PATHS_MAX_REL_ERR,
          "the flagged predict's locs, scores or detections disagree with the default path's")
    for name, r in (("default", default), ("flagged", flagged)):
        log(f"predict step [{name}] batch 1, {config.input_size} {config.dtype} width "
            f"{config.width_mult}, min_score 0.0, top_k 100: "
            f"median {float(np.median(r['step_ms'])):.3f} ms, rounds "
            f"{[round(v, 3) for v in r['step_ms']]} (CUDA events) [{card}]")

    # eval over the recipe's grid, on the default path's run
    t0 = time.perf_counter()
    recipe.evaluate_grid(root, tmp / "preds")
    eval_s = time.perf_counter() - t0
    metric_files = sorted(default["run_dir"].glob("metrics_(*.json"))
    check(len(metric_files) == len(recipe.EVAL_GRID),
          f"eval wrote {len(metric_files)} metric files")
    for path in metric_files:
        data = json.loads(path.read_text())
        check({"mAP", "precision", "recall", "f1_score"} <= set(data), f"{path.name} lacks keys")
    points = plots.operating_points(default["run_dir"])
    log(f"cli.eval: {len(metric_files)} metric files in {eval_s:.3f} s (host); operating-point "
        f"maxima after {RECIPE_STEPS + 4} steps (a check that scoring runs, not a quality "
        f"claim): {json.dumps(points)}")

    # the reference-checkpoint import: `last` as a Lightning-style .ckpt
    template = create_train_state(config, seed=0, device="cuda")
    _, state, _ = load_checkpoint(last, state_template=template)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in state.state_dict().items()},
                "epoch": 0}, tmp / "last.ckpt")
    import_cli.main(["-m", str(tmp / "last.ckpt"), "-o", str(tmp / "imported"),
                     "--n_classes", str(config.n_classes),
                     "--input_size", *map(str, config.input_size),
                     "-pl", " ".join(map(str, config.feature_layers)),
                     "-bpl", str(config.boxes_per_location), "-wm", str(config.width_mult),
                     "--device", "cuda"])
    imported = run_predict("imported checkpoint", tmp / "imported", tmp / "preds_imported")
    for s in subjects:
        for ext in ("json", "csv"):
            name = f"sub-{s}_preds.{ext}"
            check((imported["run_dir"] / name).read_bytes()
                  == (default["run_dir"] / name).read_bytes(),
                  f"the imported checkpoint's {name} differs from the original's")
    log("imported checkpoint: every subject's saved detections equal the original run's")

    # the tools
    t0 = time.perf_counter()
    suggestion = tune_lr_cli.main(["-d", str(root), "-b", "8", "-n", str(TUNE_LR_STEPS),
                                   "-o", str(tmp / "lr.json"), "--device", "cuda"])
    tune_s = time.perf_counter() - t0
    history = json.loads((tmp / "lr.json").read_text())["history"]
    log(f"cli.tune_lr: {len(history)} steps in {tune_s:.3f} s, suggestion {suggestion:.3e}, "
        f"losses {[round(h['loss'], 4) for h in history]} [{card}]")
    check(np.isfinite(suggestion) and suggestion > 0 and len(history) >= 3,
          "tune_lr gave no finite suggestion")
    paths = insight_cli.main(["priors", "-cp", str(last), "-o", str(tmp / "insight")])
    check(len(paths) == len(config.feature_layers)
          and all(load_nifti(p).data.max() > 0 for p in paths),
          "model_insight priors wrote no wireframes")
    log(f"cli.model_insight priors: {[p.name for p in paths]}")
    log(f"scoring phase {time.perf_counter() - t_phase:.1f} s")
    return {"default": default, "flagged": flagged, "imported": imported, "eval_s": eval_s,
            "points": points, "dw_check": dw_check, "tail_check": tail_check,
            "paths_rel_err": rel, "tune_lr_s": tune_s, "suggestion": suggestion}


# ---------------------------------------------------------------- full resolution
@contextmanager
def recorded_nms():
    """Records every K1 launch made through ``ops.nms`` (the per-patch
    ``detect_objects``) and ``sliding_window`` (the stitch): its candidates
    and keep mask, to be held against the plain NMS afterwards. The
    launches are the path's own; the comparison launches nothing."""
    calls = []

    def record(boxes, valid, max_overlap, plan=None):
        keep = greedy_nms_cuda(boxes, valid, max_overlap, plan)
        calls.append((boxes, valid, max_overlap, keep))
        return keep

    saved = nms_ops.greedy_nms_cuda, sliding_window.greedy_nms_cuda
    nms_ops.greedy_nms_cuda = sliding_window.greedy_nms_cuda = record
    try:
        yield calls
    finally:
        nms_ops.greedy_nms_cuda, sliding_window.greedy_nms_cuda = saved


def check_recorded(name, calls) -> int:
    """Every recorded K1 launch against the plain NMS on its candidates;
    returns the mismatches (0, or the check fails)."""
    torch.cuda.synchronize()
    mismatches, shapes = 0, []
    for boxes, valid, max_overlap, keep in calls:
        mismatches += int((keep != greedy_nms(boxes, valid, max_overlap)).sum())
        shapes.append(f"N={boxes.shape[0]} K={boxes.shape[1]} valid {int(valid.sum())} "
                      f"kept {int(keep.sum())}")
    log(f"{name}: {len(calls)} K1 launches ({'; '.join(shapes)}), each == the plain NMS on "
        f"its candidates: mismatches {mismatches}")
    check(mismatches == 0, f"{name}: K1 disagrees with the plain NMS")
    return mismatches


def peak_breakdown(call, top: int = 4):
    """Runs ``call()`` with the allocator's history on; returns the bytes
    allocated during it that were live at its peak, grouped by the port's
    innermost frame that allocated them, largest first."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=200000, context="alloc",
                                             stacks="python")
    try:
        result = call()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, total, best, at_best = {}, 0, 0, {}
    for event in trace:
        if event["action"] == "alloc":
            live[event["addr"]] = event
            total += event["size"]
            if total > best:
                best, at_best = total, dict(live)
        elif event["action"] == "free_completed" and event["addr"] in live:
            total -= live.pop(event["addr"])["size"]
    groups = {}
    for event in at_best.values():
        frames = [f for f in event.get("frames", []) if "mslesions3d_tpu_torch" in f["filename"]]
        key = (f"{Path(frames[0]['filename']).name}:{frames[0]['line']}:{frames[0]['name']}"
               if frames else "other")
        groups[key] = groups.get(key, 0) + event["size"]
    return result, best, sorted(groups.items(), key=lambda kv: -kv[1])[:top]


def held_for_backward(cfg, state, batch) -> int:
    """Bytes that the train forward and loss of ``cfg`` leave allocated for
    the backward: the activations autograd keeps (remat's saving)."""
    model = SSD3D(cfg).train()
    leaves = {n: p.detach().requires_grad_() for n, p in state.params.items()}
    stats = {n: s.clone() for n, s in state.batch_stats.items()}
    priors = torch.from_numpy(model_priors(cfg)).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    locs, scores = functional_call(model, (_cast(model, leaves), stats), (batch["image"],))
    losses = multibox_loss_from_config(cfg, locs, scores, batch["boxes"], batch["labels"],
                                       batch["box_mask"], priors)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del locs, scores, losses
    return held


def drive_full_resolution(card, counters, cal_state, tmp: Path) -> dict:
    """Phase 4e: full-resolution volumes. The sliding window at BASELINE
    config #3, patch training from disk with full-volume validation and a
    sliding-window predict, remat, the ConvNet, and device boxes."""
    t_phase = time.perf_counter()
    out = {"mismatches": 0, "k1": {}, "k2": {}, "k3": {}, "timing": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    volumes = torch.randn((4, *FULL_VOLUME, 1), generator=gen, device="cuda")

    # 1. the sliding window at config #3: headline model, BN calibrated
    for name in ("off", "both"):
        config = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
        state = create_train_state(config, device="cuda", state_dict=cal_state)
        for v in (1, 4):
            key = f"{name} V={v}"
            run = sliding_window.make_sliding_window_detector(config, FULL_VOLUME,
                                                              volume_batch=v)
            x = volumes[0] if v == 1 else volumes
            run(state, x)  # warm-up: cuDNN's algorithm choice
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ExitStack() as stack:
                calls = stack.enter_context(recorded_nms())
                taps = (stack.enter_context(on_first_forward(SSD3D, tapped_kernel_operands))
                        if name == "both" else None)
                for c in counters:
                    c.launches = 0
                det = run(state, x)
                torch.cuda.synchronize()
                launches = [c.launches for c in counters]
            peak = torch.cuda.max_memory_allocated()
            chunks = -(-run.n_patches * v // run.patch_batch)
            check(launches[0] == chunks + 1 == len(calls),
                  f"sliding window [{key}]: K1 launched {launches[0]} times for {chunks} "
                  f"chunks and the stitch")
            out["mismatches"] += check_recorded(f"sliding window [{key}]", calls)
            stitch = calls[-1]
            out["k1"][key] = launches[0]
            if v == 1 and name == "off":
                out["stitch_case"] = stitch[:2]
                out["patch_case"] = calls[0][:2]
            if v == 4 and name == "off":
                out["stitch_case_v4"] = stitch[:2]
            if name == "both":
                dw, tail = taps[0]
                tail_x, tail_layers, tail_emit = tail[0]
                specs = [(*layer["pw_w"].shape, int(layer["stride"])) for layer in tail_layers]
                k3_plan = plan_tail(tail_x.dtype, tuple(tail_x.shape), specs)
                check(launches[1] == chunks and launches[2] == chunks * k3_plan.launches,
                      f"sliding window [{key}]: K2 {launches[1]}, K3 {launches[2]} launches for "
                      f"{chunks} chunks ({k3_plan.launches} K3 launch(es) a forward)")
                out["dw_check"] = merge_dw_checks(out.get("dw_check"), compare_dw(
                    f"sliding window [{key}], layer 3", *dw[0]))
                out["tail_check"] = merge_tail_checks(out.get("tail_check"), compare_tail_exact(
                    f"sliding window [{key}], layers 4-7", tail_x, tail_layers, tail_emit))
                out["k2"][key], out["k3"][key] = launches[1], launches[2]
            count = det["count"].cpu()
            check(det["boxes"].shape == (v, config.top_k, 6) and bool((count > 0).all())
                  and bool(torch.isfinite(det["boxes"]).all())
                  and bool(((det["boxes"] >= 0) & (det["boxes"] <= 1)).all()),
                  f"sliding window [{key}]: malformed detections")
            device_ms = cuda_ms(lambda: run(state, x), iters=5)
            iters = 10 if v == 1 else 4
            t0 = time.perf_counter()
            for _ in range(iters):
                det = run(state, x)
            det["count"].cpu()
            wall = time.perf_counter() - t0
            out["timing"][key] = {"volumes_per_s": v * iters / wall, "device_ms": device_ms,
                                  "peak_bytes": peak, "launches": launches}
            log(f"sliding window [{key}] {FULL_VOLUME} in {run.n_patches} patches of 96^3 "
                f"(batches of {run.patch_batch}, {chunks} chunk(s)): launches K1 {launches[0]}, "
                f"K2 {launches[1]}, K3 {launches[2]}; detections {count.tolist()}; "
                f"{v * iters / wall:.2f} volumes/s (host clock, volumes on the card), "
                f"{device_ms:.3f} ms a call (CUDA events), peak memory "
                f"{peak / 2**30:.3f} GiB [{card}]")
        del state
    # top_k 395: the stitch's K = min(3950, 27 x 197) = 3950, the wide walk
    config = SSD3DConfig.create(**dict(HEADLINE, top_k=395))
    state = create_train_state(config, device="cuda", state_dict=cal_state)
    run = sliding_window.make_sliding_window_detector(config, FULL_VOLUME)
    with recorded_nms() as calls:
        greedy_nms_cuda.launches = 0
        det = run(state, volumes[0])
        out["k1"]["top_k 395"] = greedy_nms_cuda.launches
    check(calls[-1][0].shape[1] == 3950 and plan_nms(3950).walk == "wide",
          f"the top_k 395 stitch has K = {calls[-1][0].shape[1]}")
    out["mismatches"] += check_recorded("sliding window [top_k 395]", calls)
    out["stitch_case_wide"] = calls[-1][:2]
    log(f"sliding window [top_k 395]: the stitch's K = 3950 ({describe_nms(plan_nms(3950))}); "
        f"{int(det['count'][0])} detections")
    del state, volumes
    torch.cuda.empty_cache()

    # 2. patch training from disk, full-volume validation, then predict -sw 1
    root, logs = tmp / "patch_data", tmp / "patch_logs"
    t0 = time.perf_counter()
    generate_dataset(root, num_processes=1, **PATCH_DATA)
    gen_s = time.perf_counter() - t0
    with recorded_nms() as calls:
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        result = train_cli.main(["-d", str(root), *recipe.TRAIN_FLAGS, "-mi", str(PATCH_STEPS),
                                 "--patch_size", "64", "64", "64", "-ld", str(logs),
                                 "-en", "patch", "--device", "cuda"])
        fit_s = time.perf_counter() - t0
        launches = [c.launches for c in counters]
    hist = result["history"]
    losses = [v for e in result["timings"]["epochs"] for v in e["train_losses"]]
    check(len(losses) == PATCH_STEPS and all(np.isfinite(losses)),
          f"patch training ran {len(losses)} steps or a loss is not finite")
    check(all("mAP/validation_full_IoU_0.1" in h for h in hist),
          "an epoch without the full-volume validation mAP")
    stitches = [c for c in calls if c[0].shape[0] != 8 or c[0].shape[1] != 1000]
    out["mismatches"] += check_recorded("cli.train --patch_size 64 (every K1 launch)", calls)
    out["k1"]["patch training"] = launches[0]
    check(launches[1] == launches[2] == 0, "K2 or K3 launched in training")
    log(f"cli.train --patch_size 64 64 64 on {PATCH_DATA['num_images']} volumes of "
        f"{PATCH_DATA['image_size']} (generated in {gen_s:.3f} s): {len(hist)} epochs, "
        f"{len(losses)} steps in {fit_s:.3f} s; losses {[round(v, 4) for v in losses]}; "
        f"full-volume validation mAP@0.1 {[round(h['mAP/validation_full_IoU_0.1'], 4) for h in hist]}, "
        f"crop mAP@0.1 {[round(h['mAP/validation_IoU_0.1'], 4) for h in hist]}; K1 launches "
        f"{launches[0]} ({len(stitches)} of them outside the crops' eval and train-metric "
        f"steps: the sliding window's chunks and stitches) [{card}]")
    last = Path(result["checkpoint_dir"]) / "last"
    with recorded_nms() as calls:
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = predict_cli.main(["-d", str(root), "-m", str(last), "-o", str(tmp / "patch_preds"),
                               *recipe.PREDICT_FLAGS, "-sw", "1", "--device", "cuda"])
        predict_s = time.perf_counter() - t0
        launches = [c.launches for c in counters]
    run_dir = tmp / "patch_preds" / "validation_set" / "min_score_0.0"
    n_subjects = len(list(run_dir.glob("sub-*_preds.json")))
    check(rc == 0 and n_subjects > 0 and launches[0] == 2 * n_subjects,
          f"predict -sw 1: {n_subjects} subjects, K1 launched {launches[0]} times")
    out["mismatches"] += check_recorded("cli.predict -sw 1 (every K1 launch)", calls)
    out["k1"]["predict -sw 1"] = launches[0]
    n_det = sum(len(json.loads(p.read_text())) for p in run_dir.glob("sub-*_preds.json"))
    log(f"cli.predict -sw 1 on {n_subjects} validation volumes of {PATCH_DATA['image_size']} "
        f"with the 64^3 patch model: {predict_s:.3f} s ({predict_s / n_subjects:.4f} s a "
        f"volume, host clock, set-up included), K1 {launches[0]} launches (a chunk and a "
        f"stitch a volume), every one == the plain NMS, so the {n_det} saved detections are "
        f"the plain NMS's [{card}]")
    out["timing"]["patch"] = {"generate_s": gen_s, "cli_train_s": fit_s,
                              "predict_s_per_volume": predict_s / n_subjects}

    # 3. remat: the 64^3 bf16 train step at batch 64, with and without
    config = SSD3DConfig.create(**TRAIN)
    batch = train_batch(64, torch.Generator(device="cuda").manual_seed(1))
    augment = AugmentConfig(**TRAIN_AUGMENT)
    remat, moved = {}, {}
    for on in (False, True):
        cfg = dataclasses.replace(config, remat=on)
        step = make_train_step(cfg, SSD3D(cfg), model_priors(cfg), augment=augment)
        state = create_train_state(cfg, seed=0, device="cuda")
        held = held_for_backward(cfg, state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (first, m), _, groups = peak_breakdown(
            lambda: step(state, batch, torch.Generator(device="cuda").manual_seed(2)))
        peak = torch.cuda.max_memory_allocated() - base
        log(f"remat={on}: live at the step's peak, by the port's line that allocated it: "
            + "; ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in groups))
        moved[on] = {n: s.clone() for n, s in first.batch_stats.items()}
        second, m2 = step(first, batch, torch.Generator(device="cuda").manual_seed(4))
        ms, _ = step_rounds(step, second, batch, torch.Generator(device="cuda").manual_seed(3),
                            iters=3)
        remat[on] = {"loss": float(m["total_loss"]), "grad_norm": float(m["grad_norm"]),
                     "second_loss": float(m2["total_loss"]), "peak_bytes": peak,
                     "held_bytes": held, "step_ms": float(np.median(ms)), "rounds": ms}
        del step, state, first, second
        torch.cuda.empty_cache()
    rel = {k: abs(remat[True][k] - remat[False][k]) / abs(remat[False][k])
           for k in ("loss", "grad_norm", "second_loss")}
    stats_rel = max(float((moved[True][n] - s).abs().max() / s.abs().max())
                    for n, s in moved[False].items() if n.endswith("running_mean"))
    log(f"remat, 64^3 bf16 train step at batch 64, without / with: memory the forward leaves "
        f"for the backward {remat[False]['held_bytes'] / 2**30:.3f} / "
        f"{remat[True]['held_bytes'] / 2**30:.3f} GiB; the step's peak above the state "
        f"{remat[False]['peak_bytes'] / 2**30:.3f} / {remat[True]['peak_bytes'] / 2**30:.3f} "
        f"GiB; median {remat[False]['step_ms']:.3f} / {remat[True]['step_ms']:.3f} ms a step "
        f"(CUDA events, rounds {[round(v, 3) for v in remat[False]['rounds']]} / "
        f"{[round(v, 3) for v in remat[True]['rounds']]}); first-step loss "
        f"{remat[False]['loss']:.6f} / {remat[True]['loss']:.6f}, gradient norm "
        f"{remat[False]['grad_norm']:.6f} / {remat[True]['grad_norm']:.6f}, second-step loss "
        f"{remat[False]['second_loss']:.6f} / {remat[True]['second_loss']:.6f} (relative "
        f"differences {', '.join(f'{v:.2e}' for v in rel.values())}, bound {REMAT_RTOL}); "
        f"BN running means after the first step: largest relative difference "
        f"{stats_rel:.2e} (bound {REMAT_STATS_RTOL}) [{card}]")
    check(remat[True]["peak_bytes"] < remat[False]["peak_bytes"], "remat did not lower the peak")
    check(max(rel.values()) <= REMAT_RTOL, "remat's losses or gradient norm disagree")
    check(stats_rel <= REMAT_STATS_RTOL, "remat moved the BN running statistics otherwise")
    out["timing"]["remat"] = remat

    # 4. the ConvNet at 64^3, full widths: 10 train steps at batch 8, an eval step
    cfg = SSD3DConfig.create(**CONVNET)
    model, priors = SSD3D(cfg), torch.from_numpy(model_priors(cfg)).cuda()
    state = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, model, priors, augment=augment)
    batch = train_batch(8, torch.Generator(device="cuda").manual_seed(4))
    cgen = torch.Generator(device="cuda").manual_seed(5)
    losses = []
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = step(state, batch, cgen)
        losses.append(m["total_loss"])
    losses = [float(v) for v in losses]
    convnet_s = time.perf_counter() - t0
    ms, state = step_rounds(step, state, batch, cgen, iters=3)
    log(f"ConvNet ({cfg.base_network_config}, layers {cfg.feature_layers}, 64^3 bf16, "
        f"{sum(p.numel() for p in state.params.values()):,} parameters, dropout "
        f"{cfg.convnet_dropout} from the step's generator): 10 steps at batch 8 in "
        f"{convnet_s:.3f} s, losses {[round(v, 4) for v in losses]}; median "
        f"{float(np.median(ms)):.3f} ms a step (CUDA events) [{card}]")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the ConvNet's losses are not finite or did not fall")
    low = dataclasses.replace(cfg, min_score=0.05)
    greedy_nms_cuda.launches = 0
    with tapped(model) as outs:
        ev = make_eval_step(low, model, priors)(state, batch)
    check(greedy_nms_cuda.launches == 1, "the ConvNet's eval step did not launch K1 once")
    check_plain_detections("ConvNet eval step at min_score 0.05", ev["detections"], *outs[0],
                           priors, low)
    out["timing"]["convnet"] = {"losses": losses, "step_ms": float(np.median(ms))}
    out["k1"]["convnet eval"] = greedy_nms_cuda.launches

    # 5. device boxes: connected components on the card against the host's scipy
    timings = {}
    for on in (False, True):
        dm = SyntheticDataModule(root, n_classes=1, device_boxes=on)
        dm.setup("fit")
        t0 = time.perf_counter()
        timings[on] = (dm.materialize(dm.subjects_list), time.perf_counter() - t0)
    host, dev = timings[False][0], timings[True][0]
    for i in range(host["boxes"].shape[0]):
        h = host["boxes"][i][host["box_mask"][i]]
        d = dev["boxes"][i][dev["box_mask"][i]]
        check(h.shape == d.shape and np.allclose(np.sort(h, 0), np.sort(d, 0), atol=1e-6),
              f"device boxes differ from the host's for volume {i}")
    log(f"materialize of {host['boxes'].shape[0]} volumes of {PATCH_DATA['image_size']}: "
        f"host boxes (scipy) {timings[False][1]:.3f} s, device boxes (connected components "
        f"on the card) {timings[True][1]:.3f} s (NIfTI decode included in both); "
        f"{int(host['box_mask'].sum())} boxes, the same sets [{card}]")
    out["timing"]["device_boxes_s"] = (timings[False][1], timings[True][1])
    out["patch_root"], out["patch_last"] = root, last
    log(f"full-resolution phase {time.perf_counter() - t_phase:.1f} s")
    return out


def profile_training(train, card) -> None:
    for b, calls in ((8, 3), (64, 2)):
        def one_step(b=b):
            train["state"], _m = train["step"](train["state"], train["batches"][b], train["gen"])
        profile_calls(f"train step, batch {b}", "train steps", one_step, card, calls)


# ---------------------------------------------------------------- deployment
# phase 4f: the headline bundles' batch sizes (the served batches), the int8
# bundle's (bench.py's int8 cell), the HTTP bundle's, and the HTTP load
BUNDLE_BATCHES = (1, 8, 32)
INT8_BATCHES = (8, 32)
# the sizes a coalesced call of up to 8 rows reaches: route() takes the
# largest that fits, so 7 rows run as 4 + 2 + 1 (at (1, 8) as seven 1s)
HTTP_BATCHES = (1, 2, 4, 8)
HTTP_CLIENTS, HTTP_POSTS = 8, 4
# the published dense int8 rate of the H100 SXM (tensor cores)
PEAK_INT8_OPS = 1979e12


def volumes_per_s(predict, images, iters: int) -> float:
    """Host-clock volumes/s of predict(images), numpy in and out, after 2 warm calls."""
    for _ in range(2):
        predict(images)
    t0 = time.perf_counter()
    for _ in range(iters):
        predict(images)
    return images.shape[0] * iters / (time.perf_counter() - t0)


@contextmanager
def recorded_qconv():
    """Records every Q1 launch made through ``quant.py``: its operands and
    output, to be held against the plain version afterwards."""
    calls = []

    def record(q, wq, scale, bias, stride=1, groups=1, relu=False):
        out = qconv_cuda(q, wq, scale, bias, stride, groups, relu)
        calls.append((q, wq, scale, bias, stride, groups, relu, out))
        return out

    saved = quant.qconv_cuda
    quant.qconv_cuda = record
    try:
        yield calls
    finally:
        quant.qconv_cuda = saved


def qconv_kind(q, wq, stride, groups) -> str:
    if groups > 1:
        return f"depthwise s{max(stride)}"
    if wq.shape[0] == 1:
        return "pointwise"
    return "stem" if q.shape[-1] == 1 else "head"


def valid_taps(n: int, k: int, s: int) -> int:
    """(output, tap) pairs of one axis whose input lies inside it (padding k // 2)."""
    out = (n + 2 * (k // 2) - k) // s + 1
    return sum(0 <= o * s - k // 2 + t < n for o in range(out) for t in range(k))


def qconv_bound(q, wq, stride, groups):
    """(bound ms, bound_by, int8 ops): the int8 multiply-adds this conv's
    shapes need (2 operations each, padded taps not counted) at the int8
    rate, against its bytes (q and the weights read once, scale and bias,
    the float32 output written once) at the memory rate."""
    b, *dims, cin = q.shape
    k, cout = wq.shape[0], wq.shape[-1]
    pairs = math.prod(valid_taps(n, k, s) for n, s in zip(dims, stride))
    ops = 2 * b * pairs * (cin // groups) * cout
    outputs = b * math.prod((n + 2 * (k // 2) - k) // s + 1 for n, s in zip(dims, stride)) * cout
    nbytes = q.numel() + wq.numel() + 8 * cout + 4 * outputs
    return (*bound({PEAK_INT8_OPS: ops}, nbytes), ops)


def drive_deployment(card, counters, cal_state, tmp: Path) -> dict:
    """Phase 4f: deployment. The headline bundles (default path and both
    flags) against the live Detector, the int8 bundle with Q1 held against
    its plain version on every conv of a forward, the sliding-window bundle
    at config #3, and the HTTP server under concurrent clients."""
    t_phase = time.perf_counter()
    out = {"launches": {}, "timing": {}}
    config = SSD3DConfig.create(**HEADLINE)
    rng = np.random.default_rng(1)
    requests = [rng.standard_normal((n, *config.input_size, 1), dtype=np.float32)
                for n in (1, 3, 8)]
    bundles = {}

    # 1. the headline bundles against the live Detector
    for name in ("off", "both"):
        cfg = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
        t0 = time.perf_counter()
        exports, manifest = export_detector(cfg, cal_state, BUNDLE_BATCHES)
        export_s = time.perf_counter() - t0
        path = save_bundle(tmp / f"headline_{name}.mslx", exports, manifest)
        t0 = time.perf_counter()
        det = ServingDetector(path)
        load_s = time.perf_counter() - t0
        live = Detector(cfg, cal_state, batch_sizes=BUNDLE_BATCHES)
        ops = {"msl::greedy_nms"} | ({"msl::fused_depthwise_bn_relu", "msl::fused_tail"}
                                    if name == "both" else set())
        check(set(manifest["custom_ops"]) == ops,
              f"bundle [{name}] calls {manifest['custom_ops']}, not {sorted(ops)}")
        counts = []
        for req in requests:
            want, got = live.predict(req), det.predict(req)
            for key in want:
                check(np.array_equal(got[key], want[key]),
                      f"bundle [{name}]: {key} of a request of {req.shape[0]} volumes != the "
                      "live Detector's")
            counts += got["count"].tolist()
        check(max(counts) > 0, f"bundle [{name}] found nothing")
        x8 = torch.from_numpy(requests[2]).cuda().to(cfg.compute_dtype)
        for c in counters:
            c.launches = 0
        det.detect(x8)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        want_launches = [1, 1, 1, 0] if name == "both" else [1, 0, 0, 0]
        check(launches == want_launches, f"bundle [{name}]: launches (K1, K2, K3, Q1) a call "
              f"{launches}, not {want_launches}")
        out["launches"][name] = launches
        rates = {}
        for b in BUNDLE_BATCHES:
            imgs = rng.standard_normal((b, *config.input_size, 1), dtype=np.float32)
            iters = {1: 20, 8: 10, 32: 5}[b]
            for who, fn in (("live", live.predict), ("bundle", det.predict),
                            ("bundle", det.predict), ("live", live.predict)):
                rates.setdefault(f"{who} batch {b}", []).append(volumes_per_s(fn, imgs, iters))
        size_mb = path.stat().st_size / 1e6
        out["timing"][name] = {"export_s": export_s, "load_s": load_s, "size_mb": size_mb,
                               "volumes_per_s": rates}
        log(f"bundle [{name}] at batches {BUNDLE_BATCHES}: {size_mb:.2f} MB, export "
            f"{export_s:.1f} s, load {load_s:.2f} s; requests of 1, 3 and 8 volumes equal the "
            f"live Detector's (all four outputs, {sum(counts)} detections); launches a call "
            f"(K1, K2, K3, Q1) {launches}; volumes/s (live, bundle, bundle, live): " + "; ".join(
                f"{k} {', '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items())
            + f" [{card}]")
        bundles[name] = {"det": det, "live": live, "exports": exports, "manifest": manifest}

    # 2. int8: quantized on the card from 2 seeded calibration volumes
    calib = np.random.default_rng(0).normal(0, 1, (2, *config.input_size, 1)).astype(np.float32)
    t0 = time.perf_counter()
    qm = quant.quantize_ssd3d(config, cal_state, calib)
    quantize_s = time.perf_counter() - t0
    qmodel = quant.QuantizedSSD3D(qm).cuda()
    n_convs = len(qm["layers"]) + 2 * len(qm["feature_layers"])
    # the bundle's input dtype (the config's, bf16); the int8 forward runs in float32
    x8 = torch.from_numpy(requests[2]).cuda().to(config.compute_dtype)
    with torch.inference_mode(), recorded_qconv() as calls:
        qconv_cuda.launches = 0
        locs_q, scores_q = qmodel(x8)
        torch.cuda.synchronize()
        q1_forward = qconv_cuda.launches
    check(q1_forward == len(calls) == n_convs,
          f"the int8 forward launched Q1 {q1_forward} times for {n_convs} convs")
    int_mismatches = epilogue_mismatches = 0
    max_err = 0.0
    by_kind = {}
    with torch.inference_mode():
        for q, wq, scale, bias, stride, groups, relu, y in calls:
            acc = qconv_s32_cuda(q, wq, stride, groups)
            plain = qconv_s32(q, wq, stride, groups)
            int_mismatches += int((acc != plain).sum())
            ref = qconv_epilogue(plain, scale, bias, relu)
            epilogue_mismatches += int((y != ref).sum())
            max_err = max(max_err, float((y - ref).abs().max()))
            by_kind.setdefault(qconv_kind(q, wq, stride, groups), []).append(
                (q, wq, scale, bias, stride, groups, relu))
    log(f"int8 forward at batch 8 (quantized in {quantize_s:.1f} s): {q1_forward} Q1 launches "
        f"({', '.join(f'{k} {len(v)}' for k, v in by_kind.items())}); against the plain "
        f"version on every conv: {int_mismatches} int32 mismatches, {epilogue_mismatches} "
        "epilogue mismatches (bit for bit)")
    check(int_mismatches == 0 and epilogue_mismatches == 0, "Q1 disagrees with its plain version")
    q1 = {"launches_forward": q1_forward, "int_mismatches": int_mismatches,
          "epilogue_mismatches": epilogue_mismatches, "max_abs_err": max_err, "kinds": {}}
    with torch.inference_mode():
        for kind, convs in by_kind.items():
            def replay(convs=convs):
                for c in convs:
                    qconv_cuda(*c)

            def plain(convs=convs):
                for q, wq, scale, bias, stride, groups, relu in convs:
                    qconv_epilogue(qconv_s32(q, wq, stride, groups), scale, bias, relu)

            doubles = [(q.permute(0, 4, 1, 2, 3).double(), wq.permute(4, 3, 0, 1, 2).double(),
                        stride, wq.shape[0] // 2, groups) for q, wq, _, _, stride, groups, _
                       in convs]

            def conv64(doubles=doubles):
                for x, w, stride, pad, groups in doubles:
                    F.conv3d(x, w, stride=stride, padding=pad, groups=groups)

            # 20 calls: a trace of Q1 alone holds few kernel records (1 a call
            # at the stem), and the profiler can lose some of them
            _, split = device_ms(replay, iters=20)
            kernel_ms = sum(ms for fn, ms in split.items() if "qconv" in fn)
            check(kernel_ms > 0, f"the profiler saw no Q1 kernel [{kind}]: {split}")
            bounds = [qconv_bound(c[0], c[1], c[4], c[5]) for c in convs]
            bound_ms = sum(b[0] for b in bounds)
            entry = {"convs": len(convs), "ms": kernel_ms, "call_ms": cuda_ms(replay, iters=10),
                     "plain_ms": cuda_ms(plain, iters=2, warmup=1),
                     "float64_conv3d_ms": cuda_ms(conv64, iters=2, warmup=1),
                     "bound_ms": bound_ms, "bound_by": max(bounds)[1],
                     "int8_ops": sum(b[2] for b in bounds)}
            if kind == "pointwise":  # cuBLASLt's s8 GEMM on the same integers: a yardstick
                mats = [(c[0].reshape(-1, c[0].shape[-1]), c[1].reshape(c[1].shape[3], -1))
                        for c in convs]
                check(all(a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
                          for a, b in mats), "a pointwise shape _int_mm does not take")

                def int_mm(mats=mats):
                    for a, b in mats:
                        torch._int_mm(a, b)

                entry["int_mm_ms"] = device_ms(int_mm, iters=5)[0]
            q1["kinds"][kind] = entry
            log(f"Q1 [{kind}] at batch 8, {len(convs)} conv(s) a forward: {kernel_ms:.4f} ms "
                f"device time ({entry['call_ms']:.4f} ms per forward's calls), plain "
                f"{entry['plain_ms']:.3f} ms, float64 F.conv3d of the same integers "
                f"{entry['float64_conv3d_ms']:.3f} ms"
                + (f", torch._int_mm {entry['int_mm_ms']:.4f} ms" if "int_mm_ms" in entry else "")
                + f", bound {bound_ms:.5f} ms ({entry['int8_ops']:.3e} int8 ops) [{card}]")
    for field in ("ms", "plain_ms", "bound_ms"):
        q1[field] = sum(k[field] for k in q1["kinds"].values())
    q1["int_mm_ms_pointwise"] = q1["kinds"]["pointwise"]["int_mm_ms"]
    q1["bound_by"] = max(q1["kinds"].values(), key=lambda k: k["bound_ms"])["bound_by"]
    log(f"Q1 over one int8 forward at batch 8: {q1['ms']:.4f} ms device time, plain "
        f"{q1['plain_ms']:.3f} ms, bound {q1['bound_ms']:.5f} ms [{card}]")
    out["q1"] = q1

    # the int8 bundle at batch 8 and 32, against the live int8 program
    t0 = time.perf_counter()
    exports, manifest = export_detector(config, cal_state, INT8_BATCHES, quantize="int8",
                                        calib_images=calib)
    int8_export_s = time.perf_counter() - t0
    int8 = ServingDetector(save_bundle(tmp / "int8.mslx", exports, manifest))
    check(set(manifest["custom_ops"]) == {"msl::greedy_nms", "msl::qconv"},
          f"the int8 bundle calls {manifest['custom_ops']}")
    live_q = DetectionProgram.for_config(qmodel, config).cuda()
    for c in counters:
        c.launches = 0
    got = int8.detect(x8)
    torch.cuda.synchronize()
    int8_launches = [c.launches for c in counters]
    check(int8_launches == [1, 0, 0, n_convs],
          f"the int8 bundle launched (K1, K2, K3, Q1) {int8_launches} in a call")
    out["launches"]["int8"] = int8_launches
    with torch.inference_mode():
        want = live_q(x8)
    for key in want:
        check(torch.equal(got[key], want[key]), f"int8 bundle: {key} != the live int8 program's")
    with torch.inference_mode():
        locs_b, scores_b = bundles["off"]["live"].model(x8)
    rel = {name: float((a.float() - b.float()).norm() / b.float().norm())
           for name, a, b in (("locs", locs_q, locs_b), ("scores", scores_q, scores_b))}
    bf16_det = bundles["off"]["det"].predict(requests[2])
    int8_det = {k: v.cpu().numpy() for k, v in got.items()}
    matched = total = 0
    for i in range(8):
        n, m = int(int8_det["count"][i]), int(bf16_det["count"][i])
        total += n
        if n and m:
            iou = pairwise_iou(torch.from_numpy(int8_det["boxes"][i, :n]),
                               torch.from_numpy(bf16_det["boxes"][i, :m]))
            same = (torch.from_numpy(int8_det["labels"][i, :n])[:, None]
                    == torch.from_numpy(bf16_det["labels"][i, :m])[None, :])
            matched += int(((iou > 0.5) & same).any(1).sum())
    rates = {}
    for b in INT8_BATCHES:
        imgs = rng.standard_normal((b, *config.input_size, 1), dtype=np.float32)
        for who, det_ in (("bf16", bundles["off"]["det"]), ("int8", int8), ("int8", int8),
                          ("bf16", bundles["off"]["det"])):
            rates.setdefault(f"{who} batch {b}", []).append(
                volumes_per_s(det_.predict, imgs, {8: 10, 32: 5}[b]))
    # device time of a bundle call, bf16 default against int8, in turns
    # (bf16, int8, int8, bf16) at each batch: busy ms, idle share, launches
    # and the busy time by kind of kernel
    kinds = (("Q1", ("qconv",)), ("cuDNN conv", ("conv", "cudnn", "xmma", "sm90_")),
             ("K1", ("nms",)))
    device = {}
    for b in INT8_BATCHES:
        xb = torch.from_numpy(rng.standard_normal((b, *config.input_size, 1),
                                                  dtype=np.float32)).cuda().to(
            config.compute_dtype)
        for who, det_ in (("bf16", bundles["off"]["det"]), ("int8", int8), ("int8", int8),
                          ("bf16", bundles["off"]["det"])):
            prof = profile_calls(f"{who} bundle", f"bundle calls at batch {b}",
                                 partial(det_.detect, xb), card, top=6)
            split = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
            for kernel, ms in prof.pop("by_kernel").items():
                kind = next((k for k, keys in kinds
                             if any(key in kernel.lower() for key in keys)), "other")
                split[kind] += ms
            device.setdefault(f"{who} batch {b}", []).append({**prof, "busy_ms_by_kind": split})
    log("bundle calls on the card, bf16 default / int8 in turns: " + "; ".join(
        f"{k}: " + ", ".join(f"busy {r['busy_ms']:.3f} ms (" + ", ".join(
            f"{kind} {ms:.3f}" for kind, ms in r["busy_ms_by_kind"].items())
            + f"), idle {r['idle_share']:.3f}, {r['launches']} launches" for r in rs)
        for k, rs in device.items()) + f" [{card}]")
    out["timing"]["int8"] = {"quantize_s": quantize_s, "export_s": int8_export_s,
                             "volumes_per_s": rates, "device": device,
                             "rel_err_vs_bf16": rel,
                             "detections": total, "matched_iou_0.5": matched,
                             "bf16_detections": int(bf16_det["count"].sum())}
    log(f"int8 bundle at batches {INT8_BATCHES} (export {int8_export_s:.1f} s): detections == "
        f"the live int8 program's; launches a call (K1, K2, K3, Q1) {int8_launches}; against "
        f"the bf16 model on the same volumes: locs relative error {rel['locs']:.4f}, scores "
        f"{rel['scores']:.4f}; {matched} of the int8 bundle's {total} detections have an IoU > "
        f"0.5 match of their label among the bf16 bundle's {int(bf16_det['count'].sum())}; "
        "volumes/s (bf16, int8, int8, bf16): " + "; ".join(
            f"{k} {', '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items()) + f" [{card}]")
    check(total > 0, "the int8 bundle found nothing")

    # 3. the sliding-window bundle at config #3, V = 1, default path
    t0 = time.perf_counter()
    exports, manifest = export_sliding_window_detector(config, cal_state, FULL_VOLUME, (1,))
    sw_export_s = time.perf_counter() - t0
    sw = ServingDetector(save_bundle(tmp / "full.mslx", exports, manifest))
    state = create_train_state(config, device="cuda", state_dict=cal_state)
    run = sliding_window.make_sliding_window_detector(config, FULL_VOLUME)
    gen = torch.Generator(device="cuda").manual_seed(2)
    vol = torch.randn((1, *FULL_VOLUME, 1), generator=gen, device="cuda")
    want = run(state, vol[0])
    for c in counters:
        c.launches = 0
    got = sw.detect(vol.to(config.compute_dtype))
    torch.cuda.synchronize()
    sw_launches = [c.launches for c in counters]
    check(sw_launches == [2, 0, 0, 0],
          f"the sliding-window bundle launched (K1, K2, K3, Q1) {sw_launches} in a call")
    out["launches"]["sliding_window"] = sw_launches
    for key in want:
        check(torch.equal(got[key], want[key]),
              f"sliding-window bundle: {key} != the live sliding window's")
    check(int(want["count"].min()) > 0, "the sliding-window bundle found nothing")
    xb = vol.to(config.compute_dtype)
    sw.detect(xb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        det = sw.detect(xb)
    det["count"].cpu()
    sw_rate = 10 / (time.perf_counter() - t0)
    out["timing"]["sliding_window"] = {"export_s": sw_export_s, "volumes_per_s": sw_rate}
    log(f"sliding-window bundle {FULL_VOLUME} V=1 (export {sw_export_s:.1f} s): detections == "
        f"the live sliding window's ({int(want['count'][0])}); launches a call (K1, K2, K3, Q1) "
        f"{sw_launches}; {sw_rate:.2f} volumes/s (host clock, volume on the card) [{card}]")

    # 4. HTTP: the default bundle at batches 1, 2, 4 and 8, concurrent clients
    cfg = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS["off"])
    exports, manifest = export_detector(cfg, cal_state, [b for b in HTTP_BATCHES
                                                         if b not in BUNDLE_BATCHES])
    exports |= {k: v for k, v in bundles["off"]["exports"].items() if k[0] in HTTP_BATCHES}
    manifest["batch_sizes"] = sorted(b for b, _ in exports)
    det = ServingDetector(save_bundle(tmp / "http.mslx", exports, manifest))
    check(det.batch_sizes == list(HTTP_BATCHES), f"the HTTP bundle holds {det.batch_sizes}")
    n_vol = HTTP_CLIENTS * HTTP_POSTS
    vols = rng.standard_normal((n_vol, *config.input_size, 1), dtype=np.float32)

    def rows_at(b):
        """Each volume's detections as a row of the batch-b program."""
        outs = [det.detect(torch.from_numpy(vols[i:i + b]).cuda().to(det.input_dtype))
                for i in range(0, n_vol, b)]
        return {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}

    ref = {b: rows_at(b) for b in HTTP_BATCHES}
    server = make_http_server(det, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    latencies = [0.0] * n_vol

    def client(c):
        got = {}
        for j in range(HTTP_POSTS):
            i = c * HTTP_POSTS + j
            buf = io.BytesIO()
            np.save(buf, vols[i:i + 1])
            req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            got[i] = json.loads(urllib.request.urlopen(req, timeout=300).read())["volumes"]
            latencies[i] = time.perf_counter() - t0
        return got

    try:
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=HTTP_CLIENTS) as ex:
            responses = {i: r for got in ex.map(client, range(HTTP_CLIENTS))
                         for i, r in got.items()}
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        http_launches = [c.launches for c in counters]
        predict_calls = server.batcher.device_calls
    finally:
        server.shutdown()
        server.batcher.close()
        thread.join(timeout=10)
    out["launches"]["http"] = http_launches
    # each program call launches K1 once and nothing else of the port
    program_calls = http_launches[0]
    check(http_launches[1:] == [0, 0, 0], f"the HTTP run launched (K1, K2, K3, Q1) "
          f"{http_launches}")

    def same(v, res, row):
        n = int(res["count"][row])
        return (v["count"] == n and v["labels"] == res["labels"][row][:n].tolist()
                and np.array_equal(np.asarray(v["boxes_frac"], np.float32).reshape(-1, 6),
                                   res["boxes"][row][:n])
                and np.array_equal(np.asarray(v["scores"], np.float32), res["scores"][row][:n]))

    # a response may equal its row at several batch sizes (where the
    # programs agree on that volume), so each size counts its own matches
    at_batch = dict.fromkeys(HTTP_BATCHES, 0)
    for i, (v,) in responses.items():
        matches = [b for b in HTTP_BATCHES if same(v, ref[b], i)]
        check(bool(matches), f"HTTP response {i} != its volume's row of any program's output")
        for b in matches:
            at_batch[b] += 1
    check(program_calls < n_vol, f"{program_calls} program calls for {n_vol} requests")
    p50, p95 = (float(np.percentile(latencies, p)) * 1e3 for p in (50, 95))
    out["timing"]["http"] = {"requests": n_vol, "predict_calls": predict_calls,
                             "program_calls": program_calls, "p50_ms": p50, "p95_ms": p95,
                             "volumes_per_s": n_vol / wall,
                             "equal_to_a_row_at_batch": at_batch}
    log(f"HTTP on the bundle at batches {HTTP_BATCHES}: {HTTP_CLIENTS} clients x {HTTP_POSTS} "
        f"POSTs of one volume: {predict_calls} coalesced predict calls and {program_calls} "
        f"program calls (K1 launches) for {n_vol} requests; every response == its volume's row "
        f"of a program's output (responses equal to their row at each batch size: {at_batch}); latency p50 {p50:.1f} ms, p95 "
        f"{p95:.1f} ms; {n_vol / wall:.1f} volumes/s [{card}]")
    log(f"deployment phase {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------- data parallelism
# phase 4g: a step of two gloo ranks sharing the card against the 1-rank step
# on the same global batch, bf16 at 64^3: the two round the same float32
# sums in another order and cuDNN may pick other algorithms at batch 4 than
# at 8, each a bf16 rounding (2^-8) of some elements; the losses, gradient
# norm, BN statistics, the whole gradient vector and the forward's locs and
# scores (relative Frobenius) within 1e-2 (a few bf16 roundings). The
# params after the step: every element whose effective gradient is above
# DP_FLIP_FLOOR x the RMS moved the 1-rank step's way, within DP_SAME_WAY
# lr of it (the first Adam step moves an element by about lr, so a flip
# ends 2 lr apart; in three runs on an H100 the flipped elements'
# gradients reached 0.032-0.063 x the RMS, and above 0.1 x the RMS the two
# differed by 1e-6 lr). The with_detections step's detections: counts
# equal and each within DP_DET_ATOL (box corners, score) of one of the
# same volume and label in the other run (1.6e-3 at most there; near ties
# change places)
DP_RTOL = 1e-2
DP_FLIP_FLOOR = 0.3
DP_SAME_WAY = 1e-2
DP_DET_ATOL = 1e-2
DP_TIMEOUT_S = 300
# phase 4g's ConvNet dropout cost: the global batch's mask a rank draws at W ranks
DROPOUT_WORLDS = (1, 2, 8)


def dp_rank(rank: int, port: int, tmp: str) -> None:
    """Rank ``rank`` of two gloo ranks sharing the card (phase 4g (b)): the
    64^3 bf16 train step with augmentation and the ``with_detections`` step
    on its rows of the global batch of 8; saves what it computed."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0",
                         timeout_s=DP_TIMEOUT_S)
    out = {"on": "cuda"}
    probe = torch.ones(4, device="cuda")
    try:  # gloo's table lists all_reduce and broadcast for CUDA tensors: check it
        torch.distributed.all_reduce(probe)
        torch.distributed.broadcast(probe, 0)
    except RuntimeError as e:  # recorded and printed by the phase, never silent
        out.update(on="cpu", cuda_error=f"{type(e).__name__}: {e}")
    else:
        check(bool((probe == 2).all()), "gloo's all_reduce of CUDA tensors gave a wrong sum")
    mesh = make_mesh(device=out["on"], backend="gloo")
    out["mesh"] = mesh.describe()
    config = SSD3DConfig.create(**TRAIN)
    model, priors = SSD3D(config), torch.from_numpy(model_priors(config))
    state = create_train_state(config, seed=0, device=mesh.device)
    batch = {k: v.to(mesh.device) for k, v in train_batch(8, torch.Generator(
        device="cuda").manual_seed(1)).items()}
    local = shard_batch(batch, mesh)
    augment = AugmentConfig(**TRAIN_AUGMENT)
    step = make_train_step(config, model, priors, augment=augment, mesh=mesh, return_grads=True)
    low = dataclasses.replace(config, min_score=0.05)
    metric = make_train_step(low, model, priors, augment=augment, mesh=mesh, with_detections=True)
    greedy_nms_cuda.launches = 0
    new, m = step(state, local, torch.Generator(device=mesh.device).manual_seed(2))
    with tapped(model) as outs:
        _, dm = metric(state, local, torch.Generator(device=mesh.device).manual_seed(3))
    out["k1"] = greedy_nms_cuda.launches
    def host(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    out.update(metrics=host({k: m[k] for k in ("total_loss", "conf_loss", "loc_loss",
                                                "grad_norm", "n_positives")}),
               params=host(new.params), batch_stats=host(new.batch_stats),
               grads=host(m["grads"]),
               detections=host(dm["detections"]), locs_scores=[t.cpu() for t in outs[0]])
    gen = torch.Generator(device=mesh.device).manual_seed(4)
    if out["on"] == "cuda":
        ms, _ = step_rounds(step, new, local, gen, iters=5)
        out["step_ms"] = ms
    torch.save(out, Path(tmp) / f"dp_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def ranks_on_one_card(tmp: Path, rank_fn=None, timeout_s: float = DP_TIMEOUT_S,
                      nprocs: int = 2) -> list:
    """Spawns the ``nprocs`` ranks of ``rank_fn`` (default ``dp_rank``), each
    saving ``<name>{rank}.pt`` in ``tmp``, and waits for them, each join
    bounded; returns their saved results."""
    rank_fn = rank_fn or dp_rank
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.start_processes(rank_fn, args=(port, str(tmp)), nprocs=nprocs,
                                               join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() < deadline,
                  f"the {nprocs} gloo ranks outlived their timeout")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(tmp / f"{rank_fn.__name__}{r}.pt", weights_only=False)
            for r in range(nprocs)]


def match_detections(det: dict, ref: dict) -> torch.Tensor:
    """For each detection of ``det`` (volumes in order, the first ``count``
    of each), its distance to the nearest detection of the same volume and
    label in ``ref``: the larger of the box corners' and the score's
    largest absolute difference (inf where ``ref`` has none)."""
    dists = []
    for v in range(det["count"].shape[0]):
        n, n_ref = int(det["count"][v]), int(ref["count"][v])
        boxes, rboxes = det["boxes"][v, :n].float(), ref["boxes"][v, :n_ref].float()
        d = torch.maximum((boxes[:, None] - rboxes[None]).abs().amax(-1),
                          (det["scores"][v, :n, None] - ref["scores"][v, None, :n_ref]).abs())
        d = torch.where(det["labels"][v, :n, None] == ref["labels"][v, None, :n_ref], d,
                        torch.full_like(d, math.inf))
        dists.append(d.amin(1) if n_ref else torch.full((n,), math.inf))
    return torch.cat(dists)


def drive_two_ranks(card, tmp: Path, expect) -> dict:
    """Phase 4g (b): two gloo ranks sharing the card (``dp_rank``) against
    the 1-rank step on the same global batch and generators: the metrics,
    the gradients, the BN statistics, the params after the step, each
    rank's forward and the detections of the ``with_detections`` step."""
    t0 = time.perf_counter()
    ranks = ranks_on_one_card(tmp)
    spawn_s = time.perf_counter() - t0
    on = ranks[0]["on"]
    expect(all(r["on"] == on for r in ranks), "the ranks ran on different devices")
    if on == "cpu":
        log(f"gloo's collectives of CUDA tensors failed on this card "
            f"({ranks[0]['cuda_error']}): (b) ran on CPU tensors")
    config = SSD3DConfig.create(**TRAIN)
    model, priors = SSD3D(config), torch.from_numpy(model_priors(config))
    state = create_train_state(config, seed=0, device=on)
    batch = {k: v.to(on) for k, v in train_batch(8, torch.Generator(
        device="cuda").manual_seed(1)).items()}
    augment = AugmentConfig(**TRAIN_AUGMENT)
    new, m = make_train_step(config, model, priors, augment=augment, return_grads=True)(
        state, batch, torch.Generator(device=on).manual_seed(2))
    low = dataclasses.replace(config, min_score=0.05)
    with tapped(model) as outs:
        _, dm1 = make_train_step(low, model, priors, augment=augment, with_detections=True)(
            state, batch, torch.Generator(device=on).manual_seed(3))
    rel = {k: max(abs(float(r["metrics"][k]) - float(m[k])) / abs(float(m[k])) for r in ranks)
           for k in ("total_loss", "conf_loss", "loc_loss", "grad_norm")}
    stats_rel = max(float((r["batch_stats"][n] - s.cpu()).abs().max()
                          / s.cpu().abs().max().clamp(min=1e-12))
                    for r in ranks for n, s in new.batch_stats.items())
    names = list(new.params)
    g1 = torch.cat([m["grads"][n].float().cpu().ravel() for n in names])
    grads_rel = max(float((torch.cat([r["grads"][n].float().ravel() for n in names]) - g1)
                          .norm() / g1.norm()) for r in ranks)
    # the params: Adam's first step moves an element by about its lr, the
    # way its effective gradient (g + wd p) points; where that gradient is
    # well above the ranks' rounding noise, each rank's element must have
    # moved the 1-rank step's way (a flip ends 2 lr apart, the same way
    # about lr eps / |g|)
    flat = lambda tree: torch.cat([tree[n].float().cpu().ravel() for n in names])  # noqa: E731
    p0, p1 = flat(state.params), flat(new.params)
    lr = torch.cat([torch.full((state.params[n].numel(),),
                               config.lr * (BIAS_MULT if is_bias(n) else 1.0)) for n in names])
    g_eff = (g1 + state.tx.weight_decay * p0).abs()
    g_rms = float(g_eff.square().mean().sqrt())
    moved = torch.stack([(flat(r["params"]) - p1).abs() / lr for r in ranks]).amax(0)
    strong = g_eff > DP_FLIP_FLOOR * g_rms
    worst_strong = float(moved[strong].max())
    flipped = moved > 1.0
    flip_top = float(g_eff[flipped].max()) / g_rms if bool(flipped.any()) else 0.0
    floors = {f: (int((g_eff > f * g_rms).sum()), float(moved[g_eff > f * g_rms].max()))
              for f in (1e-3, 1e-2, 1e-1, 1.0)}
    equal_ranks = all(torch.equal(ranks[0][t][n], ranks[1][t][n])
                      for t in ("params", "batch_stats") for n in ranks[0][t])
    # each rank's forward (the with_detections step's) against its rows of
    # the 1-rank forward: a wrong global BN or a wrong row would show here
    fwd_rel = max(float((r["locs_scores"][t].float() - outs[0][t][4 * i:4 * i + 4].float().cpu())
                        .norm() / outs[0][t][4 * i:4 * i + 4].float().norm())
                  for i, r in enumerate(ranks) for t in (0, 1))
    det2 = {k: torch.cat([r["detections"][k] for r in ranks]) for k in dm1["detections"]}
    det1 = {k: v.cpu() for k, v in dm1["detections"].items()}
    for r in ranks:  # each rank's K1 against the plain NMS on its own locs and scores
        check_plain_detections(f"two gloo ranks, with_detections step [{r['mesh']}]",
                               {k: v.to(on) for k, v in r["detections"].items()},
                               *(t.to(on) for t in r["locs_scores"]), priors.to(on), low)
    # the ranks' detections against the 1-rank step's, as sets (near ties
    # may change places): counts equal, every detection within
    # DP_DET_ATOL of one of the same volume and label, both ways
    dist = torch.cat([match_detections(det2, det1), match_detections(det1, det2)])
    in_place = (det2["labels"] == det1["labels"]) & ((det2["boxes"] - det1["boxes"]).abs()
                                                     .amax(-1) <= DP_DET_ATOL)
    counts_equal = torch.equal(det2["count"], det1["count"])
    log(f"two gloo ranks sharing the card ({on} tensors; {ranks[0]['mesh']}; spawned and "
        f"joined in {spawn_s:.1f} s): the 64^3 bf16 step at global batch 8 with augmentation "
        f"against the 1-rank step on the same batch and generator: relative differences "
        f"{', '.join(f'{k} {v:.2e}' for k, v in rel.items())}, the gradient vector "
        f"{grads_rel:.2e}, BN statistics {stats_rel:.2e}, the forward's locs and scores "
        f"{fwd_rel:.2e} (bound {DP_RTOL} each); the ranks' states bit-equal: {equal_ranks} "
        f"[{card}]")
    log(f"  params after the step, in lr of their group: {int(flipped.sum())} of {p1.numel():,} "
        f"elements moved the other way (the largest effective gradient among them "
        f"{flip_top:.3e} x its RMS {g_rms:.3e}); above {DP_FLIP_FLOOR} x the RMS "
        f"({int(strong.sum()):,} elements) the largest difference is {worst_strong:.3e} lr "
        f"(bound {DP_SAME_WAY}); by floor (x RMS: elements, largest difference in lr) "
        f"{ {f: (n, round(d, 4)) for f, (n, d) in floors.items()} }")
    log(f"  with_detections step (min_score 0.05): K1 launches per rank "
        f"{[r['k1'] for r in ranks]}; detections per volume {det2['count'].tolist()} (1 rank: "
        f"{det1['count'].tolist()}); each detection's distance to its nearest of the same volume "
        f"and label in the other run (box corners and score, both ways): largest "
        f"{float(dist.max()):.3e}, {float((dist <= DP_DET_ATOL).float().mean()):.5f} within "
        f"{DP_DET_ATOL}, quantiles 0.5/0.9/0.99 "
        f"{[round(float(q), 6) for q in dist.float().quantile(torch.tensor([0.5, 0.9, 0.99]))]}; "
        f"{float(in_place.float().mean()):.5f} of the slots hold the same label and box within "
        f"{DP_DET_ATOL}; ms a step per rank "
        f"{[[round(v, 3) for v in r.get('step_ms', [])] for r in ranks]} (CUDA events, two "
        f"processes on one card, collectives through host memory) [{card}]")
    expect(max(rel.values()) <= DP_RTOL and grads_rel <= DP_RTOL and stats_rel <= DP_RTOL
           and fwd_rel <= DP_RTOL, "the two-rank step disagrees with the 1-rank step")
    expect(worst_strong <= DP_SAME_WAY,
           f"params: an element whose effective gradient is above {DP_FLIP_FLOOR} x the RMS "
           f"moved {worst_strong:.3e} lr from the 1-rank step's")
    expect(counts_equal and bool((dist <= DP_DET_ATOL).all()),
           "the two ranks' detections differ from the 1-rank step's")
    expect(equal_ranks, "the two ranks' states differ after the step")
    expect(all(r["k1"] == 1 for r in ranks), "a rank's with_detections step did not launch K1 once")
    return {"k1": [r["k1"] for r in ranks], "on": on, "relative": rel, "stats_rel": stats_rel,
            "grads_rel": grads_rel, "forward_rel": fwd_rel, "params_flipped": int(flipped.sum()),
            "params_flip_top_x_rms": flip_top, "params_worst_above_floor_lr": worst_strong,
            "detections_max_dist": float(dist.max()), "detections_in_place":
            float(in_place.float().mean()), "step_ms": [r.get("step_ms") for r in ranks],
            "counts": det2["count"].tolist(), "counts_one_rank": det1["count"].tolist()}


def drive_data_parallel(card, counters, tmp: Path, entry: dict, full: dict,
                        cal_state) -> dict:
    """Phase 4g: data parallelism on the one card. (a) the recipe through
    ``cli.train --data_parallel 1`` (a one-rank NCCL group) beside the same
    run without it; (b) two gloo ranks sharing the card against the 1-rank
    step; (c) the sliding window at config #3 over a mesh of two shards on
    the card against the unsharded detector, and ``cli.predict -sw 1
    --sw_data_parallel 1``; (d) the ConvNet's dropout draws at W ranks."""
    t_phase = time.perf_counter()
    out = {"k1": {}, "k2": {}, "k3": {}, "q1": {}, "timing": {}, "mismatches": 0}
    failed = []

    def expect(cond, message: str) -> None:
        """A check of this phase: every one is made, and any failure fails the
        phase at its end."""
        if not cond:
            log(f"CHECK FAILED: {message}")
            failed.append(message)

    # (a) the recipe with and without a one-rank NCCL group
    args = ["-d", str(entry["root"]), *recipe.TRAIN_FLAGS, "-mi", str(RECIPE_STEPS), "-ld",
            str(tmp / "dp_logs"), "--device", "cuda"]
    runs = {}
    # cuDNN's default algorithms need not repeat a run bit for bit (its
    # weight gradients sum in any order): the comparison takes deterministic ones
    torch.backends.cudnn.deterministic = True
    for name, extra in (("plain", []), ("data_parallel", ["--data_parallel", "1"]),
                        ("plain again", [])):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        result = train_cli.main([*args, "-en", name.replace(" ", "_"), *extra])
        fit_s = time.perf_counter() - t0
        epochs = result["timings"]["epochs"]
        runs[name] = {"losses": [v for e in epochs for v in e["train_losses"]],
                      "val": [h["avg_val_loss"] for h in result["history"]],
                      "ms_per_step": [e["train_s"] / e["steps"] * 1e3 for e in epochs],
                      "fit_s": fit_s, "launches": [c.launches for c in counters]}
        if name == "data_parallel":
            expect(torch.distributed.is_initialized()
                  and torch.distributed.get_backend() == "nccl"
                  and torch.distributed.get_world_size() == 1,
                  "cli.train --data_parallel 1 did not run over a one-rank NCCL group")
    torch.backends.cudnn.deterministic = False
    plain, dp, again = runs["plain"], runs["data_parallel"], runs["plain again"]
    diff = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"], plain["losses"]))
    noise = max(abs(a - b) / abs(b) for a, b in zip(again["losses"], plain["losses"]))
    log(f"cli.train without --data_parallel twice (cuDNN deterministic): training losses "
        f"{'bit-equal' if noise == 0 else f'differ by up to {noise:.2e} (relative)'}")
    log(f"cli.train (the recipe, {RECIPE_STEPS} steps) with --data_parallel 1 over a "
        f"one-rank NCCL group and without it: training losses "
        f"{'bit-equal' if diff == 0 else f'largest relative difference {diff:.2e}'}; "
        f"avg_val_loss {[round(v, 5) for v in dp['val']]} / {[round(v, 5) for v in plain['val']]}; "
        f"K1 launches {dp['launches'][0]} / {plain['launches'][0]}; trainer ms per step by "
        f"epoch {[round(v, 3) for v in dp['ms_per_step']]} / "
        f"{[round(v, 3) for v in plain['ms_per_step']]}; cli.train {dp['fit_s']:.3f} / "
        f"{plain['fit_s']:.3f} s [{card}]")
    # bit-equal where the run repeats bit for bit; else within its own spread
    expect(dp["losses"] == plain["losses"] if noise == 0 else diff <= 2 * noise,
           f"the one-rank data-parallel run's losses differ from the plain run's by {diff:.2e} "
           f"(the plain runs' spread {noise:.2e})")
    expect(dp["launches"] == plain["launches"] and dp["launches"][0] > 0,
          f"K1-K3 launches {dp['launches']} with --data_parallel 1, {plain['launches']} without")
    out["k1"]["cli.train --data_parallel 1"] = dp["launches"][0]
    out["q1"]["cli.train --data_parallel 1"] = dp["launches"][3]
    # the bare gathered step at the recipe's configuration, with and without
    # the mesh of one: the price of the collectives
    config = SSD3DConfig.from_json_dict(
        json.loads((Path(entry["last"]) / "meta.json").read_text())["config"])
    model, priors = SSD3D(config), torch.from_numpy(model_priors(config)).cuda()
    dm_ = SyntheticDataModule(entry["root"], n_classes=1, batch_size=8, max_objects=16)
    dm_.setup("fit")
    data = {k: torch.from_numpy(v).cuda() for k, v in dm_.materialize(dm_.trainsubs).items()
            if isinstance(v, np.ndarray)}
    mesh = make_mesh(device="cuda")
    augment = AugmentConfig.from_names(["flip", "rotate90", "zoom"])
    idx = torch.arange(8, device="cuda")
    bare = {}
    for name in ("plain", "mesh of one", "mesh of one", "plain"):
        step = (make_gathered_train_step(config, model, priors, augment,
                                         hard_negative_mining=True) if name == "plain" else
                make_sharded_gathered_train_step(config, model, priors, mesh, augment,
                                                 hard_negative_mining=True))
        state = create_train_state(config, seed=0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(2):
            state, _m = step(state, data, idx, gen)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            state, _m = step(state, data, idx, gen)
        end.record()
        torch.cuda.synchronize()
        bare.setdefault(name, []).append(start.elapsed_time(end) / 10)
    # the collectives of one step over the mesh of one
    reduce, calls = torch.distributed.all_reduce, []

    def counted(tensor, *args, **kwargs):
        calls.append(tensor.numel())
        return reduce(tensor, *args, **kwargs)

    step = make_sharded_gathered_train_step(config, model, priors, mesh, augment,
                                            hard_negative_mining=True)
    torch.distributed.all_reduce = counted
    try:
        state, _m = step(state, data, idx, gen)
    finally:
        torch.distributed.all_reduce = reduce
    # one small all-reduce alone: its host time a call and the card's
    small = torch.ones(64, device="cuda")
    for _ in range(10):
        torch.distributed.all_reduce(small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        torch.distributed.all_reduce(small)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    card_us = cuda_ms(lambda: torch.distributed.all_reduce(small), iters=200) * 1e3
    log(f"one step over the mesh of one makes {len(calls)} all-reduces of {sum(calls):,} "
        f"elements in all (the largest {max(calls):,}: the gradients); one all-reduce of 64 "
        f"floats over the one-rank NCCL group takes {host_us:.1f} us of host time a call and "
        f"{card_us:.1f} us a call back to back on the card (CUDA events) [{card}]")
    out["timing"]["all_reduces_a_step"] = {"calls": len(calls), "elements": sum(calls),
                                           "host_us_a_call": host_us, "card_us_a_call": card_us}
    log(f"bare gathered step at the recipe's configuration (float32 64^3 width 1.0, batch 8): "
        f"{', '.join(f'{k} {[round(v, 3) for v in ms]} ms' for k, ms in bare.items())} "
        f"(CUDA events, 10 steps a round, rounds in the order plain, mesh, mesh, plain; the "
        f"mesh's steps sum the BN statistics, the loss's positives and the gradients over "
        f"NCCL) [{card}]")
    out["timing"]["nccl_one_rank"] = {
        "losses_bit_equal": dp["losses"] == plain["losses"], "losses_rel_diff": diff,
        "plain_runs_rel_diff": noise,
        "trainer_ms_per_step": {"data_parallel": dp["ms_per_step"],
                                "plain": plain["ms_per_step"]},
        "bare_step_ms": bare}
    torch.distributed.destroy_process_group()
    del data, state, step
    torch.cuda.empty_cache()

    # (b) two gloo ranks sharing the card, against the 1-rank step
    two = drive_two_ranks(card, tmp, expect)
    out["k1"]["two gloo ranks, with_detections step (per rank)"] = two.pop("k1")
    out["timing"]["two_ranks"] = two
    torch.cuda.empty_cache()

    # (c) the sliding window at config #3 over a mesh of two shards on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    volumes = torch.randn((4, *FULL_VOLUME, 1), generator=gen, device="cuda")
    mesh2 = ("cuda:0", "cuda:0")
    for name in ("off", "both"):
        config = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
        state = create_train_state(config, device="cuda", state_dict=cal_state)
        for v in (1, 4):
            key = f"{name} V={v}"
            x = volumes[0] if v == 1 else volumes
            plain_run = sliding_window.make_sliding_window_detector(config, FULL_VOLUME,
                                                                    volume_batch=v)
            run = sliding_window.make_sliding_window_detector(config, FULL_VOLUME,
                                                              volume_batch=v, mesh=mesh2)
            ref = plain_run(state, x)
            run(state, x)  # warm-up: cuDNN's algorithm choice at the shard's batch
            torch.cuda.synchronize()
            with ExitStack() as stack:
                calls = stack.enter_context(recorded_nms())
                taps = (stack.enter_context(on_first_forward(SSD3D, tapped_kernel_operands))
                        if name == "both" else None)
                for c in counters:
                    c.launches = 0
                det = run(state, x)
                torch.cuda.synchronize()
                launches = [c.launches for c in counters]
            chunks = -(-run.n_patches * v // run.patch_batch)
            stitch = 2 if v % 2 == 0 else 1
            expect(launches[0] == 2 * chunks + stitch == len(calls),
                  f"sliding window mesh [{key}]: K1 launched {launches[0]} times for {chunks} "
                  f"chunk(s) in 2 shards and {stitch} stitch shard(s)")
            out["mismatches"] += check_recorded(f"sliding window mesh [{key}]", calls)
            if name == "both":
                dw, tail = taps[0]
                tail_x, tail_layers, tail_emit = tail[0]
                specs = [(*layer["pw_w"].shape, int(layer["stride"])) for layer in tail_layers]
                k3_plan = plan_tail(tail_x.dtype, tuple(tail_x.shape), specs)
                expect(launches[1] == 2 * chunks and launches[2] == 2 * chunks * k3_plan.launches,
                      f"sliding window mesh [{key}]: K2 {launches[1]}, K3 {launches[2]} "
                      f"launches for {chunks} chunk(s) in 2 shards")
                out["dw_check"] = merge_dw_checks(out.get("dw_check"), compare_dw(
                    f"sliding window mesh [{key}], layer 3", *dw[0]))
                out["tail_check"] = merge_tail_checks(out.get("tail_check"), compare_tail_exact(
                    f"sliding window mesh [{key}], layers 4-7", tail_x, tail_layers, tail_emit))
            out["k1"][f"sliding window mesh {key}"] = launches[0]
            out["k2"][f"sliding window mesh {key}"] = launches[1]
            out["k3"][f"sliding window mesh {key}"] = launches[2]
            out["q1"][f"sliding window mesh {key}"] = launches[3]
            equal = all(torch.equal(det[k], ref[k]) for k in ref)
            score_diff = float((det["scores"] - ref["scores"]).abs().max())
            expect(equal, f"sliding window mesh [{key}]: detections differ from the unsharded "
                         f"detector's (largest score difference {score_diff:.3e}, counts "
                         f"{det['count'].tolist()} / {ref['count'].tolist()})")
            rates = {}
            iters = 10 if v == 1 else 4
            for label, fn in (("unsharded", plain_run), ("mesh", run), ("mesh", run),
                              ("unsharded", plain_run)):
                fn(state, x)["count"].cpu()
                t0 = time.perf_counter()
                for _ in range(iters):
                    res = fn(state, x)
                res["count"].cpu()
                rates.setdefault(label, []).append(v * iters / (time.perf_counter() - t0))
            out["timing"][f"sliding_window {key}"] = {"volumes_per_s": rates,
                                                      "launches": launches}
            log(f"sliding window mesh {mesh2} [{key}] {FULL_VOLUME}: patch batches of "
                f"{run.patch_batch} in 2 shards of {run.patch_batch // 2}, {chunks} chunk(s); "
                f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}; detections "
                f"equal to the unsharded detector's ({det['count'].tolist()}); volumes/s "
                f"{', '.join(f'{k} {[round(r, 2) for r in rs]}' for k, rs in rates.items())} "
                f"(host clock, in turns unsharded, mesh, mesh, unsharded) [{card}]")
        del state
    del volumes
    torch.cuda.empty_cache()
    # cli.predict -sw 1 --sw_data_parallel 1 on phase 4e's patch checkpoint
    single = tmp / "patch_preds" / "validation_set" / "min_score_0.0"
    with recorded_nms() as calls:
        for c in counters:
            c.launches = 0
        rc = predict_cli.main(["-d", str(full["patch_root"]), "-m", str(full["patch_last"]),
                               "-o", str(tmp / "patch_preds_dp"), *recipe.PREDICT_FLAGS,
                               "-sw", "1", "--sw_data_parallel", "1", "--device", "cuda"])
        launches = [c.launches for c in counters]
    sharded = tmp / "patch_preds_dp" / "validation_set" / "min_score_0.0"
    names = sorted(p.name for p in single.iterdir() if p.suffix in (".json", ".csv"))
    same = [(sharded / n).read_bytes() == (single / n).read_bytes() for n in names]
    out["mismatches"] += check_recorded("cli.predict -sw 1 --sw_data_parallel 1", calls)
    log(f"cli.predict -sw 1 --sw_data_parallel 1 over {torch.cuda.device_count()} visible "
        f"card(s): {sum(same)} of {len(names)} .json/.csv files byte-equal to phase 4e's run "
        f"without the flag; K1 {launches[0]} launches")
    expect(rc == 0 and names and all(same),
          "cli.predict --sw_data_parallel 1 wrote other files than the run without it")
    out["k1"]["cli.predict -sw 1 --sw_data_parallel 1"] = launches[0]
    out["q1"]["cli.predict -sw 1 --sw_data_parallel 1"] = launches[3]

    # (d) the ConvNet's dropout under a mesh: each rank draws the global
    # batch's mask, W times its own rows', at every dropout layer
    cfg = SSD3DConfig.create(**CONVNET)
    convnet = SSD3D(cfg).cuda().train()
    shapes = []
    handles = [mod.register_forward_hook(lambda mod, a, o: shapes.append(tuple(o.shape)))
               for mod in convnet.modules() if type(mod).__name__ == "ConvNormActBlock"]
    with torch.no_grad():
        convnet(train_batch(8, torch.Generator(device="cuda").manual_seed(4))["image"].to(
            cfg.compute_dtype), generator=torch.Generator(device="cuda").manual_seed(5))
    for handle in handles:
        handle.remove()
    g = torch.Generator(device="cuda").manual_seed(6)
    draw_ms = {}
    for w in DROPOUT_WORLDS:
        draw_ms[w] = cuda_ms(lambda: [torch.rand((s[0] * w, *s[1:]), generator=g, device="cuda")
                                      for s in shapes], iters=5)
    log(f"ConvNet dropout at 64^3, local batch 8: the masks of its {len(shapes)} dropout layers "
        f"({sum(math.prod(s) for s in shapes):,} elements at W = 1) take "
        f"{', '.join(f'{draw_ms[w]:.3f} ms at W = {w}' for w in DROPOUT_WORLDS)} a step on each "
        f"rank (CUDA events) [{card}]")
    out["timing"]["dropout_draw_ms"] = draw_ms
    del convnet
    torch.cuda.empty_cache()
    log(f"data-parallel phase {time.perf_counter() - t_phase:.1f} s")
    check(not failed, "phase 4g: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------- spatial sharding
# phase 4h: two gloo ranks sharing the card on a 1 x 2 data x spatial mesh
# (parallel.make_mesh_2d), MobileNet at full width in bf16. (a) The train
# step at BASELINE config #3's volume against the unsharded step on the same
# card: the losses, gradient norm, the whole gradient vector and the BN
# statistics within DP_RTOL (the slabs' convs may take other cuDNN
# algorithms than the whole volume's, and the sums run in another order:
# bf16 roundings, as in phase 4g); every leaf's norm within SP_LEAF_NORM of
# the unsharded step's wherever the leaf holds at least SP_LEAF_FLOOR of the
# vector's norm (a leaf counted once per spatial rank would be 2x). (b) The
# eval forward and eval step at batch 1 of the 96^3 headline: K2 on each
# rank's haloed slab of layer 3 (0 mismatches against its plain version),
# K3 past the cut (within its bound), K1 in the eval step (the plain NMS's
# detections), the locs and scores within DP_RTOL and the detections within
# DP_DET_ATOL of the unsharded detector's. (c) cli.train --spatial_shards 2
# on phase 4c's recipe cut to SP_RECIPE_STEPS steps (streaming, cuDNN
# deterministic), its validation loss within SP_VAL_RTOL (the JAX package's
# trainer test's) of the 1-rank streaming run's.
SP_TRAIN = dict(TRAIN, input_size=FULL_VOLUME)
SP_AUGMENT = dict(flip_axes=(0, 1, 2))
SP_BATCH = 2
SP_LEAF_NORM = 0.05
SP_LEAF_FLOOR = 1e-3
SP_RECIPE_STEPS = 4
SP_VAL_RTOL = 2e-4
SP_TIMEOUT_S = 900


@contextmanager
def recorded_k2_k3():
    """Every K2 and K3 call the model makes: K2's (input, weights, gamma,
    beta, output) and K3's (input, layers, emit, outputs), detached."""
    calls = {"k2": [], "k3": []}
    dw, tail = model_layers.fused_depthwise_bn_relu_cuda, model_mobilenet.fused_tail_cuda

    def k2(x, weights, gamma, beta, **kwargs):
        out = dw(x, weights, gamma, beta, **kwargs)
        calls["k2"].append((x.detach(), weights.detach(), gamma.detach(), beta.detach(),
                            out.detach()))
        return out

    def k3(x, layers, emit, **kwargs):
        outs = tail(x, layers, emit, **kwargs)
        calls["k3"].append((x.detach(), [_detached(layer) for layer in layers], tuple(emit),
                            [o.detach() for o in outs]))
        return outs

    model_layers.fused_depthwise_bn_relu_cuda, model_mobilenet.fused_tail_cuda = k2, k3
    try:
        yield calls
    finally:
        model_layers.fused_depthwise_bn_relu_cuda, model_mobilenet.fused_tail_cuda = dw, tail


def sp_train_step(mesh, counters, remat: bool = False) -> dict:
    """Phase 4h (a): one bf16 train step at config #3's volume (batch 2,
    flips), on this rank's rows under the mesh or unsharded, with or
    without ``remat``; its metrics, gradients, BN statistics, the memory it
    added at its peak, its launches and (without remat) ms a step."""
    config = SSD3DConfig.create(**SP_TRAIN, remat=remat)
    model, priors = SSD3D(config), model_priors(config)
    state = create_train_state(config, seed=0, device="cuda")
    batch = train_batch(SP_BATCH, torch.Generator(device="cuda").manual_seed(1),
                        size=FULL_VOLUME)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    step = make_train_step(config, model, priors, augment=AugmentConfig(**SP_AUGMENT),
                           mesh=mesh, return_grads=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    new, m = step(state, batch, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    out = {"peak_added": torch.cuda.max_memory_allocated() - before,
           "launches": [c.launches for c in counters],
           "metrics": {k: float(m[k]) for k in ("total_loss", "conf_loss", "loc_loss",
                                                "grad_norm", "n_positives")},
           "grads": {k: v.float().cpu() for k, v in m["grads"].items()},
           "batch_stats": {k: v.cpu() for k, v in new.batch_stats.items()}}
    if not remat:
        gen = torch.Generator(device="cuda").manual_seed(3)
        out["step_ms"], _ = step_rounds(step, new, batch, gen, iters=3, rounds=2)
    return out


def sp_eval(mesh, name: str, cal_state, counters) -> dict:
    """Phase 4h (b): the eval forward (``make_spatially_sharded_forward`` on
    the mesh) and the eval step at batch 1 of the 96^3 headline with the
    BN-calibrated weights, on the default path or with both flags; with the
    launches of each, K2's and K3's operands and outputs, and the eval
    step's locs and scores."""
    config = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
    model = SSD3D(config)
    model.load_state_dict(cal_state)
    model.cuda()
    priors = model_priors(config)
    state = create_train_state(config, device="cuda", state_dict=cal_state)
    batch = train_batch(1, torch.Generator(device="cuda").manual_seed(5),
                        size=HEADLINE["input_size"])
    step = make_eval_step(config, model, priors, mesh=mesh)
    forward = (make_spatially_sharded_forward(model, mesh) if mesh is not None else
               lambda x: model.eval()(x))
    out = {}
    with recorded_k2_k3() as calls, tapped(model) as outs, torch.no_grad():
        for c in counters:
            c.launches = 0
        locs, scores = forward(batch["image"])
        torch.cuda.synchronize()
        out["forward_launches"] = [c.launches for c in counters]
        for c in counters:
            c.launches = 0
        ev = step(state, batch)
        torch.cuda.synchronize()
        out["step_launches"] = [c.launches for c in counters]
    out.update(locs=locs.float().cpu(), scores=scores.float().cpu(),
               detections={k: v.cpu() for k, v in ev["detections"].items()},
               step_locs_scores=[t.cpu() for t in outs[-1]], calls=calls,
               loss=float(ev["total_loss"]))
    return out


def sp_rank(rank: int, port: int, tmp: str) -> None:
    """Rank ``rank`` of two gloo ranks sharing the card on a 1 x 2 data x
    spatial mesh (phase 4h): (a), (b) and (c) on its rows of the batches; its
    kernels held against their plain versions on the operands it gave them;
    saves what it computed."""
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0",
                         timeout_s=SP_TIMEOUT_S)
    mesh = make_mesh_2d(1, 2, device="cuda:0")
    inputs = torch.load(tmp / "sp_inputs.pt", weights_only=False)
    counters = (greedy_nms_cuda, fused_depthwise_bn_relu_cuda, fused_tail_cuda)
    out = {"mesh": mesh.describe(), "train": sp_train_step(mesh, counters), "eval": {}}
    torch.cuda.empty_cache()
    out["train_remat"] = sp_train_step(mesh, counters, remat=True)
    torch.cuda.empty_cache()
    for name in ("off", "both"):
        ev = sp_eval(mesh, name, inputs["cal_state"], counters)
        config = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
        priors = torch.from_numpy(model_priors(config)).cuda()
        check_plain_detections(f"spatial rank {rank}, eval step [{name}]",
                               {k: v.cuda() for k, v in ev["detections"].items()},
                               *(t.cuda() for t in ev["step_locs_scores"]), priors, config)
        calls = ev.pop("calls")
        if name == "both":  # K2 and K3 on this rank's operands, against their plain versions
            x, w, gamma, beta, k2_out = calls["k2"][0]
            ev["dw_check"] = compare_dw(f"spatial rank {rank}, layer 3's haloed slab", x, w,
                                        gamma, beta)
            ev["k2_input"] = tuple(x.shape)
            ev["k2_planes"] = k2_out[:, :, 1:-1].cpu()
            tail_x, tail_layers, emit, maps = calls["k3"][0]
            ev["tail_check"] = compare_tail_exact(f"spatial rank {rank}, the tail past the cut",
                                                  tail_x, tail_layers, emit)
            ev["k3_input"] = tuple(tail_x.shape)
            ev["k3_maps"] = [m.cpu() for m in maps]
        out["eval"][name] = ev
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    result = train_cli.main([*inputs["recipe_args"], "-en", "spatial", "--spatial_shards", "2"])
    out["trainer"] = {"launches": [c.launches for c in counters],
                      "losses": [v for e in result["timings"]["epochs"]
                                 for v in e["train_losses"]],
                      "val": [h["avg_val_loss"] for h in result["history"]],
                      "ms_per_step": [e["train_s"] / e["steps"] * 1e3
                                      for e in result["timings"]["epochs"]],
                      "fit_s": time.perf_counter() - t0}
    torch.save(out, tmp / f"sp_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def drive_spatial(card, counters, tmp: Path, entry: dict, cal_state) -> dict:
    """Phase 4h: spatial sharding on the one card, two gloo ranks on a 1 x 2
    mesh (``sp_rank``) against the unsharded step, forward, eval step and
    trainer run on the same card."""
    t_phase = time.perf_counter()
    out = {"k1": {}, "k2": {}, "k3": {}, "timing": {}}
    failed = []

    def expect(cond, message: str) -> None:
        if not cond:
            log(f"CHECK FAILED: {message}")
            failed.append(message)

    # the unsharded references on this card, before the ranks start
    ref_train = sp_train_step(None, counters)
    torch.cuda.empty_cache()
    ref_eval = {name: sp_eval(None, name, cal_state, counters) for name in ("off", "both")}
    recipe_args = ["-d", str(entry["root"]), *recipe.TRAIN_FLAGS, "-mi", str(SP_RECIPE_STEPS),
                   "-ld", str(tmp / "sp_logs"), "--device", "cuda", "--device_data_cache", "0"]
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    ref_fit = train_cli.main([*recipe_args, "-en", "plain"])
    ref_fit_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    torch.save({"cal_state": {k: v.cpu() for k, v in cal_state.items()},
                "recipe_args": recipe_args}, tmp / "sp_inputs.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = ranks_on_one_card(tmp, sp_rank, SP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0

    # (a) the train step at config #3's volume
    names = list(ref_train["grads"])
    g1 = torch.cat([ref_train["grads"][n].ravel() for n in names])
    whole = float(g1.norm())

    def against_unsharded(key):
        """(relative differences of the metrics, of the gradient vector,
        every (leaf, rank) norm ratio, the worst counted leaf's distance
        from 1, the BN statistics') of the ranks' ``key`` step."""
        rel = {k: max(abs(r[key]["metrics"][k] - ref_train["metrics"][k])
                      / abs(ref_train["metrics"][k]) for r in ranks)
               for k in ("total_loss", "conf_loss", "loc_loss", "grad_norm")}
        grads_rel = max(float((torch.cat([r[key]["grads"][n].ravel() for n in names]) - g1)
                              .norm() / g1.norm()) for r in ranks)
        ratios = {n: [float(r[key]["grads"][n].norm() / ref_train["grads"][n].norm())
                      for r in ranks] for n in names if float(ref_train["grads"][n].norm()) > 0}
        worst = max(abs(v - 1.0) for n, vs in ratios.items() for v in vs
                    if float(ref_train["grads"][n].norm()) >= SP_LEAF_FLOOR * whole)
        stats = max(float((r[key]["batch_stats"][n] - s).abs().max()
                          / s.abs().max().clamp(min=1e-12))
                    for r in ranks for n, s in ref_train["batch_stats"].items())
        return rel, grads_rel, [v for vs in ratios.values() for v in vs], worst, stats

    rel, grads_rel, all_ratios, worst_leaf, stats_rel = against_unsharded("train")
    counted = [n for n in names if float(ref_train["grads"][n].norm()) >= SP_LEAF_FLOOR * whole]
    peaks = [r["train"]["peak_added"] for r in ranks]
    log(f"spatial sharding, two gloo ranks sharing the card ({ranks[0]['mesh']}; spawned and "
        f"joined in {ranks_s:.1f} s): the bf16 train step at {SP_BATCH} x {FULL_VOLUME} with "
        f"flips against the unsharded step: relative differences "
        f"{', '.join(f'{k} {v:.2e}' for k, v in rel.items())}, the gradient vector "
        f"{grads_rel:.2e}, BN statistics {stats_rel:.2e} (bound {DP_RTOL} each); leaf norm "
        f"ratios over {len(all_ratios)} (leaf, rank) pairs from {min(all_ratios):.4f} to "
        f"{max(all_ratios):.4f}, at most {worst_leaf:.4f} from 1 over the {len(counted)} leaves "
        f"holding >= {SP_LEAF_FLOOR} of the vector's norm (bound {SP_LEAF_NORM}) [{card}]")
    log(f"  memory the step added at its peak: ranks {[round(p / 2**30, 3) for p in peaks]} GiB, "
        f"unsharded {ref_train['peak_added'] / 2**30:.3f} GiB (ratio "
        f"{[round(p / ref_train['peak_added'], 3) for p in peaks]}); ms a step (CUDA events, 3 "
        f"steps a round): ranks {[[round(v, 2) for v in r['train']['step_ms']] for r in ranks]} "
        f"(both ranks on one card at once, halos through host memory), unsharded "
        f"{[round(v, 2) for v in ref_train['step_ms']]}; launches K1-K3 per rank "
        f"{[r['train']['launches'] for r in ranks]} [{card}]")
    expect(max(rel.values()) <= DP_RTOL and grads_rel <= DP_RTOL and stats_rel <= DP_RTOL,
           "the spatially sharded train step disagrees with the unsharded step")
    expect(worst_leaf <= SP_LEAF_NORM, f"a gradient leaf's norm is {worst_leaf:.3f} from the "
                                       "unsharded step's")
    r_rel, r_grads, r_ratios, r_worst, r_stats = against_unsharded("train_remat")
    r_peaks = [r["train_remat"]["peak_added"] for r in ranks]
    log(f"  with remat, against the unsharded step without it: relative differences "
        f"{', '.join(f'{k} {v:.2e}' for k, v in r_rel.items())}, the gradient vector "
        f"{r_grads:.2e}, BN statistics {r_stats:.2e} (bound {DP_RTOL} each); leaf norm ratios "
        f"{min(r_ratios):.4f} to {max(r_ratios):.4f}, counted leaves at most {r_worst:.4f} "
        f"from 1 (bound {SP_LEAF_NORM}); peak {[round(p / 2**30, 3) for p in r_peaks]} GiB a "
        f"rank [{card}]")
    expect(max(r_rel.values()) <= DP_RTOL and r_grads <= DP_RTOL and r_stats <= DP_RTOL
           and r_worst <= SP_LEAF_NORM,
           "the spatially sharded train step with remat disagrees with the unsharded step")
    out["timing"]["train_step"] = {
        "relative": rel, "grads_rel": grads_rel, "stats_rel": stats_rel,
        "leaf_norm_ratio_range": [min(all_ratios), max(all_ratios)],
        "worst_counted_leaf": worst_leaf, "peak_added_bytes": peaks,
        "peak_added_bytes_unsharded": ref_train["peak_added"],
        "remat": {"relative": r_rel, "grads_rel": r_grads, "stats_rel": r_stats,
                  "worst_counted_leaf": r_worst, "peak_added_bytes": r_peaks},
        "step_ms": [r["train"]["step_ms"] for r in ranks],
        "step_ms_unsharded": ref_train["step_ms"]}

    # (b) the eval forward and eval step at batch 1 of the headline
    for name in ("off", "both"):
        ref = ref_eval[name]
        evs = [r["eval"][name] for r in ranks]
        fwd_rel = max(float((e[t] - ref[t]).norm() / ref[t].norm())
                      for e in evs for t in ("locs", "scores"))
        det1 = ref["detections"]
        dists = [torch.cat([match_detections(e["detections"], det1),
                            match_detections(det1, e["detections"])]) for e in evs]
        dist = torch.cat(dists)
        counts_equal = all(torch.equal(e["detections"]["count"], det1["count"]) for e in evs)
        log(f"spatial eval [{name}] at batch 1, {HEADLINE['input_size']}: locs and scores "
            f"against the unsharded forward {fwd_rel:.2e} (relative, bound {DP_RTOL}); eval "
            f"step detections {[e['detections']['count'].tolist() for e in evs]} (unsharded "
            f"{det1['count'].tolist()}), largest distance to the nearest of the same label "
            f"{float(dist.max()) if dist.numel() else 0.0:.3e} (bound {DP_DET_ATOL}); launches "
            f"K1-K3 per rank, forward {[e['forward_launches'] for e in evs]}, eval step "
            f"{[e['step_launches'] for e in evs]} [{card}]")
        expect(fwd_rel <= DP_RTOL, f"spatial eval [{name}]: locs/scores off by {fwd_rel:.2e}")
        expect(counts_equal and bool((dist <= DP_DET_ATOL).all()),
               f"spatial eval [{name}]: detections differ from the unsharded detector's")
        want = [0, 1, 1] if name == "both" else [0, 0, 0]
        expect(all(e["forward_launches"] == want and e["step_launches"] == [1, *want[1:]]
                   for e in evs),
               f"spatial eval [{name}]: launches {[e['forward_launches'] for e in evs]}, "
               f"{[e['step_launches'] for e in evs]} (want {want} a forward and K1 once a step)")
        out["k1"][f"spatial eval step [{name}] (per rank)"] = [e["step_launches"][0] for e in evs]
        out["k2"][f"spatial eval forward + step [{name}] (per rank)"] = [
            e["forward_launches"][1] + e["step_launches"][1] for e in evs]
        out["k3"][f"spatial eval forward + step [{name}] (per rank)"] = [
            e["forward_launches"][2] + e["step_launches"][2] for e in evs]
        out["timing"][f"eval {name}"] = {"forward_rel": fwd_rel,
                                         "detections_max_dist": float(dist.max())
                                         if dist.numel() else 0.0}
        if name == "both":
            _, _, _, _, k2_ref = ref["calls"]["k2"][0]
            _, _, _, maps_ref = ref["calls"]["k3"][0]
            depth = k2_ref.shape[2] // 2
            k2_diff = [int((e["k2_planes"] != k2_ref[:, :, s * depth:(s + 1) * depth].cpu())
                           .sum()) for s, e in enumerate(evs)]
            k2_err = max(float((e["k2_planes"].float() - k2_ref[:, :, s * depth:(s + 1) * depth]
                                .cpu().float()).abs().max()) for s, e in enumerate(evs))
            k3_err = max(float((a.float() - b.cpu().float()).abs().max() / b.float().abs().max())
                         for e in evs for a, b in zip(e["k3_maps"], maps_ref))
            log(f"  K2 on the haloed slab: inputs {[e['k2_input'] for e in evs]} (unsharded "
                f"{tuple(ref['calls']['k2'][0][0].shape)}), its middle planes against the "
                f"unsharded K2's: {k2_diff} differing elements, max abs {k2_err:.3e}; K3 past "
                f"the cut: inputs {[e['k3_input'] for e in evs]}, its maps against the "
                f"unsharded K3's, largest difference {k3_err:.3e} of the map's largest [{card}]")
            out["dw_check"] = (sum(e["dw_check"][0] for e in evs),
                               max(e["dw_check"][1] for e in evs))
            out["tail_check"] = (max(e["tail_check"][0] for e in evs),
                                 [v for e in evs for v in e["tail_check"][1]])
            out["timing"]["k2_slab_vs_whole"] = {"differing": k2_diff, "max_abs": k2_err}
            out["timing"]["k3_maps_rel"] = k3_err
            expect(all(e["k2_input"][2] == depth + 2 for e in evs),
                   "K2 did not take the haloed slab (planes + 2)")

    # (c) cli.train --spatial_shards 2 against the 1-rank streaming run
    ref_losses = [v for e in ref_fit["timings"]["epochs"] for v in e["train_losses"]]
    ref_val = [h["avg_val_loss"] for h in ref_fit["history"]]
    loss_rel = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["trainer"]["losses"], ref_losses))
    val_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["trainer"]["val"], ref_val))
    log(f"cli.train --spatial_shards 2 (the recipe, {SP_RECIPE_STEPS} steps, streaming, cuDNN "
        f"deterministic) against the 1-rank run: training losses within {loss_rel:.2e} "
        f"(relative), avg_val_loss {[r['trainer']['val'] for r in ranks]} / {ref_val} "
        f"({val_rel:.2e}, bound {SP_VAL_RTOL}); trainer ms per step "
        f"{[[round(v, 1) for v in r['trainer']['ms_per_step']] for r in ranks]} / "
        f"{[round(e['train_s'] / e['steps'] * 1e3, 1) for e in ref_fit['timings']['epochs']]}; "
        f"cli.train {ranks[0]['trainer']['fit_s']:.1f} / {ref_fit_s:.1f} s [{card}]")
    expect(len(ranks[0]["trainer"]["val"]) == len(ref_val) > 0 and val_rel <= SP_VAL_RTOL,
           f"cli.train --spatial_shards 2: avg_val_loss {val_rel:.2e} from the 1-rank run's")
    out["timing"]["trainer"] = {"losses_rel": loss_rel, "val_rel": val_rel,
                                "ms_per_step": [r["trainer"]["ms_per_step"] for r in ranks],
                                "fit_s": ranks[0]["trainer"]["fit_s"], "fit_s_1_rank": ref_fit_s}
    out["k1"]["cli.train --spatial_shards 2 (per rank)"] = [r["trainer"]["launches"][0]
                                                             for r in ranks]
    expect(all(r["trainer"]["launches"][0] > 0 for r in ranks),
           "cli.train --spatial_shards 2 launched no K1 on a rank")
    log(f"spatial phase {time.perf_counter() - t_phase:.1f} s")
    check(not failed, "phase 4h: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------- tensor parallelism
# phase 4i: gloo ranks sharing the card on a data x spatial x model mesh
# (parallel.make_mesh_3d), MobileNet at full width in bf16. (a) Two ranks on
# a 1 x 1 x 2 mesh: the headline forward (make_tensor_parallel_forward) and
# eval step at batch TP_BATCH with its BN calibrated, default path and both
# flags, against the unsharded model on the same card: locs and scores
# within DP_RTOL (relative Frobenius: a conv of half the output channels may
# take another cuDNN algorithm, a bf16 rounding), detection counts equal and
# each within DP_DET_ATOL of the unsharded detector's; K2 once a forward a
# rank on its 64 channels of layer 3 (0 mismatches against its plain
# version; its channels against the unsharded K2's), K3 once a forward a
# rank on the gathered 128 channels (within its bound; its maps against the
# unsharded K3's), K1 once an eval step (equal to the plain NMS); each
# rank's parameter bytes and the memory a forward adds at its peak. (b) Four
# ranks on a 1 x 2 x 2 mesh: the train step at 64^3, global batch
# TP_TRAIN_BATCH, flips, against the unsharded step. In bf16: the losses,
# gradient norm, the gradient vector (joined over the model group) and the
# BN statistics (all leaves as one vector) within DP_RTOL relative, every
# leaf holding at least SP_LEAF_FLOOR of the vector's norm within
# SP_LEAF_NORM of its norm; each rank's peak and ms a step. A pointwise conv
# of half the output channels may take another cuDNN algorithm than the
# whole one's, so bf16 activations round apart, and a deep BN's mean over 16
# values a channel moves by up to 2% of its largest (a card run: 1.7e-2 at
# layer 7, 1.1e-4 over all leaves). The same step in float32 (TF32 off)
# shows the arithmetic is the unsharded step's: the losses, gradient norm
# and gradient vector within TP_F32_RTOL, every BN statistic leaf within
# TP_F32_RTOL of its largest, counted leaves within TP_F32_LEAF. (c) The
# native NIfTI loader against its plain version (the Python decode and
# normalisation) on phase 4c's 40 volumes: the loads alone and materialize,
# each in turns, and the arrays against each other.
TP_BATCH = 8
TP_TRAIN_BATCH = 2
TP_AUGMENT = dict(flip_axes=(0, 1, 2))
TP_TIMEOUT_S = 600
TP_F32_RTOL = 1e-5
TP_F32_LEAF = 1e-4


def tp_eval(mesh, name: str, cal_state, counters) -> dict:
    """Phase 4i (a): the forward (``make_tensor_parallel_forward`` on the
    mesh, or the unsharded model) and the eval step at batch TP_BATCH of the
    96^3 headline with the BN-calibrated weights, on the default path or
    with both flags: the launches of each, K2's and K3's operands and
    outputs, the eval step's locs and scores, the parameter bytes, the
    memory the forward added at its peak and its ms a call."""
    config = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
    model, priors = SSD3D(config), model_priors(config)
    state = create_train_state(config, device="cuda", state_dict=cal_state)
    batch = train_batch(TP_BATCH, torch.Generator(device="cuda").manual_seed(6),
                        size=HEADLINE["input_size"])
    if mesh is None:
        model.load_state_dict(cal_state)
        model.cuda().eval()
        served = dict(model.named_parameters())

        def forward(x):
            return model(x)
    else:
        state = shard_tree(state, mesh)
        run = make_tensor_parallel_forward(model, mesh)
        served = {k: v for k, v in run.place_variables(cal_state).items()
                  if k in dict(model.named_parameters())}

        def forward(x):
            return run(cal_state, x)
    step = make_eval_step(config, model, priors, mesh=mesh)
    out = {"param_bytes": sum(p.numel() * p.element_size() for p in served.values())}
    with recorded_k2_k3() as calls, tapped(model) as outs, torch.no_grad():
        forward(batch["image"])  # warm: the kernels' plans and cuDNN's algorithms
        calls["k2"].clear()
        calls["k3"].clear()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        locs, scores = forward(batch["image"])
        torch.cuda.synchronize()
        out["forward_launches"] = [c.launches for c in counters]
        out["peak_added"] = torch.cuda.max_memory_allocated() - before
        for c in counters:
            c.launches = 0
        ev = step(state, batch)
        torch.cuda.synchronize()
        out["step_launches"] = [c.launches for c in counters]
        k2_k3 = {k: list(v) for k, v in calls.items()}
        out["forward_ms"] = cuda_ms(partial(forward, batch["image"]), iters=3, warmup=1)
    out.update(locs=locs.float().cpu(), scores=scores.float().cpu(),
               detections={k: v.cpu() for k, v in ev["detections"].items()},
               step_locs_scores=[t.cpu() for t in outs[-1]], calls=k2_k3)
    return out


def tp_train_step(mesh, counters, dtype: str = "bfloat16") -> dict:
    """Phase 4i (b): one train step at 64^3 (global batch TP_TRAIN_BATCH,
    flips, in ``dtype``) on this rank's slices of the state and rows of the
    batch, or unsharded: its metrics, the whole gradients and BN statistics,
    the memory it added at its peak, its launches; in bf16 ms a step."""
    config = SSD3DConfig.create(**dict(TRAIN, dtype=dtype))
    model, priors = SSD3D(config), model_priors(config)
    state = create_train_state(config, seed=0, device="cuda")
    batch = train_batch(TP_TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(1))
    specs = None
    if mesh is not None:
        specs = tensor_sharding(state, mesh)
        state, batch = shard_tree(state, mesh), shard_batch(batch, mesh)
    step = make_train_step(config, model, priors, augment=AugmentConfig(**TP_AUGMENT),
                           mesh=mesh, return_grads=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    new, m = step(state, batch, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    out = {"peak_added": torch.cuda.max_memory_allocated() - before,
           "launches": [c.launches for c in counters],
           "metrics": {k: float(m[k]) for k in ("total_loss", "conf_loss", "loc_loss",
                                                "grad_norm", "n_positives")}}
    grads, stats = m["grads"], new.batch_stats
    if mesh is not None:
        grads = unshard_tree(grads, mesh, specs.params)
        stats = unshard_tree(stats, mesh, specs.batch_stats)
    out["grads"] = {k: v.float().cpu() for k, v in grads.items()}
    out["batch_stats"] = {k: v.cpu() for k, v in stats.items()}
    if dtype == "bfloat16":
        out["step_ms"], _ = step_rounds(step, new, batch,
                                        torch.Generator(device="cuda").manual_seed(3),
                                        iters=3, rounds=2)
    return out


def _tp_join(rank: int, world: int, port: int):
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda:0",
                         timeout_s=TP_TIMEOUT_S)


def tp_forward_rank(rank: int, port: int, tmp: str) -> None:
    """Rank ``rank`` of two gloo ranks sharing the card on a 1 x 1 x 2 data
    x spatial x model mesh (phase 4i (a)): the forward and eval step on
    each path; its K2 and K3 held against their plain versions on the
    operands it gave them; saves what it computed."""
    tmp = Path(tmp)
    _tp_join(rank, 2, port)
    mesh = make_mesh_3d(1, 1, 2, device="cuda:0")
    cal_state = {k: v.cuda() for k, v in torch.load(tmp / "tp_inputs.pt")["cal_state"].items()}
    counters = (greedy_nms_cuda, fused_depthwise_bn_relu_cuda, fused_tail_cuda)
    out = {"mesh": mesh.describe(), "eval": {}}
    for name in ("off", "both"):
        ev = tp_eval(mesh, name, cal_state, counters)
        config = SSD3DConfig.create(**HEADLINE, **FLAG_SETTINGS[name])
        priors = torch.from_numpy(model_priors(config)).cuda()
        check_plain_detections(f"tensor-parallel rank {rank}, eval step [{name}]",
                               {k: v.cuda() for k, v in ev["detections"].items()},
                               *(t.cuda() for t in ev["step_locs_scores"]), priors, config)
        calls = ev.pop("calls")
        if name == "both":  # K2 and K3 on this rank's operands, against their plain versions
            x, w, gamma, beta, k2_out = calls["k2"][0]
            ev["dw_check"] = compare_dw(f"tensor-parallel rank {rank}, layer 3's channel slice",
                                        x, w, gamma, beta)
            ev["k2_input"], ev["k2_out"] = tuple(x.shape), k2_out.cpu()
            tail_x, tail_layers, emit, maps = calls["k3"][0]
            ev["tail_check"] = compare_tail_exact(
                f"tensor-parallel rank {rank}, the tail on the gathered channels", tail_x,
                tail_layers, emit)
            ev["k3_input"], ev["k3_maps"] = tuple(tail_x.shape), [m.cpu() for m in maps]
        out["eval"][name] = ev
    torch.save(out, tmp / f"tp_forward_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def tp_train_rank(rank: int, port: int, tmp: str) -> None:
    """Rank ``rank`` of four gloo ranks sharing the card on a 1 x 2 x 2
    mesh (phase 4i (b)): the train step; saves what it computed."""
    _tp_join(rank, 4, port)
    mesh = make_mesh_3d(1, 2, 2, device="cuda:0")
    counters = (greedy_nms_cuda, fused_depthwise_bn_relu_cuda, fused_tail_cuda)
    out = {"mesh": mesh.describe(), "train": tp_train_step(mesh, counters),
           "train_f32": tp_train_step(mesh, counters, "float32")}
    torch.save(out, Path(tmp) / f"tp_train_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def native_sample(dm, subject):
    """The native loads of a subject's image (normalised) and segmentation."""
    return (load_nifti_fast(dm.data_dir / "images" / f"sub-{subject}_image.nii.gz",
                            normalize=True),
            load_nifti_fast(dm.data_dir / "labels" / f"sub-{subject}_seg.nii.gz"))


class PythonLoaderModule(SyntheticDataModule):
    """``SyntheticDataModule`` on the native loader's plain version: the
    Python NIfTI decode and ``t_normalize_intensity``, then the host boxes."""

    def _load_sample(self, subject, boxes: bool = True):
        img = load_nifti(self.data_dir / "images" / f"sub-{subject}_image.nii.gz")
        seg = load_nifti(self.data_dir / "labels" / f"sub-{subject}_seg.nii.gz")
        sample = t_normalize_intensity({"img": img.data.astype(np.float32), "seg": seg.data,
                                        "affine": img.affine, "subject": subject}, nonzero=True)
        if boxes:
            sample["boxes"], sample["labels"] = boxes_from_segmentation(
                sample["seg"], "classes", n_classes=self.n_classes)
        return sample


def drive_tensor(card, counters, tmp: Path, cal_state) -> dict:
    """Phase 4i: tensor parallelism on the one card, gloo ranks on a 1 x 1 x 2
    and a 1 x 2 x 2 mesh against the unsharded forward, eval step and train
    step on the same card; the native loader against its plain version on
    phase 4c's dataset, generated again into ``tmp``."""
    t_phase = time.perf_counter()
    out = {"k1": {}, "k2": {}, "k3": {}, "timing": {}}
    failed = []

    def expect(cond, message: str) -> None:
        if not cond:
            log(f"CHECK FAILED: {message}")
            failed.append(message)

    # the unsharded references on this card, before the ranks start
    ref_eval = {name: tp_eval(None, name, cal_state, counters) for name in ("off", "both")}
    ref_train = tp_train_step(None, counters)
    ref_train_f32 = tp_train_step(None, counters, "float32")
    torch.save({"cal_state": {k: v.cpu() for k, v in cal_state.items()}}, tmp / "tp_inputs.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fwd_ranks = ranks_on_one_card(tmp, tp_forward_rank, TP_TIMEOUT_S, nprocs=2)
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_ranks = ranks_on_one_card(tmp, tp_train_rank, TP_TIMEOUT_S, nprocs=4)
    train_s = time.perf_counter() - t0

    # (a) the forward and the eval step at batch TP_BATCH of the headline
    for name in ("off", "both"):
        ref = ref_eval[name]
        evs = [r["eval"][name] for r in fwd_ranks]
        fwd_rel = max(float((e[t] - ref[t]).norm() / ref[t].norm())
                      for e in evs for t in ("locs", "scores"))
        det1 = ref["detections"]
        dist = torch.cat([torch.cat([match_detections(e["detections"], det1),
                                     match_detections(det1, e["detections"])]) for e in evs])
        counts_equal = all(torch.equal(e["detections"]["count"], det1["count"]) for e in evs)
        worst = float(dist.max()) if dist.numel() else 0.0
        log(f"tensor parallel [{name}], two gloo ranks sharing the card ({fwd_ranks[0]['mesh']}; "
            f"spawned and joined in {fwd_s:.1f} s): the headline forward at batch {TP_BATCH}, "
            f"{HEADLINE['input_size']}: locs and scores against the unsharded forward "
            f"{fwd_rel:.2e} (relative, bound {DP_RTOL}); eval step detections "
            f"{[int(e['detections']['count'].sum()) for e in evs]} (unsharded "
            f"{int(det1['count'].sum())}), counts equal {counts_equal}, largest distance to the "
            f"nearest of the same label {worst:.3e} (bound {DP_DET_ATOL}); launches K1-K3 per "
            f"rank, forward {[e['forward_launches'] for e in evs]}, eval step "
            f"{[e['step_launches'] for e in evs]} [{card}]")
        ratios = [round(e["param_bytes"] / ref["param_bytes"], 4) for e in evs]
        log(f"  parameter bytes a rank {[e['param_bytes'] for e in evs]}, unsharded "
            f"{ref['param_bytes']} (ratio {ratios}); "
            f"memory a forward added at its peak: ranks "
            f"{[round(e['peak_added'] / 2**30, 3) for e in evs]} GiB, unsharded "
            f"{ref['peak_added'] / 2**30:.3f} GiB; ms a forward (CUDA events, 3 calls) "
            f"ranks {[round(e['forward_ms'], 2) for e in evs]} (both ranks on one card, the "
            f"channel gathers through host memory), unsharded {ref['forward_ms']:.2f} [{card}]")
        expect(fwd_rel <= DP_RTOL, f"tensor parallel [{name}]: locs/scores off by {fwd_rel:.2e}")
        expect(counts_equal and worst <= DP_DET_ATOL,
               f"tensor parallel [{name}]: detections differ from the unsharded detector's")
        want = [0, 1, 1] if name == "both" else [0, 0, 0]
        expect(all(e["forward_launches"] == want and e["step_launches"] == [1, *want[1:]]
                   for e in evs),
               f"tensor parallel [{name}]: launches {[e['forward_launches'] for e in evs]}, "
               f"{[e['step_launches'] for e in evs]} (want {want} a forward and K1 once a step)")
        out["k1"][f"tensor-parallel eval step [{name}] (per rank)"] = [e["step_launches"][0]
                                                                       for e in evs]
        out["k2"][f"tensor-parallel forward + eval step [{name}] (per rank)"] = [
            e["forward_launches"][1] + e["step_launches"][1] for e in evs]
        out["k3"][f"tensor-parallel forward + eval step [{name}] (per rank)"] = [
            e["forward_launches"][2] + e["step_launches"][2] for e in evs]
        out["timing"][f"eval {name}"] = {
            "forward_rel": fwd_rel, "detections_max_dist": worst,
            "param_bytes": [e["param_bytes"] for e in evs],
            "param_bytes_unsharded": ref["param_bytes"],
            "peak_added_bytes": [e["peak_added"] for e in evs],
            "peak_added_bytes_unsharded": ref["peak_added"],
            "forward_ms": [e["forward_ms"] for e in evs], "forward_ms_unsharded": ref["forward_ms"]}
        if name == "both":
            k2_ref = ref["calls"]["k2"][0][4].cpu()
            maps_ref = ref["calls"]["k3"][0][3]
            c = k2_ref.shape[1] // 2
            k2_diff = [int((e["k2_out"] != k2_ref[:, m * c:(m + 1) * c]).sum())
                       for m, e in enumerate(evs)]
            k2_err = max(float((e["k2_out"].float() - k2_ref[:, m * c:(m + 1) * c].float())
                               .abs().max()) for m, e in enumerate(evs))
            k3_err = max(float((a.float() - b.cpu().float()).abs().max() / b.float().abs().max())
                         for e in evs for a, b in zip(e["k3_maps"], maps_ref))
            log(f"  K2 on the channel slice: inputs {[e['k2_input'] for e in evs]} (unsharded "
                f"{tuple(ref['calls']['k2'][0][0].shape)}), its channels against the unsharded "
                f"K2's: {k2_diff} differing elements, max abs {k2_err:.3e}; K3 on the gathered "
                f"channels: inputs {[e['k3_input'] for e in evs]}, its maps against the "
                f"unsharded K3's, largest difference {k3_err:.3e} of the map's largest [{card}]")
            out["dw_check"] = (sum(e["dw_check"][0] for e in evs),
                               max(e["dw_check"][1] for e in evs))
            out["tail_check"] = (max(e["tail_check"][0] for e in evs),
                                 [v for e in evs for v in e["tail_check"][1]])
            out["timing"]["k2_slice_vs_whole"] = {"differing": k2_diff, "max_abs": k2_err}
            out["timing"]["k3_maps_rel"] = k3_err
            expect(all(e["k2_input"][1] == c for e in evs),
                   f"K2 did not take a {c}-channel slice of layer 3")
            expect(all(e["k3_input"][1] == 2 * c for e in evs),
                   "K3 did not take the gathered channels")

    # (b) the train step on a 1 x 2 x 2 mesh, in bf16 and in float32
    def against_unsharded(key, ref):
        """(relative differences of the metrics, of the gradient vector, the
        worst counted leaf's norm from the unsharded one's, the BN statistics
        as one vector, the worst BN statistic leaf, the leaves counted) of the
        ranks' ``key`` step."""
        names = list(ref["grads"])
        g1 = torch.cat([ref["grads"][n].ravel() for n in names])
        counted = [n for n in names if float(ref["grads"][n].norm()) >= SP_LEAF_FLOOR * g1.norm()]
        runs = [r[key] for r in train_ranks]
        rel = {k: max(abs(r["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
                      for r in runs) for k in ("total_loss", "conf_loss", "loc_loss", "grad_norm")}
        grads_rel = max(float((torch.cat([r["grads"][n].ravel() for n in names]) - g1).norm()
                              / g1.norm()) for r in runs)
        leaf = max(abs(float(r["grads"][n].norm() / ref["grads"][n].norm()) - 1)
                   for r in runs for n in counted)
        s1 = torch.cat([v.ravel() for v in ref["batch_stats"].values()])
        stats_all = max(float((torch.cat([r["batch_stats"][n].ravel() for n in ref["batch_stats"]])
                               - s1).norm() / s1.norm()) for r in runs)
        stats_leaf = max(float((r["batch_stats"][n] - v).abs().max()
                               / v.abs().max().clamp(min=1e-12))
                         for r in runs for n, v in ref["batch_stats"].items())
        return rel, grads_rel, leaf, stats_all, stats_leaf, len(counted)

    rel, grads_rel, worst_leaf, stats_rel, stats_leaf, n_counted = against_unsharded(
        "train", ref_train)
    f_rel, f_grads, f_leaf, _, f_stats_leaf, _ = against_unsharded("train_f32", ref_train_f32)
    peaks = [r["train"]["peak_added"] for r in train_ranks]
    log(f"tensor parallel, four gloo ranks sharing the card ({train_ranks[0]['mesh']}; spawned "
        f"and joined in {train_s:.1f} s): the bf16 train step at {TP_TRAIN_BATCH} x "
        f"{TRAIN['input_size']} with flips against the unsharded step: relative differences "
        f"{', '.join(f'{k} {v:.2e}' for k, v in rel.items())}, the gradient vector "
        f"{grads_rel:.2e}, BN statistics {stats_rel:.2e} (bound {DP_RTOL} each; the worst BN "
        f"leaf {stats_leaf:.2e} of its largest); the {n_counted} leaves holding >= "
        f"{SP_LEAF_FLOOR} of the vector's norm within {worst_leaf:.4f} of their norm (bound "
        f"{SP_LEAF_NORM}) [{card}]")
    log(f"  the same step in float32: relative differences "
        f"{', '.join(f'{k} {v:.2e}' for k, v in f_rel.items())}, the gradient vector "
        f"{f_grads:.2e} (bound {TP_F32_RTOL} each), the worst BN statistic leaf "
        f"{f_stats_leaf:.2e} of its largest (bound {TP_F32_RTOL}), counted leaves within "
        f"{f_leaf:.2e} of their norm (bound {TP_F32_LEAF}) [{card}]")
    log(f"  memory the step added at its peak: ranks {[round(p / 2**30, 3) for p in peaks]} GiB, "
        f"unsharded {ref_train['peak_added'] / 2**30:.3f} GiB (ratio "
        f"{[round(p / ref_train['peak_added'], 3) for p in peaks]}); ms a step (CUDA events, 3 "
        f"steps a round): ranks "
        f"{[[round(v, 2) for v in r['train']['step_ms']] for r in train_ranks]} (four ranks on "
        f"one card at once, gathers and halos through host memory), unsharded "
        f"{[round(v, 2) for v in ref_train['step_ms']]}; launches K1-K3 per rank "
        f"{[r['train']['launches'] for r in train_ranks]} [{card}]")
    expect(max(rel.values()) <= DP_RTOL and grads_rel <= DP_RTOL and stats_rel <= DP_RTOL,
           "the tensor-parallel train step disagrees with the unsharded step")
    expect(worst_leaf <= SP_LEAF_NORM, f"a gradient leaf's norm is {worst_leaf:.3f} from the "
                                       "unsharded step's")
    expect(max(f_rel.values()) <= TP_F32_RTOL and f_grads <= TP_F32_RTOL
           and f_stats_leaf <= TP_F32_RTOL and f_leaf <= TP_F32_LEAF,
           "the float32 tensor-parallel train step disagrees with the unsharded step")
    expect(all(r[k]["launches"] == [0, 0, 0] for r in train_ranks for k in ("train", "train_f32")),
           "the tensor-parallel train step launched a kernel")
    out["timing"]["train_step"] = {
        "relative": rel, "grads_rel": grads_rel, "stats_rel": stats_rel,
        "stats_worst_leaf": stats_leaf, "worst_counted_leaf": worst_leaf,
        "float32": {"relative": f_rel, "grads_rel": f_grads, "stats_worst_leaf": f_stats_leaf,
                    "worst_counted_leaf": f_leaf},
        "peak_added_bytes": peaks, "peak_added_bytes_unsharded": ref_train["peak_added"],
        "step_ms": [r["train"]["step_ms"] for r in train_ranks],
        "step_ms_unsharded": ref_train["step_ms"]}

    # (c) the native loader against its plain version on phase 4c's volumes:
    # the loads alone (each subject's image, normalised, and segmentation),
    # then materialize (the loads and the boxes), each in turns
    root = tmp / "data"
    generate_dataset(root, num_processes=1, **RECIPE_DATA)

    def module(who):  # a fresh one: a datamodule keeps the samples it loaded
        cls = SyntheticDataModule if who == "native" else PythonLoaderModule
        return cls(root, n_classes=1, max_objects=16)

    subjects = module("native").subjects_list
    times = {"load_native": [], "load_python": [], "native": [], "python": []}
    arrays = {}
    for who in ("native", "python", "python", "native"):
        dm = module(who)
        t0 = time.perf_counter()
        for subject in subjects:
            (partial(dm._load_sample, boxes=False) if who == "python"
             else partial(native_sample, dm))(subject)
        times[f"load_{who}"].append(time.perf_counter() - t0)
    for who in ("native", "python", "python", "native"):
        dm = module(who)
        dm.setup("fit")
        t0 = time.perf_counter()
        arrays[who] = dm.materialize(dm.subjects_list)
        times[who].append(time.perf_counter() - t0)
    a, b = arrays["native"], arrays["python"]
    image_err = float(np.abs(a["image"] - b["image"]).max())
    same_boxes = all(np.array_equal(a[k], b[k]) for k in ("boxes", "labels", "box_mask"))
    log(f"the NIfTI loads of {len(subjects)} subjects of {RECIPE_DATA['image_size']} (image "
        f"normalised, segmentation): native loader "
        f"{[round(t, 3) for t in times['load_native']]} s, its plain version (Python decode and "
        f"normalisation) {[round(t, 3) for t in times['load_python']]} s; materialize (the loads "
        f"and the boxes): {[round(t, 3) for t in times['native']]} s / "
        f"{[round(t, 3) for t in times['python']]} s, each in turns; images max abs "
        f"difference {image_err:.3e}, boxes, labels and masks equal {same_boxes} [{card}]")
    expect(same_boxes and image_err <= 1e-4,
           "the native loader's volumes differ from its plain version's")
    out["timing"]["materialize_s"] = times
    out["timing"]["native_image_max_abs"] = image_err
    log(f"tensor-parallel phase {time.perf_counter() - t_phase:.1f} s")
    check(not failed, "phase 4i: " + "; ".join(failed))
    return out


def op_dispatch_us(fused, x1, card) -> dict:
    """Host microseconds a call that the registered op adds, per kernel at
    batch 1 on the operands of the fused path's forward: the wrapper (op
    dispatch, then the launch) against the launch function alone, in turns
    (op, direct, direct, op), 200 calls each, the best of each."""
    kw = dict(n_classes=2, min_score=0.5, top_k=100)
    with torch.inference_mode():
        locs, scores = fused.model(x1)
        boxes, _, valid = nms_candidates(locs, scores, fused.priors, **kw)
        boxes = boxes.contiguous()
        blocks = fused.model.base.features
        h = layer_inputs(fused.model, x1)[3].contiguous(memory_format=torch.channels_last_3d)
        dw = (h, *block_dw_operands(blocks[3], h.dtype))
        t_in = blocks[3](h).contiguous(memory_format=torch.channels_last_3d)
        tail = [blocks[i].folded_params() for i in range(4, 8)]
        pairs = {
            "K1": (partial(greedy_nms_cuda, boxes, valid, 0.5),
                   partial(kernels.nms._launch, boxes, valid, 0.5, None, None)),
            "K2": (partial(fused_depthwise_bn_relu_cuda, *dw),
                   partial(kernels.depthwise._launch, *dw, [])),
            "K3": (partial(fused_tail_cuda, t_in, tail, (1, 3)),
                   partial(kernels.tail._launch, t_in, tail, [1, 3])),
        }

        def host_us(fn, n=200):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e6

        out = {}
        for name, (op, direct) in pairs.items():
            times = {"op": [], "direct": []}
            for who in ("op", "direct", "direct", "op"):
                times[who].append(host_us(op if who == "op" else direct))
            out[name] = {"op_us": min(times["op"]), "direct_us": min(times["direct"])}
            out[name]["added_us"] = out[name]["op_us"] - out[name]["direct_us"]
    log("op dispatch at batch 1, host us a call (wrapper through the registered op / the "
        "launch function alone / added): " + "; ".join(
            f"{k} {v['op_us']:.1f} / {v['direct_us']:.1f} / {v['added_us']:.1f}"
            for k, v in out.items())
        + f"; K1 + K2 + K3 (a fused Detector.detect call) add "
        f"{sum(v['added_us'] for v in out.values()):.1f} us [{card}]")
    return out


# ---------------------------------------------------------------- phases
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log("TF32 is off for cuDNN convolutions and for matmuls")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        built = dict(zip(KERNELS, ex.map(build, KERNELS)))
    log(f"built {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s; nvcc -Xptxas -v:")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill", "smem")):
                log(f"  [{name}] " + line.strip())
    hmma = hmma_counts(built["tail"][0])
    for function, count in hmma.items():
        log(f"  [tail] HMMA instructions in {function}: {count}")
    hmma_total = sum(hmma.values())
    check(all(count > 0 for f, count in hmma.items() if "cluster" in f or "mma" in f)
          and hmma_total > 0, "the K3 library's bf16 kernels have no tensor-core instruction")

    # 3. K1 against its plain version on synthetic cases
    rng = np.random.default_rng(0)
    mismatches = 0
    mismatches += compare_nms("clustered K=200", *clustered_case(rng))
    mismatches += compare_nms("prefix 90/200/384", *prefix_case(rng))
    mismatches += compare_nms("near threshold", *near_threshold_case())
    mismatches += compare_nms("random N=128 K=1000", *random_case(rng))
    # past the warp walk's 2048: the 96^3 headline's K = 3942 on every wide
    # walk, and the first K past what one staged word holds (rows from
    # global memory; one row, since the plain version holds K x K pairs)
    mismatches += compare_nms("random N=8 K=3942", *random_case(rng, n=8, k=WIDE_K))
    for stages in (2, 1, 0):
        mismatches += compare_nms(f"random N=4 K=3942, forced to {stages} staged words",
                                  *random_case(rng, n=4, k=WIDE_K),
                                  plan=plan_nms(WIDE_K, walk="wide", stages=stages))
    far = [torch.as_tensor(a, device="cuda").contiguous()
           for a in clustered_case(rng, n=1, k=FAR_K)]
    far[0] = far[0].float()
    mismatches += compare_nms(f"clustered N=1 K={FAR_K}", *far)
    far_ms = {"kernel_ms": device_ms(partial(greedy_nms_cuda, *far, 0.5), iters=5)[0],
              "kernel_call_ms": cuda_ms(partial(greedy_nms_cuda, *far, 0.5), iters=5),
              "plain_call_ms": cuda_ms(partial(greedy_nms, *far, 0.5), iters=1, warmup=0)}
    far_bound = nms_bound(far[1])
    log(f"K1 N=1 K={FAR_K}: kernel {far_ms['kernel_ms']:.4f} ms device time "
        f"({far_ms['kernel_call_ms']:.4f} per call), plain {far_ms['plain_call_ms']:.3f} ms per "
        f"call, bound {far_bound[0]:.5f} ms by {far_bound[1]} [{card}]")
    del far
    torch.cuda.empty_cache()

    config = SSD3DConfig.create(**HEADLINE)
    detectors = {name: Detector(SSD3DConfig.create(**HEADLINE, **flags), device="cuda", seed=0,
                                batch_sizes=(1, 8, 32))
                 for name, flags in FLAG_SETTINGS.items()}
    detector, fused = detectors["off"], detectors["both"]
    n_params = sum(p.numel() for p in detector.model.parameters())
    log(f"Detector: 96^3 bf16 MobileNet SSD3D width 1.0, {n_params:,} parameters, "
        f"{detector.priors.shape[0]} priors, K = {min(10 * config.top_k, detector.priors.shape[0])}; "
        f"one per flag setting {list(FLAG_SETTINGS)}, all with the weights of seed 0")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def volumes(b):
        return torch.randn((b, *config.input_size, 1), generator=gen, device="cuda")

    cand = {}
    with torch.inference_mode():
        for b in (8, 128):
            locs, scores = detector.model(volumes(b).to(config.compute_dtype))
            cand[b] = nms_candidates(locs, scores, detector.priors, n_classes=config.n_classes,
                                     min_score=config.min_score, top_k=config.top_k)
            boxes, _, valid = cand[b]
            mismatches += compare_nms(f"96^3 model candidates, batch {b}",
                                      boxes.contiguous(), valid)

    # K2 on the headline model's folded weights and real layer inputs
    blocks = detector.model.base.features
    dw_cases, dw_mismatches, dw_err = {}, 0, 0.0
    with torch.inference_mode():
        inputs = {b: layer_inputs(detector.model, volumes(b).to(config.compute_dtype))
                  for b in (8, 32)}
        for b, layer in ((8, 3), (8, 5), (8, 7), (32, 3)):
            x = inputs[b][layer].contiguous(memory_format=torch.channels_last_3d)
            dw_cases[b, layer] = (x, *block_dw_operands(blocks[layer], x.dtype))
        edge_rng = torch.Generator(device="cuda").manual_seed(1)
        for dtype in (torch.bfloat16, torch.float32):
            cases = [(f"layer {i}, batch {b}", x.to(dtype), *block_dw_operands(blocks[i], dtype))
                     for (b, i), (x, *_) in dw_cases.items()]
            for depth in (1, 2, 3):
                x = torch.randn((2, depth, 8, 8, 128), generator=edge_rng, device="cuda")
                cases.append((f"depth {depth}, layer 3 weights",
                              x.to(dtype).permute(0, 4, 1, 2, 3),
                              *block_dw_operands(blocks[3], dtype)))
            for name, x, w, g, bt in cases:
                m, err = compare_dw(name, x, w, g, bt)
                dw_mismatches += m
                dw_err = max(dw_err, err)

        # K3 on the headline tail and the real layer-3 output
        tail_layers = [blocks[i].folded_params() for i in range(4, 8)]
        tail_x = {b: blocks[3](inputs[b][3]).contiguous(memory_format=torch.channels_last_3d)
                  for b in (8, 32)}
        tail_err, tail_share = {}, {}
        for b, x in tail_x.items():
            tail_err[b], tail_share[b] = compare_tail(f"batch {b}", x, tail_layers, (1, 3))

        # the same weights with BN calibrated on seeded volumes: maps of unit scale
        calibrated = Detector(config, detector.model.state_dict(), device="cuda").model
        calibrate_bn(calibrated, volumes(8).to(config.compute_dtype))
        cal_state = calibrated.state_dict()
        cal_blocks = calibrated.base.features
        cal_in = layer_inputs(calibrated, volumes(8).to(config.compute_dtype))[3]
        cal_in = cal_in.contiguous(memory_format=torch.channels_last_3d)
        for dtype in (torch.bfloat16, torch.float32):
            m, err = compare_dw("layer 3, batch 8, BN calibrated", cal_in.to(dtype),
                                *block_dw_operands(cal_blocks[3], dtype))
            dw_mismatches += m
            dw_err = max(dw_err, err)
        x = cal_blocks[3](cal_in).contiguous(memory_format=torch.channels_last_3d)
        cal_tail = [cal_blocks[i].folded_params() for i in range(4, 8)]
        err, shares = compare_tail("batch 8, BN calibrated", x, cal_tail, (1, 3))
        tail_err[8] = max(tail_err[8], err)

        # a 24^3 input does not fit a cluster: K3's per-block tensor-core variant
        big = torch.randn((1, 24, 24, 24, 128), generator=edge_rng, device="cuda")
        big = big.to(config.compute_dtype).permute(0, 4, 1, 2, 3)
        specs = [(*layer["pw_w"].shape, int(layer["stride"])) for layer in tail_layers]
        check(plan_tail(big.dtype, big.shape, specs).variant == "block_mma",
              "the 24^3 input should take K3's per-block variant")
        compare_tail("24^3, per-block variant", big, tail_layers, (1, 3))

    # 4. the slices
    host_rng = np.random.default_rng(1)
    requests = [host_rng.standard_normal((n, *config.input_size, 1), dtype=np.float32)
                for n in (1, 3, 8)]
    served, (k1_default,), calls = serve(detector, requests, [greedy_nms_cuda])
    log(f"default path: served requests of {[r.shape[0] for r in requests]} volumes in "
        f"{calls} device calls; K1 launches {k1_default}")
    check(k1_default > 0, "the served path did not launch the NMS kernel")
    log(f"detections per volume: {check_served(requests, served, config).tolist()}")

    counters = [greedy_nms_cuda, fused_depthwise_bn_relu_cuda, fused_tail_cuda]
    served_fused, (k1_fused, k2_fused, k3_fused), calls = serve(fused, requests, counters)
    log(f"use_pallas + use_pallas_tail path: served requests of "
        f"{[r.shape[0] for r in requests]} volumes in {calls} device calls; launches: "
        f"K1 {k1_fused}, K2 {k2_fused}, K3 {k3_fused}")
    check(min(k1_fused, k2_fused, k3_fused) > 0,
          "the fused served path did not launch every kernel (K1, K2, K3)")
    # K1 launches once per forward, so K2 must too (layer 3 only)
    check(k2_fused == k1_fused, f"K2 launched {k2_fused} times in {k1_fused} forwards")
    with torch.inference_mode():
        fused_depthwise_bn_relu_cuda.launches = 0
        detectors["use_pallas"].model(volumes(1).to(config.compute_dtype))
        k2_use_pallas = fused_depthwise_bn_relu_cuda.launches
    log(f"K2 launches in one forward with use_pallas alone: {k2_use_pallas} (layers 3, 5, 7)")
    check(k2_use_pallas == 3, "use_pallas alone should launch K2 on layers 3, 5 and 7")
    # K1 launches once per forward, so this is K3's launches per forward
    log(f"K3 launches per forward on the fused served path: {k3_fused / k1_fused:g}")
    check(k3_fused <= 2 * k1_fused, "K3 launched more than 2 kernels per forward")
    log(f"detections per volume: {check_served(requests, served_fused, config).tolist()}")

    # top_k = 395: K = min(3950, 3942) = every prior, past the warp walk
    wide_cand, k1_wide = {}, 0
    wide_config = SSD3DConfig.create(**dict(HEADLINE, top_k=395))
    for name in ("off", "both"):
        wide = Detector(SSD3DConfig.create(**dict(HEADLINE, top_k=395), **FLAG_SETTINGS[name]),
                        detector.model.state_dict(), device="cuda")
        greedy_nms_cuda.launches = 0
        with torch.inference_mode(), tapped(wide.model) as outs:
            det = wide.detect(volumes(8).to(config.compute_dtype))
        k1_wide += greedy_nms_cuda.launches
        check(greedy_nms_cuda.launches == 1, f"Detector(top_k=395) [{name}] did not launch K1 once")
        with torch.inference_mode():
            check_plain_detections(f"Detector(top_k=395) [{name}], batch 8", det, *outs[0],
                                   wide.priors, wide_config)
            if name == "off":
                for b in (8, 32):
                    locs, scores = wide.model(volumes(b).to(config.compute_dtype))
                    wide_cand[b] = nms_candidates(locs, scores, wide.priors,
                                                  n_classes=config.n_classes,
                                                  min_score=config.min_score, top_k=395)
        check(int(det["count"].sum()) > 0, f"Detector(top_k=395) [{name}] found nothing")
        del wide

    kw = dict(n_classes=config.n_classes, top_k=config.top_k)
    with torch.inference_mode():
        x = volumes(8).to(config.compute_dtype)
        locs, scores = detector.model(x)
        det = detect_objects(locs, scores, detector.priors, min_score=config.min_score,
                             max_overlap=config.max_overlap, **kw)
        boxes, cscores, valid = nms_candidates(locs, scores, detector.priors,
                                               min_score=config.min_score, **kw)
        plain = select_detections(boxes, cscores, greedy_nms(boxes, valid, config.max_overlap), **kw)
        torch.cuda.synchronize()
        for key in det:
            check(torch.equal(det[key], plain[key]), f"detect_objects with K1 != plain NMS in {key}")
        log("detect_objects with K1 == detect_objects with the plain NMS (all four outputs, batch 8)")

        # the fused path against the default path, and both against float32,
        # on the seed's weights and on the BN-calibrated ones
        for weights, state in (("seed 0", detector.model.state_dict()),
                               ("seed 0, BN calibrated", cal_state)):
            models = [Detector(SSD3DConfig.create(**dict(HEADLINE, **flags)), state,
                               device="cuda").model
                      for flags in (FLAG_SETTINGS["both"], {}, dict(dtype="float32"))]
            outs = [m(x.float() if i == 2 else x) for i, m in enumerate(models)]
            for name, a, b, r in zip(("locs", "scores"), *outs):
                a, b = a.float(), b.float()
                rel = float((a - b).norm() / b.norm())
                rel_a, rel_b = float((a - r).norm() / r.norm()), float((b - r).norm() / r.norm())
                log(f"96^3 bf16 batch 8 [{weights}], {name}: use_pallas + use_pallas_tail vs "
                    f"default path: relative error {rel:.3e} (bound {PATHS_MAX_REL_ERR}), max "
                    f"abs diff {float((a - b).abs().max()):.3e}; against the float32 model on "
                    f"the same weights: fused {rel_a:.3e}, default {rel_b:.3e}")
                check(rel < PATHS_MAX_REL_ERR,
                      f"the fused path's {name} disagree with the default path's [{weights}]")
            del models, outs

    for name in ("off", "both"):
        small = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                                   **FLAG_SETTINGS[name])
        gpu32 = Detector(small, device="cuda", seed=3).model
        cpu32 = Detector(small, device="cpu", seed=3).model
        xs = torch.from_numpy(host_rng.standard_normal((2, 32, 32, 32, 1), dtype=np.float32))
        with torch.inference_mode():
            outs_gpu = [t.cpu() for t in gpu32(xs.cuda())]
            outs_cpu = cpu32(xs)
        for out, a, b in zip(("locs", "scores"), outs_gpu, outs_cpu):
            err = float((a - b).abs().max())
            log(f"fp32 32^3 forward [{name}], card vs CPU: {out} max abs diff {err:.3e}")
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-5), f"fp32 forward [{name}] {out}: card != CPU")

    # 4b. the training path
    train = drive_training(card, counters)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 4c. the training entry point
        entry = drive_training_entry(card, counters, Path(tmp))
        # 4d. the predict and eval entry points, the import and the tools
        scoring = drive_scoring(card, counters, Path(tmp), entry["root"], entry["last"])
        # 4e. full-resolution volumes
        full = drive_full_resolution(card, counters, cal_state, Path(tmp))
        # 4f. deployment: bundles, int8 and HTTP
        deploy = drive_deployment(card, counters + [qconv_cuda], cal_state, Path(tmp))
        # 4g. data parallelism: a one-rank NCCL group, two gloo ranks, the
        # sliding window over a mesh
        dp = drive_data_parallel(card, counters + [qconv_cuda], Path(tmp), entry, full,
                                 cal_state)
        # 4h. spatial sharding: two gloo ranks on a 1 x 2 data x spatial mesh
        spatial = drive_spatial(card, counters, Path(tmp), entry, cal_state)

    # 5. times on the card. Each kernel, its plain version and (for K2) the
    # cuDNN sequence it replaces are timed twice: per call with CUDA events
    # over back-to-back calls, which is what a caller pays, host launch work
    # included where the host is slower than the card; and, after the
    # host-clock measurements, as the device time of the kernels one call
    # launches (torch.profiler, host gaps excluded), which the bound compares.
    timed = {}

    def time_calls(key, bound_ms, bound_by, **fns):
        """CUDA-event ms per call of each (fn, iters) in fns."""
        timed[key] = dict(bound_ms=bound_ms, bound_by=bound_by, fns=fns, **{
            f"{field}_call_ms": cuda_ms(fn, iters=n) for field, (fn, n) in fns.items()})

    with torch.inference_mode():
        for b in (8, 128):
            boxes, _, valid = cand[b]
            boxes = boxes.contiguous()
            bound_ms, bound_by, ops, nbytes = nms_bound(valid)
            log(f"K1 bound N={valid.shape[0]} K={valid.shape[1]} valid share "
                f"{float(valid.float().mean()):.3f}: {bound_ms:.5f} ms by {bound_by} ({ops:.3e} "
                f"fp32 ops at 67 TFLOP/s; {nbytes:,} bytes at 3.35 TB/s)")
            time_calls(f"K1 N={b} K=1000", bound_ms, bound_by,
                       kernel=(partial(greedy_nms_cuda, boxes, valid, 0.5), 50),
                       plain=(partial(greedy_nms, boxes, valid, 0.5), 5))
        for b in (8, 32):  # top_k = 395: the wide walk on the 96^3 model's candidates
            boxes, _, valid = wide_cand[b]
            boxes = boxes.contiguous()
            bound_ms, bound_by, ops, nbytes = nms_bound(valid)
            log(f"K1 bound N={b} K={WIDE_K} valid share {float(valid.float().mean()):.3f}: "
                f"{bound_ms:.5f} ms by {bound_by} ({ops:.3e} fp32 ops at 67 TFLOP/s; {nbytes:,} "
                f"bytes at 3.35 TB/s); {describe_nms(plan_nms(WIDE_K))}")
            time_calls(f"K1 N={b} K={WIDE_K}", bound_ms, bound_by,
                       kernel=(partial(greedy_nms_cuda, boxes, valid, 0.5), 50),
                       plain=(partial(greedy_nms, boxes, valid, 0.5), 2))
        for (b, layer), (x, w, g, bt) in dw_cases.items():
            plan = plan_depthwise(x.dtype, x.shape)
            log(f"K2 plan at layer {layer}, batch {b}: {describe(plan)}")
            direct = plan_depthwise(x.dtype, x.shape, variant="direct")
            time_calls(f"K2 layer {layer} {tuple(x.shape)} bf16", *dw_bound(x),
                       kernel=(partial(fused_depthwise_bn_relu_cuda, x, w, g, bt), 50),
                       direct=(partial(fused_depthwise_bn_relu_cuda, x, w, g, bt, direct), 50),
                       plain=(partial(depthwise_bn_relu, x, w, g, bt), 10),
                       unfused=(partial(unfused_depthwise, blocks[layer], x), 20),
                       library=(partial(F.conv3d, x, *folded_conv_operands(w, g, bt),
                                        padding=1, groups=x.shape[1]), 20))
        for b, x in tail_x.items():
            plan = plan_tail(x.dtype, x.shape, specs)
            log(f"K3 plan at batch {b}: {plan.variant} kernel, {plan.launches} launch(es) a "
                f"call, {plan.smem:,} bytes of shared memory per CTA")
            time_calls(f"K3 batch {b} {tuple(x.shape)} bf16, layers 4-7", *tail_bound(
                x, tail_layers, (1, 3)),
                kernel=(partial(fused_tail_cuda, x, tail_layers, (1, 3)), 50),
                plain=(partial(tail_reference, x, tail_layers, (1, 3)), 10))
        # K1 on the full-volume path (phase 4e's candidates): a chunk's
        # per-patch NMS and the stitch at V = 1 and 4, and at top_k 395
        for key, (boxes, valid) in (("K1 sliding window per-patch", full["patch_case"]),
                                    ("K1 stitch V=1", full["stitch_case"]),
                                    ("K1 stitch V=4", full["stitch_case_v4"]),
                                    ("K1 stitch top_k 395", full["stitch_case_wide"])):
            bound_ms, bound_by, ops, nbytes = nms_bound(valid)
            key = f"{key} N={boxes.shape[0]} K={boxes.shape[1]}"
            log(f"{key} bound: valid share {float(valid.float().mean()):.3f}, {bound_ms:.5f} ms "
                f"by {bound_by} ({ops:.3e} fp32 ops; {nbytes:,} bytes); "
                f"{describe_nms(plan_nms(boxes.shape[1]))}")
            time_calls(key, bound_ms, bound_by,
                       kernel=(partial(greedy_nms_cuda, boxes, valid, 0.5), 50),
                       plain=(partial(greedy_nms, boxes, valid, 0.5), 5))
        time_calls(f"K3 per-block variant {tuple(big.shape)} bf16, layers 4-7",
                   *tail_bound(big, tail_layers, (1, 3)),
                   kernel=(partial(fused_tail_cuda, big, tail_layers, (1, 3)), 20),
                   plain=(partial(tail_reference, big, tail_layers, (1, 3)), 5))
    log("no PyTorch call computes 3D greedy NMS or a chain of depthwise-separable blocks: "
        "library_ms is null for K1 and K3. K2's library_ms is one F.conv3d (cuDNN) with the BN "
        "folded into its weight and bias, on the same channels_last_3d tensors: it omits the "
        "ReLU and is not bit-equal, a yardstick the port never calls")

    # three rounds over the four settings, each round in another order: the
    # spread between rounds is part of the result
    names = list(detectors)
    with torch.inference_mode():
        for b in (1, 32):
            x = volumes(b).to(config.compute_dtype)
            detect_ms = {name: [] for name in names}
            for r in range(3):
                for name in names[r:] + names[:r]:
                    det_ = detectors[name]
                    fwd_ms = cuda_ms(lambda: det_.model(x), iters=10)
                    locs, scores = det_.model(x)
                    det_ms = cuda_ms(lambda: detect_objects(
                        locs, scores, det_.priors, min_score=config.min_score,
                        max_overlap=config.max_overlap, **kw), iters=10)
                    detect_ms[name].append(cuda_ms(lambda: det_.detect(x), iters=10))
                    log(f"batch {b} on the card [{name}] round {r}: forward {fwd_ms:.3f} ms, "
                        f"detect_objects {det_ms:.3f} ms, Detector.detect "
                        f"{detect_ms[name][-1]:.3f} ms [{card}]")
            for name, ms in detect_ms.items():
                log(f"Detector.detect batch {b} [{name}]: median {float(np.median(ms)):.3f} ms, "
                    f"range {min(ms):.3f}-{max(ms):.3f} ms over 3 rounds [{card}]")
    dispatch = op_dispatch_us(fused, volumes(1).to(config.compute_dtype), card)

    for b in (1, 8, 32):
        imgs = host_rng.standard_normal((b, *config.input_size, 1), dtype=np.float32)
        iters = {1: 20, 8: 10, 32: 5}[b]
        for name in ("off", "both", "both", "off"):
            det_ = detectors[name]
            for _ in range(2):
                det_.predict(imgs)
            t0 = time.perf_counter()
            for _ in range(iters):
                det_.predict(imgs)
            dt = time.perf_counter() - t0
            log(f"Detector.predict [{name}] batch {b}: {b * iters / dt:.1f} volumes/s "
                f"({dt / iters * 1e3:.2f} ms per call, numpy in and out) [{card}]")

    # profiled last: the profiler may leave tracing overhead behind it. A
    # kernel's device time is the median of 3 traces (its split from the
    # median one), beside the card's clocks.
    log(f"clocks before the device timings: {clocks()}")
    with torch.inference_mode():
        for key, t in timed.items():
            for field, (fn, n) in t.pop("fns").items():
                if field != "kernel":
                    t[f"{field}_ms"], _ = device_ms(fn, iters=n)
                    continue
                rounds, t["split"] = device_ms_rounds(fn, iters=n)
                t["kernel_ms"], t["kernel_rounds_ms"] = rounds[1], rounds
                log(f"{key}: device ms per call by kernel function (median of rounds "
                    f"{', '.join(f'{r:.4f}' for r in rounds)}): " + ", ".join(
                        f"{name} {ms:.4f}" for name, ms in t["split"].items()) + f" [{card}]")
            unfused = (f", cuDNN depthwise conv + BN + ReLU {t['unfused_ms']:.4f} ms "
                       f"({t['unfused_call_ms']:.4f} per call), the first version (direct "
                       f"variant) {t['direct_ms']:.4f} ms ({t['direct_call_ms']:.4f} per call), "
                       f"F.conv3d with BN folded (no ReLU) {t['library_ms']:.4f} ms "
                       f"({t['library_call_ms']:.4f} per call)" if "unfused_ms" in t else "")
            log(f"{key}: kernel {t['kernel_ms']:.4f} ms device time ({t['kernel_call_ms']:.4f} "
                f"ms per call), plain {t['plain_ms']:.4f} ms ({t['plain_call_ms']:.4f} per "
                f"call){unfused}, bound {t['bound_ms']:.5f} ms by {t['bound_by']} [{card}]")
        # K3's device time by chain prefix at batch 8: the cost of each block
        prefix_ms = [device_ms(partial(fused_tail_cuda, tail_x[8], tail_layers[:d], (d - 1,)),
                               iters=20)[0] for d in range(1, len(tail_layers) + 1)]
        log("K3 at batch 8, device ms by chain prefix (layers 4..4+d-1): "
            + ", ".join(f"{ms:.4f}" for ms in prefix_ms) + "; per block: "
            + ", ".join(f"{b - a:.4f}" for a, b in zip([0.0] + prefix_ms, prefix_ms))
            + f" [{card}]")
    x = volumes(32).to(config.compute_dtype)
    for name in ("off", "both"):
        profile_detect(name, detectors[name], x, card)
    profile_training(train, card)

    # 4i. tensor parallelism: gloo ranks on 1 x 1 x 2 and 1 x 2 x 2 data x
    # spatial x model meshes; the native loader. It runs after the times:
    # rank processes started on the card make this process's profiler drop
    # kernel records from each later trace (a card run: 2 a trace after two
    # ranks, 4 after four more; ``utils.profiling.device_ms`` traces again
    # with more calls where too many are lost).
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        tensor = drive_tensor(card, counters, Path(tmp), cal_state)

    # 6. kernels line, card line, result line
    k2 = timed["K2 layer 3 (8, 128, 12, 12, 12) bf16"]
    k2_32 = timed["K2 layer 3 (32, 128, 12, 12, 12) bf16"]
    kernels = [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "mslesions3d_tpu_torch/csrc/nms.cu",
        "replaces": "mslesions3d_tpu/kernels/nms.py:134",
        "launches": k1_default,
        "launches_fused_path": k1_fused,
        "launches_training_path": train["launches"][0],
        "launches_with_detections_train_step": train["k1_metric"],
        "launches_eval_step": train["k1_eval"],
        "max_abs_err": 0.0 if mismatches == 0 else 1.0,
        "mismatches": mismatches,
        "ms": timed["K1 N=8 K=1000"]["kernel_ms"],
        "call_ms": timed["K1 N=8 K=1000"]["kernel_call_ms"],
        "plain_ms": timed["K1 N=8 K=1000"]["plain_ms"],
        "plain_call_ms": timed["K1 N=8 K=1000"]["plain_call_ms"],
        "bound_ms": timed["K1 N=8 K=1000"]["bound_ms"],
        "bound_by": timed["K1 N=8 K=1000"]["bound_by"],
        "library_ms": None,
        "device_split_ms": timed["K1 N=8 K=1000"]["split"],
        "rounds_ms": timed["K1 N=8 K=1000"]["kernel_rounds_ms"],
        "ms_n128": timed["K1 N=128 K=1000"]["kernel_ms"],
        "device_split_ms_n128": timed["K1 N=128 K=1000"]["split"],
        "launches_top_k_395": k1_wide,
        "launches_training_entry": entry["launches"][0],
        "launches_predict_default": scoring["default"]["launches"][0],
        "launches_predict_flagged": scoring["flagged"]["launches"][0],
        "launches_predict_imported": scoring["imported"]["launches"][0],
        "ms_k3942": timed[f"K1 N=8 K={WIDE_K}"]["kernel_ms"],
        "rounds_ms_k3942": timed[f"K1 N=8 K={WIDE_K}"]["kernel_rounds_ms"],
        "call_ms_k3942": timed[f"K1 N=8 K={WIDE_K}"]["kernel_call_ms"],
        "plain_ms_k3942": timed[f"K1 N=8 K={WIDE_K}"]["plain_ms"],
        "bound_ms_k3942": timed[f"K1 N=8 K={WIDE_K}"]["bound_ms"],
        "device_split_ms_k3942": timed[f"K1 N=8 K={WIDE_K}"]["split"],
        "ms_k3942_n32": timed[f"K1 N=32 K={WIDE_K}"]["kernel_ms"],
        "plain_ms_k3942_n32": timed[f"K1 N=32 K={WIDE_K}"]["plain_ms"],
        "bound_ms_k3942_n32": timed[f"K1 N=32 K={WIDE_K}"]["bound_ms"],
        "ms_k28545_n1": far_ms["kernel_ms"],
        "plain_call_ms_k28545_n1": far_ms["plain_call_ms"],
        "bound_ms_k28545_n1": far_bound[0],
        "plan_k3942": describe_nms(plan_nms(WIDE_K)),
        "plan_k28545": describe_nms(plan_nms(FAR_K)),
        "shape": "N=8 K=1000: the served batch of 8, candidates of the 96^3 model",
    }, {
        "name": "fused_depthwise_bn_relu",
        "route": "cuda",
        "source": "mslesions3d_tpu_torch/csrc/depthwise.cu",
        "replaces": "mslesions3d_tpu/kernels/depthwise.py:82",
        "launches": k2_fused,
        "launches_training_path": train["launches"][1],
        "launches_predict_flagged": scoring["flagged"]["launches"][1],
        "max_abs_err": max(dw_err, train["dw_check"][1], scoring["dw_check"][1]),
        "mismatches": dw_mismatches + train["dw_check"][0] + scoring["dw_check"][0],
        "max_abs_err_predict_f32": scoring["dw_check"][1],
        "max_abs_err_training_path": train["dw_check"][1],
        "ms": k2["kernel_ms"],
        "call_ms": k2["kernel_call_ms"],
        "plain_ms": k2["plain_ms"],
        "plain_call_ms": k2["plain_call_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "unfused_ms": k2["unfused_ms"],
        "library_ms": k2["library_ms"],
        "library_call_ms": k2["library_call_ms"],
        "library": "F.conv3d with the BN folded into weight and bias (no ReLU, not bit-equal)",
        "direct_ms": k2["direct_ms"],
        "ms_batch32": k2_32["kernel_ms"],
        "call_ms_batch32": k2_32["kernel_call_ms"],
        "bound_ms_batch32": k2_32["bound_ms"],
        "library_ms_batch32": k2_32["library_ms"],
        "direct_ms_batch32": k2_32["direct_ms"],
        "ms_layer5": timed["K2 layer 5 (8, 256, 6, 6, 6) bf16"]["kernel_ms"],
        "ms_layer7": timed["K2 layer 7 (8, 512, 3, 3, 3) bf16"]["kernel_ms"],
        "launches_use_pallas_forward": k2_use_pallas,
        "plan": describe(plan_depthwise(torch.bfloat16, (8, 128, 12, 12, 12))),
        "shape": "(8, 128, 12, 12, 12) bf16: layer 3 of the 96^3 model at the served batch of 8",
    }, {
        "name": "fused_tail",
        "route": "cuda",
        "source": "mslesions3d_tpu_torch/csrc/tail.cu",
        "replaces": "mslesions3d_tpu/kernels/tail.py:106",
        "launches": k3_fused,
        "launches_training_path": train["launches"][2],
        "launches_predict_flagged": scoring["flagged"]["launches"][2],
        "max_abs_err": max(tail_err[8], train["tail_check"][0], scoring["tail_check"][0]),
        "max_abs_err_predict_f32": scoring["tail_check"][0],
        "max_abs_err_training_path": train["tail_check"][0],
        "differing_share_training_path": train["tail_check"][1],
        "differing_share": tail_share[8],
        "differing_share_bn_calibrated": shares,
        "ms": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["kernel_ms"],
        "call_ms": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["kernel_call_ms"],
        "plain_ms": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["plain_ms"],
        "plain_call_ms": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["plain_call_ms"],
        "bound_ms": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["bound_ms"],
        "bound_by": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["bound_by"],
        "library_ms": None,
        "device_split_ms": timed["K3 batch 8 (8, 128, 12, 12, 12) bf16, layers 4-7"]["split"],
        "ms_batch32": timed["K3 batch 32 (32, 128, 12, 12, 12) bf16, layers 4-7"]["kernel_ms"],
        "bound_ms_batch32":
            timed["K3 batch 32 (32, 128, 12, 12, 12) bf16, layers 4-7"]["bound_ms"],
        "hmma_in_library": hmma_total,
        "prefix_ms": prefix_ms,
        "ms_block_variant_24cubed":
            timed["K3 per-block variant (1, 128, 24, 24, 24) bf16, layers 4-7"]["kernel_ms"],
        "shape": "layers 4-7 of the 96^3 model on (8, 128, 12, 12, 12) bf16, 1 launch a call "
                 "(the cluster kernel)",
    }]
    # the full-volume path (phase 4e): launches by setting, and K1's times at
    # its two call sites
    def timed_by_prefix(prefix):
        return next(t for k, t in timed.items() if k.startswith(prefix))

    full_k1 = {}
    for prefix, name in (("K1 sliding window per-patch", "per_patch"), ("K1 stitch V=1", "stitch"),
                         ("K1 stitch V=4", "stitch_v4"), ("K1 stitch top_k 395", "stitch_k3950")):
        t = timed_by_prefix(prefix)
        full_k1.update({f"ms_{name}": t["kernel_ms"], f"call_ms_{name}": t["kernel_call_ms"],
                        f"plain_ms_{name}": t["plain_ms"], f"bound_ms_{name}": t["bound_ms"]})
    kernels[0].update(launches_full_volume=full["k1"], mismatches_full_volume=full["mismatches"],
                      **full_k1)
    kernels[1].update(launches_full_volume=full["k2"],
                      max_abs_err_full_volume=full["dw_check"][1])
    kernels[2].update(launches_full_volume=full["k3"],
                      max_abs_err_full_volume=full["tail_check"][0])
    kernels[0]["max_abs_err"] = 0.0 if mismatches + full["mismatches"] == 0 else 1.0
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], full["dw_check"][1])
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], full["tail_check"][0])
    # the deployment path (phase 4f): launches a bundle call, by bundle
    for i, kernel in enumerate(kernels):
        kernel["launches_bundle_path"] = {name: launches[i]
                                          for name, launches in deploy["launches"].items()}
    # the data-parallel path (phase 4g): launches by run
    kernels[0]["launches_data_parallel"] = dp["k1"]
    kernels[1]["launches_data_parallel"] = dp["k2"]
    kernels[2]["launches_data_parallel"] = dp["k3"]
    kernels[0]["mismatches_data_parallel"] = dp["mismatches"]
    kernels[0]["max_abs_err"] = (0.0 if mismatches + full["mismatches"] + dp["mismatches"] == 0
                                 else 1.0)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], dp["dw_check"][1])
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], dp["tail_check"][0])
    kernels[0]["op_dispatch_us_batch1"] = dispatch["K1"]
    kernels[1]["op_dispatch_us_batch1"] = dispatch["K2"]
    kernels[2]["op_dispatch_us_batch1"] = dispatch["K3"]
    q1 = deploy["q1"]
    kernels.append({
        "name": "qconv",
        "route": "cuda",
        "source": "mslesions3d_tpu_torch/csrc/qconv.cu",
        "replaces": "mslesions3d_tpu/quant.py:212",
        "tpu_kernel": False,
        "replaces_what": "_qconv: XLA's conv_general_dilated on int8 operands with int32 "
                         "accumulation (not a Pallas kernel)",
        "launches": deploy["launches"]["int8"][3],
        "launches_bundle_path": {name: launches[3]
                                 for name, launches in deploy["launches"].items()},
        "max_abs_err": q1["max_abs_err"],
        "int32_mismatches": q1["int_mismatches"],
        "epilogue_mismatches": q1["epilogue_mismatches"],
        "ms": q1["ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": None,
        "library": "none: torch on CUDA has no int8 conv3d; torch._int_mm (cuBLASLt s8 GEMM) "
                   "on the pointwise convs' integers is timed as a yardstick "
                   "(int_mm_ms_pointwise), never used by the port",
        "int_mm_ms_pointwise": q1["int_mm_ms_pointwise"],
        "by_kind": q1["kinds"],
        "shape": "every conv of one int8 forward of the 96^3 model at batch 8 (sums over the "
                 "convs)",
    })
    kernels[3]["launches_data_parallel"] = dp["q1"]
    # the spatial path (phase 4h): launches by run, per rank
    kernels[0]["launches_spatial"] = spatial["k1"]
    kernels[1]["launches_spatial"] = spatial["k2"]
    kernels[2]["launches_spatial"] = spatial["k3"]
    kernels[3]["launches_spatial"] = {}
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], spatial["dw_check"][1])
    kernels[1]["mismatches"] += spatial["dw_check"][0]
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], spatial["tail_check"][0])
    # the tensor-parallel path (phase 4i): launches by run, per rank
    kernels[0]["launches_tensor_parallel"] = tensor["k1"]
    kernels[1]["launches_tensor_parallel"] = tensor["k2"]
    kernels[2]["launches_tensor_parallel"] = tensor["k3"]
    kernels[3]["launches_tensor_parallel"] = {}
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], tensor["dw_check"][1])
    kernels[1]["mismatches"] += tensor["dw_check"][0]
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], tensor["tail_check"][0])
    log("deployment: " + json.dumps({**deploy["timing"], "card": card}))
    log("data parallel: " + json.dumps({**dp["timing"], "card": card}))
    log("spatial: " + json.dumps({**spatial["timing"], "card": card}))
    log("tensor parallel: " + json.dumps({**tensor["timing"], "card": card}))
    log("full resolution: " + json.dumps({**full["timing"], "card": card}))
    log("training: " + json.dumps({
        "step_ms": train["step_ms"], "eval_step_ms_batch8": train["eval_ms"],
        "peak_bytes": train["peak"], "card": card}))
    log("training entry: " + json.dumps({
        "generate_s": entry["gen_s"], "materialize_s": entry["materialize_s"],
        "cli_train_s": entry["fit_s"], "trainer_ms_per_step": entry["per_step_ms"],
        "bare_step_ms": entry["bare_step_ms"], "validation_s": entry["val_s"],
        "peak_bytes": entry["peak"], "card": card}))
    log("scoring: " + json.dumps({
        "predict_s_per_volume": {k: scoring[k]["s_per_volume"]
                                 for k in ("default", "flagged", "imported")},
        "predict_step_ms": {k: scoring[k]["step_ms"] for k in ("default", "flagged")},
        "launches_per_volume": {k: [n / 8 for n in scoring[k]["launches"]]
                                for k in ("default", "flagged", "imported")},
        "eval_s": scoring["eval_s"], "operating_points": scoring["points"],
        "paths_rel_err": scoring["paths_rel_err"], "tune_lr_s": scoring["tune_lr_s"],
        "tune_lr_suggestion": scoring["suggestion"], "card": card}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
