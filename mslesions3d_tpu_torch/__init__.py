"""mslesions3d_tpu_torch: the SSD3D lesion detector in PyTorch, for an NVIDIA H100.

A port of the JAX package ``mslesions3d_tpu``, which stays the reference.
Public functions keep the JAX layout: images (B, D, H, W, C), locs (B, P, 6),
scores (B, P, n_classes). Every TPU kernel on a ported path becomes a CUDA
kernel written for Hopper (``csrc/``), beside a plain PyTorch version that
CPU tensors use. It serves (``Detector``) and trains (``train``: the
reference's optimizer, MultiBox matching and loss, device-side
augmentation, train / eval / predict steps, the ``Trainer`` loop with
checkpoints; ``data``: the NIfTI and synthetic pipeline;
``python -m mslesions3d_tpu_torch.cli.train``), and runs full-resolution
volumes: patch training (``data.patches``) and sliding-window inference
(``sliding_window``), and data-, spatially and tensor-parallel over cards
and hosts (``parallel``: one rank a card). This package never imports JAX.
"""

from .data.augment import AugmentConfig
from .models.losses import multibox_loss, multibox_loss_from_config
from .models.ssd3d import SSD3D, SSD3DConfig, detect, model_priors
from .ops.matching import match_priors_batch
from .ops.nms import detect_objects, detections_to_lists
from .serving import Detector, RequestBatcher
from .train import (
    TrainState,
    create_train_state,
    eval_view,
    make_eval_step,
    make_gathered_eval_step,
    make_gathered_train_step,
    make_predict_step,
    make_train_step,
)
from .weights import from_jax_params, from_jax_variables

__all__ = [
    "SSD3D", "SSD3DConfig", "detect", "model_priors", "detect_objects",
    "detections_to_lists", "Detector", "RequestBatcher", "from_jax_variables",
    "from_jax_params", "AugmentConfig", "multibox_loss", "multibox_loss_from_config",
    "match_priors_batch", "TrainState", "create_train_state", "eval_view",
    "make_train_step", "make_eval_step", "make_predict_step", "make_gathered_train_step",
    "make_gathered_eval_step",
]
