"""mslesions3d_tpu_torch: the SSD3D lesion detector in PyTorch, for an NVIDIA H100.

A port of the JAX package ``mslesions3d_tpu``, which stays the reference.
Public functions keep the JAX layout: images (B, D, H, W, C), locs (B, P, 6),
scores (B, P, n_classes). Every TPU kernel on a ported path becomes a CUDA
kernel written for Hopper (``csrc/``), beside a plain PyTorch version that
CPU tensors use. This package never imports JAX.
"""

from .models.ssd3d import SSD3D, SSD3DConfig, detect, model_priors
from .ops.nms import detect_objects, detections_to_lists
from .serving import Detector, RequestBatcher
from .weights import from_jax_variables

__all__ = [
    "SSD3D", "SSD3DConfig", "detect", "model_priors", "detect_objects",
    "detections_to_lists", "Detector", "RequestBatcher", "from_jax_variables",
]
