"""Spatial sharding: the volume's depth split over cards (counterpart of
``mslesions3d_tpu/parallel/spatial.py``).

The JAX package annotates shardings on a ("data", "spatial") device mesh
and leaves the conv halo exchanges to XLA's partitioner. Torch has no
partitioner, so here the layers exchange them. Under a data x spatial mesh
(:func:`make_mesh_2d`: rank = d n_spatial + s) rank (d, s) holds its rows
of the batch (those of the data group's rank d) and, of each volume, the
depth slab s (:func:`shard_batch_spatial`). A step runs inside
``parallel.data_parallel(mesh)``, whose :class:`~.collectives.Split` the
layers read:

* **Halos.** A 3^3 conv (padding 1) takes its left and right neighbours'
  boundary planes at stride 1, and only the left one at stride 2, and then
  runs with depth padding 0 (H and W padding unchanged); the ranks at the
  volume's ends get zero planes, which is the conv's zero padding. A
  pointwise conv takes none. The ConvNet's max-pool (k3, s2, p1) takes the
  left plane, -inf at the volume's start. ``collectives.halo`` gathers each
  rank's boundary planes over the spatial group; its backward sends each
  halo plane's gradient back to its owner.
* **The cut.** The slab always starts at an even plane while the depth
  divides 2 n_spatial. So a layer runs depth-split only while both its
  input depth and its output depth divide 2 n_spatial. Before the first
  layer that would not (``models.layers.run_tower``), its input is
  gathered over the spatial group (``collectives.gather_depth``) and the
  rest of the tower runs whole on each spatial rank, as the JAX package's
  cut to a replicated layout does (``spatial_activation_interceptor``).
  The feature maps taken before the cut are gathered there too, so the
  heads, ``use_l2_rescale`` and the priors see whole maps, in the JAX
  package's order. At inference with ``use_pallas_tail`` the cut comes at
  the fused tail's input at the latest (K3 runs on the whole input).
* **Reductions.** Before the cut the BN statistics sum over the world (a
  sample's voxels lie on the spatial ranks, the samples on the data ranks);
  after it over the data group; instance norm's per-sample sums over the
  spatial group; the loss's positives and the step's losses over the data
  group. Each rank's loss is its data rows' share divided by n_spatial, and
  the gather's backward sums over the spatial group, so the gradients
  summed over the world count the replicated layers once.
* **Micro-batches.** As the JAX package's ``pin_micro``, a micro-batch that
  does not divide over the data ranks runs with every row on every data
  rank (the depth still split); its loss is then also divided by n_data.

The steps under such a mesh take this rank's rows as whole volumes
(``parallel.shard_batch``, as under a data mesh) and keep its depth slab
after the augmentation (``train/steps.py``); where a micro-batch does not
divide, each rank takes its block of rows and the step gathers the batch
over the data group. ``use_pallas`` sends each rank's haloed slab of a
stride-1 block to K2 (planes + 2) and keeps the middle planes.
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import data_parallel, gather_rows
from .mesh import SpatialMesh, make_mesh_2d, row_runs, take_runs

__all__ = ["SpatialMesh", "batch_sharding_fn", "depth_slab", "make_mesh_2d",
           "make_spatially_sharded_forward", "shard_batch_spatial"]


def depth_slab(images, mesh: SpatialMesh):
    """This rank's depth slab of volumes (B, D, H, W, C)."""
    n, s = mesh.n_spatial, mesh.spatial.rank
    depth = images.shape[1]
    if depth % n:
        raise ValueError(f"volume depth {depth} is not divisible by spatial_shards={n}")
    part = depth // n
    return images[:, s * part:(s + 1) * part]


def batch_sharding_fn(mesh: SpatialMesh):
    """fn(key, value) -> this rank's part of a batch leaf: volumes (ndim >=
    5) keep its data rank's block of rows and its depth slab, per-sample
    leaves (boxes, labels, masks) its rows."""
    def fn(key, value):
        value = take_runs(value, row_runs(value.shape[0], mesh))
        return depth_slab(value, mesh) if value.ndim >= 5 else value

    return fn


def shard_batch_spatial(batch: dict, mesh: SpatialMesh) -> dict:
    """This rank's part (:func:`batch_sharding_fn`) of every array or tensor
    of a global batch dict; other entries pass through. Slices stay where
    they were."""
    fn = batch_sharding_fn(mesh)
    return {k: fn(k, v) if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def make_spatially_sharded_forward(model, mesh: SpatialMesh):
    """The eval forward with the volume depth split over the spatial group.

    Returns fn(images) -> (locs, scores) of the whole batch on every rank:
    images (B, D, H, W, C) are the global batch (B divisible by the data
    axis, D by the spatial axis, as the JAX package's device shardings
    need); each rank runs ``model`` (its own weights, on the mesh's device)
    in eval mode on its part, and the rows are gathered over the data group.
    """
    def run(images):
        x = torch.as_tensor(shard_batch_spatial({"image": images}, mesh)["image"],
                            device=mesh.device)
        model.eval()
        with torch.no_grad(), data_parallel(mesh):
            locs, scores = model(x)
        out = gather_rows({"locs": locs, "scores": scores}, mesh.data)
        return out["locs"], out["scores"]

    return run
