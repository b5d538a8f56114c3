"""Tensor (model) parallelism: conv channels sharded over a "model" axis
(counterpart of ``mslesions3d_tpu/parallel/tensor.py``).

The JAX package annotates channel shardings on a ("data", "spatial",
"model") device mesh and lets XLA's partitioner insert the collectives.
Torch has no partitioner, so here each rank holds its slices of the
sharded parameters and the layers exchange the activations themselves
(``models/layers.py``: :func:`~..models.layers.model_conv_input`), as the
spatial path exchanges its halos. Under a data x spatial x model mesh
(:func:`make_mesh_3d`: rank = (d n_spatial + s) n_model + m) rank (d, s, m)
holds its rows of the batch and its depth slab, as under a data x spatial
mesh, and the m-th slice of every sharded parameter.

The sharding rules are the JAX package's ``_leaf_spec``, shape-based, on
the port's tensors in torch layout (:func:`leaf_spec`), so they apply as
they are to Adam's moments and the EMA:

* a 5-D conv kernel (Cout, Cin, kd, kh, kw) shards Cout (dim 0) when Cout
  divides by n_model and is at least n_model, else Cin (dim 1) when that
  does, else it is replicated. A depthwise kernel (C, 1, ...) counts its
  groups as Cout. So the heads shard Cout wherever their K divides (cls K =
  4 and loc K = 12 at n_model 2), and Cin only where it does not (K = 6
  and 18 at n_model 4);
* a 1-D vector (BN scale, bias and statistics, conv biases) and
  ``rescale_factors`` (the JAX package's (C,); the port's (1, C, 1, 1, 1),
  dim 1) shard when they divide;
* everything else (scalars, the ConvNet's PReLU) is replicated.

The forward: a conv whose output channels are sharded runs on its rank's
weight slice, on every input channel (an ``all_gather`` over the model
group whose backward is a reduce-scatter); a depthwise conv runs on its
slice of the channels with no communication; a conv whose input channels
are sharded computes a partial sum and all-reduces it (backward: the
identity); BatchNorm is per channel, its training sums over the data x
spatial group of the rank's slice (``TensorMesh.stats``). The heads' outputs
come back whole on every rank, so every model rank computes the same loss:
the steps sum the gradients over ``stats`` only (``TensorMesh.replicas``),
and a replicated parameter's gradient is the same on every model rank.

The kernels: K2 (``use_pallas``) runs on each rank's slice of layer 3's
channels; K3 (``use_pallas_tail``) takes every channel of its input and the
whole weights of its blocks, joined over the model group; K1 runs on the
whole heads' output. Training launches none of them.

Unlike the JAX package's 3-D mesh, whose weight gradients XLA corrupts
(its bug B), the port's gradients on this mesh are those of the unsharded
step: the tests hold them against it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from .collectives import _all_gather, data_parallel, gather_rows
from .mesh import TensorMesh, make_mesh_3d, shard_batch
from .spatial import depth_slab

__all__ = ["TensorMesh", "leaf_spec", "make_mesh_3d", "make_tensor_parallel_forward",
           "shard_tree", "tensor_sharding", "unshard_tree"]


def leaf_spec(name: str, shape, n_model: int):
    """The dim of a tensor named ``name`` of ``shape`` (torch layout) that
    the model axis shards, or None (replicated): the JAX package's
    ``_leaf_spec`` rules (module docstring)."""
    shape = tuple(shape)

    def divides(n):
        return n % n_model == 0 and n >= n_model

    if name.split(".")[-1] == "rescale_factors":  # the JAX package's 1-D (C,)
        return 1 if divides(shape[1]) else None
    if len(shape) == 5:
        if divides(shape[0]):
            return 0
        return 1 if divides(shape[1]) else None
    if len(shape) == 1 and divides(shape[0]):
        return 0
    return None


def _map(tree, fn, name: str = ""):
    """``tree`` (a tensor, a dict of them by name, a dataclass of such, or
    anything else) with each tensor t replaced by fn(its name, t)."""
    if isinstance(tree, torch.Tensor):
        return fn(name, tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn, f.name)
                                            for f in dataclasses.fields(tree)})
    return tree


def _n_model(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh.n_model


def tensor_sharding(tree, mesh):
    """``tree`` (a ``state_dict``, a dict of parameters or gradients, or a
    whole ``TrainState``: its params, BN statistics, Adam moments and EMA)
    with each whole tensor replaced by its :func:`leaf_spec` under ``mesh``
    (a :class:`TensorMesh`, or n_model): the dim the model axis shards, or
    None."""
    n = _n_model(mesh)
    return _map(tree, lambda name, t: leaf_spec(name, t.shape, n))


def shard_tree(tree, mesh: TensorMesh):
    """This rank's slices (its model index's) of every sharded tensor of a
    whole ``tree`` (as :func:`tensor_sharding` takes it); replicated tensors
    stay as they were. The slices are copies, so the whole tree can go."""
    n, m = mesh.n_model, mesh.model.rank

    def place(name, t):
        dim = leaf_spec(name, t.shape, n)
        if dim is None:
            return t
        part = t.shape[dim] // n
        return t.narrow(dim, m * part, part).clone()

    return _map(tree, place)


def unshard_tree(tree, mesh: TensorMesh, specs):
    """The whole tensors of a ``tree`` of this rank's slices: each sharded
    one (``specs``, from :func:`tensor_sharding` of the whole tree, says
    which dim) joined over the model group, the others as they are."""
    def join(tree, specs):
        if isinstance(tree, torch.Tensor):
            if specs is None:
                return tree
            parts = _all_gather(tree.detach().movedim(specs, 0).contiguous(), mesh.model)
            return torch.cat(parts, 0).movedim(0, specs).contiguous()
        if isinstance(tree, dict):
            return {k: join(v, specs[k]) for k, v in tree.items()}
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{
                f.name: join(getattr(tree, f.name), getattr(specs, f.name))
                for f in dataclasses.fields(tree)})
        return tree

    return join(tree, specs)


def _local(images, mesh: TensorMesh):
    """This rank's rows (over the data group) and depth slab of volumes."""
    return depth_slab(shard_batch({"image": images}, mesh)["image"], mesh)


def make_tensor_parallel_forward(model, mesh: TensorMesh):
    """The eval forward with channel-sharded parameters.

    Returns fn(state_dict, images) -> (locs, scores) of the whole batch on
    every rank: ``state_dict`` is the model's whole one (the reference
    schema), ``images`` (B, D, H, W, C) the global batch, B divisible by the
    data axis and D by the spatial axis. Each rank runs ``model`` in eval
    mode on its rows, its depth slab and its slices of the parameters, and
    the rows come back gathered over the data group. The slices are placed
    once per state dict (``fn.place_variables``): the cache holds the
    source too, so an ``id()`` reused after collection cannot serve stale
    slices.
    """
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    placed: dict = {}

    def place_variables(state_dict):
        key = id(state_dict)
        if key not in placed or placed[key][0] is not state_dict:
            placed.clear()
            whole = {k: torch.as_tensor(v).to(device=mesh.device, dtype=dtypes.get(k))
                     for k, v in state_dict.items()}
            placed[key] = (state_dict, shard_tree(whole, mesh))
        return placed[key][1]

    def run(state_dict, images):
        x = torch.as_tensor(_local(images, mesh), device=mesh.device)
        model.eval()
        with torch.no_grad(), data_parallel(mesh):
            locs, scores = functional_call(model, place_variables(state_dict), (x,))
        out = gather_rows({"locs": locs, "scores": scores}, mesh.data)
        return out["locs"], out["scores"]

    run.place_variables = place_variables
    return run
