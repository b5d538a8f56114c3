"""The collectives of the data-parallel steps, and the mesh the layers reduce over.

A data-parallel step runs its forward and backward inside
:func:`data_parallel`: the training BatchNorm (``models/layers.py``) sums
its per-channel statistics over the mesh's ranks, so they are the global
batch's, and the ConvNet's dropout draws the global batch's mask and keeps
this rank's rows. Outside it the layers are those of one device.

Every collective here is a sum-all-reduce or a broadcast, with the tensors
of one dtype flattened into one buffer: those are the two that the ``gloo``
backend runs on CUDA tensors as well as CPU ones, and one call a dtype
keeps the count of collectives a step makes small.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_MESH = None


@contextlib.contextmanager
def data_parallel(mesh):
    """Within the block, the layers reduce over ``mesh`` (None: no mesh)."""
    global _MESH
    saved, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = saved


def current_mesh():
    """The mesh of the enclosing :func:`data_parallel` block, or None."""
    return _MESH


def _in_memory_order(t: torch.Tensor) -> tuple:
    """(t's elements as a 1-D tensor in memory order, the strides that lay
    them out as t): a view of a contiguous or ``channels_last_3d`` tensor,
    a contiguous copy of any other."""
    if t.is_contiguous():
        return t.reshape(-1), t.stride()
    if t.dim() == 5 and t.is_contiguous(memory_format=torch.channels_last_3d):
        return t.permute(0, 2, 3, 4, 1).reshape(-1), t.stride()
    t = t.contiguous()
    return t.reshape(-1), t.stride()


def _flat_by_dtype(tensors, fn) -> list:
    """Applies ``fn`` in place to one flat buffer per dtype of ``tensors``
    (one copy in, none out); returns views of the buffers with the inputs'
    shapes and, for contiguous and ``channels_last_3d`` inputs, strides."""
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        parts = [_in_memory_order(tensors[i].detach()) for i in idx]
        flat = torch.cat([part for part, _ in parts])
        fn(flat)
        offset = flat.storage_offset()
        for i, (part, strides) in zip(idx, parts):
            out[i] = flat.as_strided(tensors[i].shape, strides, offset)
            offset += part.numel()
    return out


def all_reduce_sum(tensors, mesh) -> list:
    """Each tensor summed over the mesh's ranks (the inputs are left as
    they were); with ``mesh`` None, the tensors themselves."""
    if mesh is None:
        return list(tensors)
    return _flat_by_dtype(list(tensors), lambda flat: dist.all_reduce(flat, group=mesh.group))


def broadcast(tensors, mesh, src: int = 0) -> list:
    """Rank ``src``'s values of each tensor, on every rank."""
    if mesh is None:
        return list(tensors)
    return _flat_by_dtype(list(tensors),
                          lambda flat: dist.broadcast(flat, src, group=mesh.group))


def gather_rows(tensors: dict, mesh) -> dict:
    """Every rank's rows of each tensor, rank by rank, on every rank.

    Each rank writes its rows (the same count on every rank) into its block
    of a zeroed buffer of the mesh's rows and the buffers are summed, which
    is exact (a value plus zeros). Booleans travel as int32. Numpy arrays
    become tensors on the mesh's device.
    """
    if mesh is None:
        return dict(tensors)
    keys, bufs, kinds = list(tensors), [], []
    for k in keys:
        t = torch.as_tensor(tensors[k], device=mesh.device)
        kinds.append(t.dtype)
        t = t.to(torch.int32) if t.dtype == torch.bool else t
        n = t.shape[0]
        buf = torch.zeros((mesh.size * n, *t.shape[1:]), dtype=t.dtype, device=mesh.device)
        buf[mesh.rank * n:(mesh.rank + 1) * n] = t
        bufs.append(buf)
    out = all_reduce_sum(bufs, mesh)
    return {k: v.to(torch.bool) if kind == torch.bool else v
            for k, v, kind in zip(keys, out, kinds)}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the mesh whose gradient is the sum of the ranks' gradients:
    each rank's loss depends on every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


def differentiable_all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh, differentiable; ``x`` itself without a mesh."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh)
