"""The data mesh: one ``torch.distributed`` rank per card.

Counterpart of ``mslesions3d_tpu/parallel/mesh.py``. The JAX package's data
mesh is a 1-D device mesh over the batch axis: batches are sharded across
chips, parameters replicated, and XLA inserts the gradient all-reduce and
takes the BatchNorm statistics over the global batch inside one program.
Here the mesh is a process group with one rank a card (``torchrun
--nproc_per_node N``): each rank holds its rows of every global batch
(:func:`shard_batch`), the steps sum the BN statistics, the loss's
normaliser and the gradients over the group (``train/steps.py``), and the
state starts equal on every rank (:func:`replicate`). A world of one rank
needs no launcher: :func:`make_mesh` forms it in the process, the JAX
package's one-device mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .collectives import broadcast
from .multihost import default_backend, initialize_multihost, local_rank


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A process group over which batches are sharded, and this rank's place in it."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str

    def describe(self) -> str:
        return (f"data-parallel mesh: world size {self.size}, backend {self.backend}, "
                f"rank {self.rank} on {self.device}")


def make_mesh(n_devices: int | None = None, device="cuda", backend: str | None = None) -> DataMesh:
    """The data mesh of this process: its rank on ``device``.

    ``device`` is the card unless the caller asks for the CPU; "cuda"
    becomes ``cuda:LOCAL_RANK``. The backend is NCCL on a card and gloo on
    the CPU unless ``backend`` names another. Under ``torchrun`` (or after
    :func:`~.multihost.initialize_multihost`) the mesh is the whole world;
    a single process forms a world of one, whose collectives run all the
    same. ``n_devices``, when given, must be the world size.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass device='cpu' "
                           "(--device cpu on the command line) to run on the CPU")
    backend = backend or default_backend(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    if not dist.is_initialized() and not initialize_multihost(backend=backend, device=device):
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh(n_devices={n_devices}) in a world of {size} ranks; "
                         "launch one rank a card with torchrun --nproc_per_node")
    return DataMesh(dist.group.WORLD, dist.get_rank(), size, device, dist.get_backend())


def visible_devices(device="cuda") -> tuple:
    """Every visible device of ``device``'s kind: each card, or the one CPU.
    The sliding window's mesh over all devices (the JAX package's
    ``make_mesh()`` there)."""
    if torch.device(device).type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def local_row_runs(batch: int, mesh, grad_accum: int = 1) -> list:
    """The rows of a global batch of ``batch`` that this rank holds, as
    slices in order (one a micro-batch).

    With ``grad_accum`` micro-batches, micro-batch i is the global rows
    [i m, (i + 1) m) (m = batch / grad_accum), as in the JAX package's step,
    and rank r holds the r-th share of every micro-batch, so its own
    micro-batch i is its i-th run of rows. A micro-batch that does not
    divide over the ranks raises.
    """
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if batch % size:
        raise ValueError(f"global batch {batch} is not divisible by the mesh's {size} ranks")
    if batch % grad_accum:
        raise ValueError(f"batch size {batch} is not divisible by grad_accum={grad_accum}")
    m = batch // grad_accum
    if m % size:
        raise ValueError(f"a micro-batch of {m} rows (batch {batch} / grad_accum "
                         f"{grad_accum}) does not divide over the mesh's {size} ranks")
    share = m // size
    return [slice(i * m + rank * share, i * m + (rank + 1) * share) for i in range(grad_accum)]


def take_runs(v, runs: list):
    """The rows ``runs`` (slices) of an array or tensor, by slicing: no index
    tensor goes to the device, so nothing waits for the card's queue."""
    if len(runs) == 1:
        return v[runs[0]]
    parts = [v[s] for s in runs]
    return np.concatenate(parts) if isinstance(v, np.ndarray) else torch.cat(parts)


def shard_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows (:func:`local_row_runs`) of every array or tensor of
    a global batch dict; other entries (subject id lists) pass through. The
    rows stay where they were: the steps move them to the state's device."""
    n = next(v.shape[0] for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)))
    runs = local_row_runs(n, mesh, grad_accum)
    return {k: take_runs(v, runs) if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def _tensors(obj, out: list):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)


def _rebuild(obj, values):
    if isinstance(obj, torch.Tensor):
        return next(values)
    if isinstance(obj, dict):
        return {k: _rebuild(v, values) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), values)
                                           for f in dataclasses.fields(obj)})
    return obj


def replicate(state, mesh):
    """``state`` (a ``TrainState``, or any dataclass or dict of tensors) with
    rank 0's values in every tensor, on every rank."""
    leaves: list = []
    _tensors(state, leaves)
    return _rebuild(state, iter(broadcast(leaves, mesh)))
