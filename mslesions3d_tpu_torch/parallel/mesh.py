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

:func:`make_mesh_2d` lays the world out as a data x spatial grid
(:class:`SpatialMesh`, ``parallel/spatial.py``), with a group for each axis,
and :func:`make_mesh_3d` as a data x spatial x model grid
(:class:`TensorMesh`, ``parallel/tensor.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .collectives import Split, broadcast
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

    @property
    def rows(self) -> "DataMesh":
        """The view over which the batch rows are split: the mesh itself."""
        return self

    @property
    def replicas(self) -> "DataMesh":
        """The view over which the steps sum the gradients: the mesh itself."""
        return self

    def split(self, rows: bool = True) -> Split:
        """The layers' view of a step under this mesh: rows split over it."""
        if not rows:
            raise ValueError("a data mesh splits the batch rows over its ranks: rows=False "
                             "has no meaning there")
        return Split(rows=self)


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """The world as a data x spatial grid: rank = d n_spatial + s, as the JAX
    package's ``np.reshape(n_data, n_spatial)`` lays out its devices.

    ``world`` is the whole grid, ``data`` the ranks that share this rank's s
    (over which the batch rows are split; its rank is d) and ``spatial`` the
    ranks that share its d (over which the volume depth is split; its rank
    is s). Each is a :class:`DataMesh` over its own group. ``rank``,
    ``size``, ``group``, ``device`` and ``backend`` are the world's, so a
    broadcast or a sum over the mesh is one over the world.
    """

    world: DataMesh
    data: DataMesh
    spatial: DataMesh

    @property
    def n_data(self) -> int:
        return self.data.size

    @property
    def n_spatial(self) -> int:
        return self.spatial.size

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def group(self):
        return self.world.group

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def backend(self) -> str:
        return self.world.backend

    @property
    def rows(self) -> DataMesh:
        """The view over which the batch rows are split: the data group."""
        return self.data

    @property
    def replicas(self) -> DataMesh:
        """The view over which the steps sum the gradients: the world."""
        return self.world

    def describe(self) -> str:
        return (f"data x spatial mesh {self.n_data} x {self.n_spatial}: world size "
                f"{self.size}, backend {self.backend}, rank {self.rank} (d {self.data.rank}, "
                f"s {self.spatial.rank}) on {self.device}")

    def split(self, rows: bool = True) -> Split:
        """The layers' view of a step under this mesh: depth split over the
        spatial group and, with ``rows``, the batch rows over the data group."""
        return Split(rows=self.data if rows else None, depth=self.spatial, both=self.world)


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


def make_mesh_2d(n_data: int, n_spatial: int, device="cuda",
                 backend: str | None = None) -> SpatialMesh:
    """The data x spatial mesh of this process over the world (see
    :func:`make_mesh` for ``device`` and ``backend``).

    The world must hold exactly ``n_data * n_spatial`` ranks: a world of
    another size raises, naming the world to launch. Every rank forms every
    group, in the same order.
    """
    world = make_mesh(device=device, backend=backend)
    n = n_data * n_spatial
    if world.size != n:
        raise ValueError(f"a data x spatial mesh of {n_data} x {n_spatial} needs a world of {n} "
                         f"ranks, and this one has {world.size}: launch {n} (torchrun "
                         f"--nproc_per_node {n}, one rank a card)")
    d, s = divmod(world.rank, n_spatial)
    spatial_groups = [dist.new_group([i * n_spatial + j for j in range(n_spatial)])
                      for i in range(n_data)]
    data_groups = [dist.new_group([i * n_spatial + j for i in range(n_data)])
                   for j in range(n_spatial)]
    return SpatialMesh(
        world=world,
        data=DataMesh(data_groups[s], d, n_data, world.device, world.backend),
        spatial=DataMesh(spatial_groups[d], s, n_spatial, world.device, world.backend),
    )


@dataclasses.dataclass(frozen=True)
class TensorMesh(SpatialMesh):
    """The world as a data x spatial x model grid: rank = (d n_spatial + s)
    n_model + m, as the JAX package's ``np.reshape(n_data, n_spatial,
    n_model)`` lays out its devices.

    Beside the :class:`SpatialMesh` views (``data``: the ranks that share
    this rank's s and m; ``spatial``: those that share its d and m),
    ``model`` is the ranks that share its d and s, over which the sharded
    parameters' channels lie (its rank is m), and ``stats`` the ranks that
    share its m (the data x spatial grid of this channel slice: its rank is
    d n_spatial + s), over which the batch statistics and the gradients are
    summed. The steps treat it as a data x spatial mesh whose layers also
    split their channels.
    """

    model: DataMesh = None
    stats: DataMesh = None

    @property
    def n_model(self) -> int:
        return self.model.size

    @property
    def replicas(self) -> DataMesh:
        """The view over which the steps sum the gradients: every rank that
        holds this rank's slice of the parameters (the model ranks all
        compute the same loss, so their sums would count it n_model times)."""
        return self.stats

    def describe(self) -> str:
        return (f"data x spatial x model mesh {self.n_data} x {self.n_spatial} x "
                f"{self.n_model}: world size {self.size}, backend {self.backend}, rank "
                f"{self.rank} (d {self.data.rank}, s {self.spatial.rank}, m {self.model.rank}) "
                f"on {self.device}")

    def split(self, rows: bool = True) -> Split:
        """The layers' view of a step under this mesh: the channels of the
        sharded layers over the model group, the depth over the spatial group
        (when it has more than one rank) and, with ``rows``, the batch rows
        over the data group; the batch statistics over ``stats``."""
        depth = self.spatial if self.n_spatial > 1 else None
        return Split(rows=self.data if rows else None, depth=depth, both=self.stats,
                     model=self.model)


def make_mesh_3d(n_data: int, n_spatial: int, n_model: int, device="cuda",
                 backend: str | None = None) -> TensorMesh:
    """The data x spatial x model mesh of this process over the world (see
    :func:`make_mesh` for ``device`` and ``backend``).

    The world must hold exactly ``n_data * n_spatial * n_model`` ranks: a
    world of another size raises, naming the world to launch. Every rank
    forms every group, in the same order.
    """
    world = make_mesh(device=device, backend=backend)
    n = n_data * n_spatial * n_model
    if world.size != n:
        raise ValueError(f"a data x spatial x model mesh of {n_data} x {n_spatial} x {n_model} "
                         f"needs a world of {n} ranks, and this one has {world.size}: launch "
                         f"{n} (torchrun --nproc_per_node {n}, one rank a card)")

    def rank(d, s, m):
        return (d * n_spatial + s) * n_model + m

    ds, m = divmod(world.rank, n_model)
    d, s = divmod(ds, n_spatial)
    model = [[dist.new_group([rank(i, j, k) for k in range(n_model)]) for j in range(n_spatial)]
             for i in range(n_data)]
    stats = [dist.new_group([rank(i, j, k) for i in range(n_data) for j in range(n_spatial)])
             for k in range(n_model)]
    spatial = [[dist.new_group([rank(i, j, k) for j in range(n_spatial)]) for k in range(n_model)]
               for i in range(n_data)]
    data = [[dist.new_group([rank(i, j, k) for i in range(n_data)]) for k in range(n_model)]
            for j in range(n_spatial)]

    def view(group, r, size):
        return DataMesh(group, r, size, world.device, world.backend)

    return TensorMesh(
        world=world,
        data=view(data[s][m], d, n_data),
        spatial=view(spatial[d][m], s, n_spatial),
        model=view(model[d][s], m, n_model),
        stats=view(stats[m], ds, n_data * n_spatial),
    )


def visible_devices(device="cuda") -> tuple:
    """Every visible device of ``device``'s kind: each card, or the one CPU.
    The sliding window's mesh over all devices (the JAX package's
    ``make_mesh()`` there)."""
    if torch.device(device).type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def local_row_runs(batch: int, mesh, grad_accum: int = 1, rank: int | None = None) -> list:
    """The rows of a global batch of ``batch`` that this rank (or ``rank``)
    holds, as slices in order (one a micro-batch).

    With ``grad_accum`` micro-batches, micro-batch i is the global rows
    [i m, (i + 1) m) (m = batch / grad_accum), as in the JAX package's step,
    and rank r holds the r-th share of every micro-batch, so its own
    micro-batch i is its i-th run of rows. A micro-batch that does not
    divide over the ranks raises.
    """
    size, here = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    rank = here if rank is None else rank
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


def rows_split(batch: int, mesh: SpatialMesh, grad_accum: int = 1) -> bool:
    """Whether a data x spatial step splits the rows of a global batch of
    ``batch`` over the data ranks: when each micro-batch divides over them,
    else (the JAX package's ``pin_micro``) every data rank runs every row."""
    if batch % grad_accum:
        raise ValueError(f"batch size {batch} is not divisible by grad_accum={grad_accum}")
    return (batch // grad_accum) % mesh.n_data == 0


def row_runs(batch: int, mesh, grad_accum: int = 1) -> list:
    """The rows of a global batch of ``batch`` that this rank takes to its
    card (:func:`local_row_runs` over ``mesh.rows``): under a data x spatial
    mesh, its data rank's share of every micro-batch, or its data rank's
    block of the batch where a micro-batch does not divide over the data
    ranks (the step gathers the whole batch then: :func:`rows_split`)."""
    if isinstance(mesh, SpatialMesh):
        return local_row_runs(batch, mesh.data,
                              grad_accum if rows_split(batch, mesh, grad_accum) else 1)
    return local_row_runs(batch, mesh, grad_accum)


def take_runs(v, runs: list):
    """The rows ``runs`` (slices) of an array or tensor, by slicing: no index
    tensor goes to the device, so nothing waits for the card's queue."""
    if len(runs) == 1:
        return v[runs[0]]
    parts = [v[s] for s in runs]
    return np.concatenate(parts) if isinstance(v, np.ndarray) else torch.cat(parts)


def shard_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows (:func:`row_runs`) of every array or tensor of a
    global batch dict, whole volumes under a data x spatial mesh too (the
    steps keep the depth slab); other entries (subject id lists) pass
    through. The rows stay where they were: the steps move them to the
    state's device."""
    n = next(v.shape[0] for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)))
    runs = row_runs(n, mesh, grad_accum)
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
