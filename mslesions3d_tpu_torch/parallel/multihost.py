"""Several processes, one rank a card, over one node or several.

Counterpart of ``mslesions3d_tpu/parallel/multihost.py``. There one process
per host drives its chips and ``jax.distributed`` joins the hosts; here one
process per card joins a ``torch.distributed`` process group, started by
``torchrun`` (its ``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``) or by explicit arguments. A JAX
"process" (a host and its chips) is a node of ranks here: the rank grid of
:func:`dcn_friendly_mesh` puts the data axis across nodes, the only traffic
that crosses them being the data-parallel sums. Each rank feeds its
:func:`shard_global_batch` rows of a global batch: those of the data mesh's
``shard_batch``, which are :func:`process_batch_slice`'s at ``grad_accum=1``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's card on its node (torchrun's ``LOCAL_RANK``; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None, device="cuda",
                         timeout_s: float | None = None) -> bool:
    """Join the process group when running several processes; no-op otherwise.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to torchrun's environment. With one process and
    no address nothing is started. On a card the process takes
    ``cuda:LOCAL_RANK`` first; the backend is NCCL there and gloo on the
    CPU unless ``backend`` names another. The group's world size and
    backend are printed. Returns whether more than one process is joined.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    if coordinator_address is None and world <= 1:
        return False
    rank = int(process_id if process_id is not None else env["RANK"])
    address = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None else local_rank())
    backend = backend or default_backend(device)
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank, **kwargs)
    print(f"[multihost] process group of {world} ranks, backend {backend}; this is rank "
          f"{rank}", flush=True)
    return world > 1


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """Ranks laid out on named axes, the JAX package's ``Mesh`` of devices."""

    ranks: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def dcn_friendly_mesh(data_per_slice: int | None = None, axis_names=("data", "model"),
                      world_size: int | None = None,
                      local_world_size: int | None = None) -> RankGrid:
    """Rank grid (nodes x data_local, model) whose data axis crosses nodes.

    Ranks are numbered node by node (torchrun's order), so reshaping
    (nodes, ranks per node) and splitting a node's ranks into (data_local,
    model) keeps the model axis inside a node and lets the data axis span
    nodes. ``world_size`` and ``local_world_size`` default to the process
    group's and torchrun's ``LOCAL_WORLD_SIZE`` (one node without it).
    """
    n = world_size if world_size is not None else _world()[0]
    per_proc = int(local_world_size if local_world_size is not None
                   else os.environ.get("LOCAL_WORLD_SIZE", n))
    n_proc = n // per_proc
    if data_per_slice is None:
        model, data_local = 1, per_proc
    else:
        if per_proc % data_per_slice:
            raise ValueError(
                f"data_per_slice={data_per_slice} does not divide the "
                f"{per_proc} devices per process; choose a divisor of "
                f"{per_proc} (got {n_proc} processes x {per_proc} devices)"
            )
        model, data_local = per_proc // data_per_slice, data_per_slice
    return RankGrid(np.arange(n).reshape(n_proc * data_local, model), tuple(axis_names))


def process_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows [i B / P, (i + 1) B / P) of a global
    batch B over P processes, as the JAX package's; a ragged B raises. With
    one rank a process these are :func:`shard_global_batch`'s rows at
    ``grad_accum=1``."""
    p, i = _world()
    if global_batch % p:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {p}"
        )
    local = global_batch // p
    return slice(i * local, (i + 1) * local)


def shard_global_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows of every array of a global batch dict, on the mesh's
    device; id lists pass through. The rows are ``shard_batch``'s (the r-th
    share of every micro-batch), the one rule the steps assume."""
    from .mesh import shard_batch

    return {k: torch.as_tensor(v, device=mesh.device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in shard_batch(batch, mesh, grad_accum).items()}
