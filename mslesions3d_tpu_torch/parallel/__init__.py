"""Data parallelism over cards and hosts (counterpart of ``mslesions3d_tpu/parallel``).

Ported: the data mesh and the multi-host helpers. Not ported yet: spatial
sharding (``parallel/spatial.py``, ROADMAP item 17c) and tensor parallelism
(``parallel/tensor.py``, item 17d).
"""

from .collectives import all_reduce_sum, broadcast, current_mesh, data_parallel, gather_rows
from .mesh import (
    DataMesh,
    local_row_runs,
    make_mesh,
    replicate,
    shard_batch,
    take_runs,
    visible_devices,
)
from .multihost import (
    dcn_friendly_mesh,
    initialize_multihost,
    process_batch_slice,
    shard_global_batch,
)

__all__ = [
    "all_reduce_sum", "broadcast", "current_mesh", "data_parallel", "gather_rows", "DataMesh",
    "local_row_runs", "make_mesh", "replicate", "shard_batch", "take_runs",
    "visible_devices", "dcn_friendly_mesh", "initialize_multihost", "process_batch_slice",
    "shard_global_batch",
]
