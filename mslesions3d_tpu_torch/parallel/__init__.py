"""Data parallelism and spatial sharding over cards and hosts (counterpart of
``mslesions3d_tpu/parallel``).

Ported: the data mesh, the multi-host helpers and spatial sharding (a data x
spatial mesh, the volume depth split over cards with halo-exchanged convs,
``spatial.py``). Not ported yet: tensor parallelism (``parallel/tensor.py``,
ROADMAP item 17d).
"""

from .collectives import (
    Split,
    all_reduce_sum,
    broadcast,
    current_split,
    current_stats_group,
    data_parallel,
    exchange_rows,
    gather_depth,
    gather_rows,
    halo,
    past_the_cut,
)
from .mesh import (
    DataMesh,
    SpatialMesh,
    local_row_runs,
    make_mesh,
    make_mesh_2d,
    replicate,
    row_runs,
    rows_split,
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
from .spatial import (
    batch_sharding_fn,
    depth_slab,
    make_spatially_sharded_forward,
    shard_batch_spatial,
)

__all__ = [
    "Split", "all_reduce_sum", "broadcast", "current_split", "current_stats_group", "data_parallel",
    "exchange_rows", "gather_depth", "gather_rows", "halo", "past_the_cut", "DataMesh",
    "SpatialMesh", "local_row_runs", "make_mesh", "make_mesh_2d", "replicate", "row_runs",
    "rows_split", "shard_batch",
    "take_runs", "visible_devices", "dcn_friendly_mesh", "initialize_multihost",
    "process_batch_slice", "shard_global_batch", "batch_sharding_fn", "depth_slab",
    "make_spatially_sharded_forward", "shard_batch_spatial",
]
