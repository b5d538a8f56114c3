"""Data, spatial and tensor parallelism over cards and hosts (counterpart of
``mslesions3d_tpu/parallel``).

The data mesh and the multi-host helpers (``mesh.py``, ``multihost.py``),
spatial sharding (a data x spatial mesh, the volume depth split over cards
with halo-exchanged convs, ``spatial.py``) and tensor parallelism (a data x
spatial x model mesh, conv channels split over the model axis,
``tensor.py``), each a grid of ``torch.distributed`` groups, one rank a card.
"""

from .collectives import (
    Split,
    all_reduce_sum,
    broadcast,
    channel_slice,
    copy_to_model,
    current_model,
    current_split,
    current_stats_group,
    data_parallel,
    exchange_rows,
    gather_channels,
    gather_depth,
    gather_rows,
    halo,
    past_the_cut,
    reduce_partial,
    scatter_channels,
)
from .mesh import (
    DataMesh,
    SpatialMesh,
    TensorMesh,
    local_row_runs,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
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
from .tensor import (
    leaf_spec,
    make_tensor_parallel_forward,
    shard_tree,
    tensor_sharding,
    unshard_tree,
)

__all__ = [
    "Split", "all_reduce_sum", "broadcast", "current_split", "current_stats_group", "data_parallel",
    "exchange_rows", "gather_depth", "gather_rows", "halo", "past_the_cut", "DataMesh",
    "SpatialMesh", "local_row_runs", "make_mesh", "make_mesh_2d", "replicate", "row_runs",
    "rows_split", "shard_batch",
    "take_runs", "visible_devices", "dcn_friendly_mesh", "initialize_multihost",
    "process_batch_slice", "shard_global_batch", "batch_sharding_fn", "depth_slab",
    "make_spatially_sharded_forward", "shard_batch_spatial", "channel_slice", "copy_to_model",
    "current_model", "gather_channels", "reduce_partial", "scatter_channels", "TensorMesh",
    "make_mesh_3d", "leaf_spec", "make_tensor_parallel_forward", "shard_tree",
    "tensor_sharding", "unshard_tree",
]
