"""Data and tensor parallelism on torch.distributed (port of
navc_tpu/parallel): one rank per device, the ('data', 'model') rank grid,
its sharding rules and the collectives the training step makes."""

from .distributed import (  # noqa: F401
    initialize, is_primary, primary_only, process_count, process_index, rank_device)
from .mesh import (  # noqa: F401
    Mesh, ShardedParams, generate_sharded, make_mesh, param_pspec, shard_batch,
    shard_params)
