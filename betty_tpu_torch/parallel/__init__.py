"""Data-parallel strategies over ``torch.distributed``
(``betty_tpu/parallel/__init__.py``'s names, but ``tp_shardings``: tensor,
pipeline, expert and sequence parallelism are ROADMAP.md §A.7's next
slice). See ``parallel/mesh.py`` and ``parallel/collectives.py``."""

from betty_tpu_torch.parallel.collectives import (
    all_reduce_tree,
    gather_shards,
    global_divisor,
    global_mean,
    global_sum,
    grad_mean,
    rank_share,
    reduce_scatter_mean,
)
from betty_tpu_torch.parallel.mesh import (
    DP_STRATEGIES,
    Mesh,
    active,
    batch_sharding,
    current,
    fsdp_shardings,
    is_rank_zero,
    local_rows,
    make_global_batch,
    make_mesh,
    maybe_init_distributed,
    replicated,
    shard_state,
    state_shard_dims,
    world_size,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "fsdp_shardings",
    "shard_state",
    "make_global_batch",
    "maybe_init_distributed",
    "Mesh",
    "DP_STRATEGIES",
    "state_shard_dims",
    "active",
    "current",
    "is_rank_zero",
    "local_rows",
    "world_size",
    "grad_mean",
    "all_reduce_tree",
    "global_sum",
    "global_mean",
    "global_divisor",
    "rank_share",
    "gather_shards",
    "reduce_scatter_mean",
]
