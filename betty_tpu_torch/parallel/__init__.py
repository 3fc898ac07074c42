"""The strategies over ``torch.distributed``: data parallelism (dp,
distributed, zero, fsdp), tensor parallelism (tp, ``tp_shardings`` with
``Config.shard_rules``), expert parallelism (ep), pipeline parallelism (pp:
GPipe over stage-stacked blocks, ``parallel/pipeline.py``) and sequence
parallelism (sp) (``betty_tpu/parallel/__init__.py``'s names). A mesh takes
up to four different model axes, its leaves cut on a dim for each
(``mesh.Cut``): the JAX package's ``dp x mdl x pp`` composition runs
Megatron tensor parallelism over ``mdl`` inside each GPipe stage over
``pp``, ``mdl x sp`` runs it inside each sequence-parallel block
(Megatron-SP), and ``ep x mdl`` cuts the MoE's experts over ``ep`` and
their hidden columns over ``mdl`` (``MOE_COMPOSED_SHARD_RULES``); an axis
a module does not split repeats its work (``mdl x pp x sp``, ``mdl x sp x
ep``, ``ep x mdl x pp``, ``ep x mdl x pp x sp``). See ``parallel/mesh.py``,
``parallel/collectives.py`` and ``parallel/pipeline.py``."""

from betty_tpu_torch.parallel.collectives import (
    all_reduce_tree,
    clip_by_sharded_norm,
    copy_to_model,
    cut_whole,
    gather_shards,
    global_divisor,
    global_mean,
    global_sum,
    grad_mean,
    rank_share,
    reduce_from_model,
    reduce_scatter_mean,
    ring_shift,
    seq_gather,
    seq_split,
    sharded_dot,
    sharded_norm,
)
from betty_tpu_torch.parallel.mesh import (
    DP_STRATEGIES,
    MODEL_STRATEGIES,
    MOE_COMPOSED_SHARD_RULES,
    Cut,
    Mesh,
    active,
    batch_coordinates,
    batch_sharding,
    current,
    ep_rules,
    fsdp_shardings,
    is_rank_zero,
    local_rows,
    make_global_batch,
    make_mesh,
    maybe_init_distributed,
    mesh_shape,
    model_mesh,
    pp_rules,
    replicated,
    shard_state,
    state_shard_dims,
    strategy_matches,
    tp_shardings,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "batch_coordinates",
    "replicated",
    "fsdp_shardings",
    "tp_shardings",
    "ep_rules",
    "pp_rules",
    "strategy_matches",
    "shard_state",
    "make_global_batch",
    "maybe_init_distributed",
    "mesh_shape",
    "Mesh",
    "Cut",
    "DP_STRATEGIES",
    "MODEL_STRATEGIES",
    "MOE_COMPOSED_SHARD_RULES",
    "state_shard_dims",
    "active",
    "current",
    "model_mesh",
    "is_rank_zero",
    "local_rows",
    "grad_mean",
    "all_reduce_tree",
    "global_sum",
    "global_mean",
    "global_divisor",
    "rank_share",
    "gather_shards",
    "cut_whole",
    "reduce_scatter_mean",
    "copy_to_model",
    "reduce_from_model",
    "ring_shift",
    "seq_split",
    "seq_gather",
    "sharded_dot",
    "sharded_norm",
    "clip_by_sharded_norm",
]
