"""Device meshes and batch sharding over the visible cards (port of
`if_defense_tpu/parallel`).

The reference shards attack batches across GPUs with NCCL DDP and per-rank
npz shards merged offline (`baselines/attack_scripts/targeted_perturb_
attack.py:99-174`). The JAX package shards one batch axis over a
`jax.sharding.Mesh`. The port does the same by hand: a batch is split into
contiguous per-device chunks (`shard_batch`), the model is copied to each
device once (`replicate`), one thread per device runs its chunk
(`run_shards`) and the results are concatenated in shard order. A split
train step takes its means and batch-norm statistics over the whole batch
(`batch_stats`).
"""

from if_defense_tpu_torch.parallel.batch_stats import (
    StatsExchange,
    batch_mean,
    current_exchange,
    shard_of,
)
from if_defense_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    Mesh,
    ShardAborted,
    best_data_mesh,
    data_parallel_mesh,
    get_mesh,
    mesh_devices,
    replicate,
    run_shards,
    shard_batch,
    visible_devices,
)

__all__ = [
    "BATCH_AXIS",
    "Mesh",
    "ShardAborted",
    "StatsExchange",
    "batch_mean",
    "best_data_mesh",
    "current_exchange",
    "data_parallel_mesh",
    "get_mesh",
    "mesh_devices",
    "replicate",
    "run_shards",
    "shard_batch",
    "shard_of",
    "visible_devices",
]
