"""Device meshes on `torch.distributed`, sharding helpers, and the host->card
prefetch (the counterpart of `v2a_tpu/parallel/__init__.py`)."""

from v2a_tpu_torch.parallel.mesh import Mesh, local_batch_multiple, make_mesh
from v2a_tpu_torch.parallel.multihost import initialize_distributed, make_hybrid_mesh
from v2a_tpu_torch.parallel.prefetch import PrefetchIterator
from v2a_tpu_torch.parallel.sharding import (
    batch_sharding,
    dp_axis_names,
    replicate,
    shard_batch,
    shard_train_state,
    tp_leaf_spec,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "local_batch_multiple",
    "initialize_distributed",
    "make_hybrid_mesh",
    "batch_sharding",
    "dp_axis_names",
    "replicate",
    "shard_batch",
    "shard_train_state",
    "tp_leaf_spec",
    "PrefetchIterator",
]
