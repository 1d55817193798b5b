"""repro_torch.dist — the distributed layer, on ``torch.distributed``.

Four concerns, four modules:

- :mod:`repro_torch.dist.context` — mesh axis conventions (``DATA``/
  ``MODEL``/``POD``), per-dim :class:`PartitionSpec` and
  :class:`NamedSharding` and their DTensor placements, the ``use_mesh``
  ambient-mesh context, and the divisibility-aware hint layer
  (``shard_hint`` / ``shard_decode_kv``), a no-op without an active mesh.
- :mod:`repro_torch.dist.sharding` — path-based parameter sharding rules
  over ``Model.param_struct()`` trees, batch sharding with pod→data
  folding, and decode-cache shardings.
- :mod:`repro_torch.dist.comm` — the checkpoint library's communicator over
  a ``torch.distributed`` world (gloo groups of its own).
- :mod:`repro_torch.dist.compression` — the int8 payload codec.

Checkpointing interaction: shardings live *outside* the checkpoint. The
pipeline's Plan stage snapshots sharded (``DTensor``) leaves
**shard-locally** (the box this rank owns, never a gathered global array;
``core/resharding.snapshot_shards``), Pack spreads the boxes over
``rank<r>.shard<j>.chk5`` files with a cross-rank index, and restore reads
exactly the box each rank of the restart template's mesh needs
(``core/resharding.assemble_onto``) — so a checkpoint written under one
mesh restores under another, or on another number of processes.
"""
from repro_torch.dist.context import (  # noqa: F401
    DATA,
    MODEL,
    POD,
    AbstractMesh,
    NamedSharding,
    P,
    PartitionSpec,
    constraint_hints,
    data_axes,
    resolve_spec,
    shard_decode_kv,
    shard_hint,
    use_mesh,
)
from repro_torch.dist.sharding import (  # noqa: F401
    batch_sharding,
    cache_shardings,
    param_shardings,
)
