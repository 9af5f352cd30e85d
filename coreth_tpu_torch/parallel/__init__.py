"""Sharded replay state on one card: placement, collectives and the
per-block sharded steps."""

from coreth_tpu_torch.parallel.mesh import (  # noqa: F401
    MAX_SHARDS, ShardMesh, collective_reduce_plain, make_mesh,
    sharded_slot_step, sharded_slot_step_plain, sharded_transfer_step,
    sharded_transfer_step_plain, step_design,
)
from coreth_tpu_torch.parallel.shard import (  # noqa: F401
    account_bucket, contract_bucket, exchange_mode, remap_rows, slot_bucket,
)
