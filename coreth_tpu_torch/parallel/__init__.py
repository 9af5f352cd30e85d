"""Sharded replay state on one card: placement and collectives."""

from coreth_tpu_torch.parallel.mesh import (  # noqa: F401
    MAX_SHARDS, ShardMesh, collective_reduce_plain, make_mesh,
)
from coreth_tpu_torch.parallel.shard import (  # noqa: F401
    account_bucket, contract_bucket, exchange_mode, remap_rows, slot_bucket,
)
