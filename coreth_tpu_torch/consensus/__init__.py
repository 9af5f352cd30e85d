"""Consensus: the dummy engine's fee rules (reference consensus/dummy/)."""

from coreth_tpu_torch.consensus.dynamic_fees import (  # noqa: F401
    block_gas_cost,
    calc_base_fee,
    calc_block_gas_cost,
)
from coreth_tpu_torch.consensus.engine import (  # noqa: F401
    ConsensusCallbacks,
    ConsensusError,
    DummyEngine,
)
