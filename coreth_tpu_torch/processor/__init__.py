"""Block processing: message transition + block processor.

Semantic twin of reference core/state_transition.go +
core/state_processor.go.  This is the bit-identical contract between the
host execution path and the batched device replay engine.
"""

from coreth_tpu_torch.processor.message import Message, tx_to_message  # noqa: F401
from coreth_tpu_torch.processor.state_transition import (  # noqa: F401
    ExecutionResult,
    GasPool,
    apply_message,
    intrinsic_gas,
)
from coreth_tpu_torch.processor.state_processor import (  # noqa: F401
    Processor,
    apply_transaction,
)
