"""Consensus types: transactions, headers, blocks, receipts, logs, accounts.

Semantic twin of reference ``core/types/`` with the Avalanche extras
(Header ExtDataHash / ExtDataGasUsed / BlockGasCost, Block ExtData,
StateAccount multicoin flag).
"""

from coreth_tpu_torch.types.account import (  # noqa: F401
    EMPTY_CODE_HASH,
    EMPTY_ROOT_HASH,
    StateAccount,
)
from coreth_tpu_torch.types.transaction import (  # noqa: F401
    AccessListTx,
    DynamicFeeTx,
    LegacyTx,
    Transaction,
    LatestSigner,
    sign_tx,
)
from coreth_tpu_torch.types.receipt import (  # noqa: F401
    Log,
    Receipt,
    bloom9,
    logs_bloom,
    create_bloom,
)
from coreth_tpu_torch.types.block import Block, Header  # noqa: F401
from coreth_tpu_torch.types.hashing import derive_sha  # noqa: F401
