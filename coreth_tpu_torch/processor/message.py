"""Message: the EVM-facing view of a transaction.

Twin of reference core/state_transition.go:185 (Message) + :204
(TransactionToMessage): the effective gas price is resolved here —
min(feeCap, baseFee+tip) post-AP3 — and the sender is recovered via the
signer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from coreth_tpu_torch.types.transaction import Transaction, LatestSigner


@dataclass
class Message:
    from_: bytes = b"\x00" * 20
    to: Optional[bytes] = None
    nonce: int = 0
    value: int = 0
    gas_limit: int = 0
    gas_price: int = 0
    gas_fee_cap: Optional[int] = None
    gas_tip_cap: Optional[int] = None
    data: bytes = b""
    access_list: List[Tuple[bytes, List[bytes]]] = field(default_factory=list)
    # Set for RPC calls (eth_call/estimateGas) — skips nonce/EOA checks.
    skip_account_checks: bool = False


def tx_to_message(tx: Transaction, signer: LatestSigner,
                  base_fee: Optional[int]) -> Message:
    """TransactionToMessage (state_transition.go:204)."""
    sender = signer.sender(tx)
    gas_price = tx.gas_price
    if base_fee is not None:
        # effective price: min(feeCap, baseFee + tip)
        gas_price = min(tx.gas_fee_cap, base_fee + tx.gas_tip_cap)
    return Message(
        from_=sender,
        to=tx.to,
        nonce=tx.nonce,
        value=tx.value,
        gas_limit=tx.gas,
        gas_price=gas_price,
        gas_fee_cap=tx.gas_fee_cap,
        gas_tip_cap=tx.gas_tip_cap,
        data=tx.data,
        access_list=list(tx.access_list),
    )
