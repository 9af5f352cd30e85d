"""Receipts, logs, and the 2048-bit log bloom.

Twin of reference core/types/receipt.go + bloom9.go + log.go.  Only the
consensus encoding (the one hashed into the receipt root) is implemented
here; storage encodings are a host-persistence detail handled by the db
layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256

RECEIPT_STATUS_FAILED = 0
RECEIPT_STATUS_SUCCESSFUL = 1


@dataclass
class Log:
    address: bytes = b"\x00" * 20
    topics: List[bytes] = field(default_factory=list)
    data: bytes = b""
    # Derived (non-consensus) metadata:
    block_number: int = 0
    tx_hash: bytes = b"\x00" * 32
    tx_index: int = 0
    block_hash: bytes = b"\x00" * 32
    index: int = 0
    removed: bool = False

    def rlp_items(self) -> list:
        return [self.address, list(self.topics), self.data]


@dataclass
class Receipt:
    tx_type: int = 0
    status: int = RECEIPT_STATUS_SUCCESSFUL
    post_state: bytes = b""  # pre-Byzantium root (unused on Avalanche nets)
    cumulative_gas_used: int = 0
    logs: List[Log] = field(default_factory=list)
    # Derived fields:
    tx_hash: bytes = b"\x00" * 32
    contract_address: Optional[bytes] = None
    gas_used: int = 0
    effective_gas_price: int = 0
    block_hash: bytes = b"\x00" * 32
    block_number: int = 0
    transaction_index: int = 0
    # lazily-computed cache; logs are write-once in practice
    _bloom: Optional[bytes] = None

    @property
    def bloom(self) -> bytes:
        if self._bloom is None:
            self._bloom = logs_bloom(self.logs)
        return self._bloom

    def _status_item(self) -> bytes:
        if self.post_state:
            return self.post_state
        return rlp.encode_uint(self.status)

    def encode_consensus(self) -> bytes:
        """The bytes hashed into the receipt trie (receipt.go encodeTyped)."""
        payload = rlp.encode([
            self._status_item(),
            rlp.encode_uint(self.cumulative_gas_used),
            self.bloom,
            [log.rlp_items() for log in self.logs],
        ])
        if self.tx_type == 0:
            return payload
        return bytes([self.tx_type]) + payload


from functools import lru_cache


@lru_cache(maxsize=1 << 16)
def bloom9(value: bytes) -> int:
    """Bloom bits for one value as an int (reference bloom9.go:139-159).

    Three bit positions from the first 6 bytes of keccak256(value), each
    position = 11 low bits of a big-endian byte pair.

    Memoized: bloomed values repeat heavily (contract addresses, event
    signature topics, recurring account topics), and the replay hot
    path blooms every log twice — once into the receipt bloom, once
    into the header bloom."""
    h = keccak256(value)
    out = 0
    for i in (0, 2, 4):
        bit = ((h[i] << 8) | h[i + 1]) & 0x7FF
        out |= 1 << bit
    return out


def logs_bloom(logs: List[Log]) -> bytes:
    bits = 0
    for log in logs:
        bits |= bloom9(log.address)
        for topic in log.topics:
            bits |= bloom9(topic)
    return bits.to_bytes(256, "big")


def create_bloom(receipts: List[Receipt]) -> bytes:
    return logs_bloom([log for r in receipts for log in r.logs])

