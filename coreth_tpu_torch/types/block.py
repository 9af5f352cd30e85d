"""Block header + block with the Avalanche extras.

Twin of reference core/types/block.go + block_ext.go.  Header RLP field
order (including the coreth-specific ExtDataHash and the optional trailing
BaseFee / ExtDataGasUsed / BlockGasCost) is consensus-critical: the block
hash is keccak256 of this encoding (block.go:73-108, 126).  Block wire
encoding is the coreth ``extblock``: [header, txs, uncles, version,
extdata] (block.go:177-183).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.types.transaction import Transaction

HASH_ZERO = b"\x00" * 32
ADDR_ZERO = b"\x00" * 20

# keccak256(rlp(empty list)) — hash of the empty uncle set.
EMPTY_UNCLE_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347")
# keccak256(rlp(b"")) — root of the empty trie / ExtDataHash of no extdata.
from coreth_tpu_torch.types.account import EMPTY_ROOT_HASH  # noqa: E402
EMPTY_EXT_DATA_HASH = EMPTY_ROOT_HASH


def calc_ext_data_hash(extdata: bytes) -> bytes:
    if not extdata:
        return EMPTY_EXT_DATA_HASH
    return keccak256(rlp.encode(extdata))


@dataclass
class Header:
    parent_hash: bytes = HASH_ZERO
    uncle_hash: bytes = EMPTY_UNCLE_HASH
    coinbase: bytes = ADDR_ZERO
    root: bytes = HASH_ZERO
    tx_hash: bytes = EMPTY_ROOT_HASH
    receipt_hash: bytes = EMPTY_ROOT_HASH
    bloom: bytes = b"\x00" * 256
    difficulty: int = 0
    number: int = 0
    gas_limit: int = 0
    gas_used: int = 0
    time: int = 0
    extra: bytes = b""
    mix_digest: bytes = HASH_ZERO
    nonce: bytes = b"\x00" * 8
    ext_data_hash: bytes = EMPTY_EXT_DATA_HASH
    # Optional trailing fields (present iff the fork introduced them):
    base_fee: Optional[int] = None          # ApricotPhase3 (EIP-1559 analog)
    ext_data_gas_used: Optional[int] = None  # ApricotPhase4
    block_gas_cost: Optional[int] = None     # ApricotPhase4

    def rlp_items(self) -> list:
        items = [
            self.parent_hash,
            self.uncle_hash,
            self.coinbase,
            self.root,
            self.tx_hash,
            self.receipt_hash,
            self.bloom,
            rlp.encode_uint(self.difficulty),
            rlp.encode_uint(self.number),
            rlp.encode_uint(self.gas_limit),
            rlp.encode_uint(self.gas_used),
            rlp.encode_uint(self.time),
            self.extra,
            self.mix_digest,
            self.nonce,
            self.ext_data_hash,
        ]
        # Optional trailing fields: emitted left-to-right while set, a later
        # field forces earlier ones to zero (go-rlp "optional" semantics).
        tail = [self.base_fee, self.ext_data_gas_used, self.block_gas_cost]
        last = -1
        for i, v in enumerate(tail):
            if v is not None:
                last = i
        for i in range(last + 1):
            items.append(rlp.encode_uint(tail[i] or 0))
        return items

    def encode(self) -> bytes:
        return rlp.encode(self.rlp_items())

    @classmethod
    def from_rlp_items(cls, items: list) -> "Header":
        if len(items) < 16:
            raise ValueError("malformed header RLP")
        h = cls(
            parent_hash=items[0], uncle_hash=items[1], coinbase=items[2],
            root=items[3], tx_hash=items[4], receipt_hash=items[5],
            bloom=items[6], difficulty=rlp.decode_uint(items[7]),
            number=rlp.decode_uint(items[8]),
            gas_limit=rlp.decode_uint(items[9]),
            gas_used=rlp.decode_uint(items[10]),
            time=rlp.decode_uint(items[11]), extra=items[12],
            mix_digest=items[13], nonce=items[14], ext_data_hash=items[15],
        )
        if len(items) > 16:
            h.base_fee = rlp.decode_uint(items[16])
        if len(items) > 17:
            h.ext_data_gas_used = rlp.decode_uint(items[17])
        if len(items) > 18:
            h.block_gas_cost = rlp.decode_uint(items[18])
        return h

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        return cls.from_rlp_items(rlp.decode(data))

    def hash(self) -> bytes:
        return keccak256(self.encode())

    def copy(self) -> "Header":
        return Header(**{k: getattr(self, k) for k in self.__dataclass_fields__})


class Block:
    """A block: header + txs + uncles + coreth (version, extdata)."""

    def __init__(self, header: Header,
                 transactions: Optional[List[Transaction]] = None,
                 uncles: Optional[List[Header]] = None,
                 version: int = 0, extdata: Optional[bytes] = None):
        self.header = header
        self.transactions: List[Transaction] = transactions or []
        self.uncles: List[Header] = uncles or []
        self.version = version
        self.extdata = extdata
        self._hash: Optional[bytes] = None

    # --- accessors ---------------------------------------------------------
    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = self.header.hash()
        return self._hash

    @property
    def number(self) -> int:
        return self.header.number

    @property
    def parent_hash(self) -> bytes:
        return self.header.parent_hash

    @property
    def root(self) -> bytes:
        return self.header.root

    @property
    def gas_limit(self) -> int:
        return self.header.gas_limit

    @property
    def gas_used(self) -> int:
        return self.header.gas_used

    @property
    def time(self) -> int:
        return self.header.time

    @property
    def base_fee(self) -> Optional[int]:
        return self.header.base_fee

    def ext_data(self) -> bytes:
        return self.extdata or b""

    # --- encoding (extblock, reference block.go:259-280) -------------------
    def encode(self) -> bytes:
        return rlp.encode([
            self.header.rlp_items(),
            [tx.inner.payload_rlp_items() if tx.tx_type == 0 else tx.encode()
             for tx in self.transactions],
            [u.rlp_items() for u in self.uncles],
            rlp.encode_uint(self.version),
            self.extdata if self.extdata is not None else b"",
        ])

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        items = rlp.decode(data)
        if not isinstance(items, list) or len(items) != 5:
            raise ValueError("malformed block RLP")
        header = Header.from_rlp_items(items[0])
        txs = []
        for t in items[1]:
            if isinstance(t, list):  # legacy tx as nested list
                txs.append(Transaction.decode(rlp.encode(t)))
            else:  # typed tx as byte string
                txs.append(Transaction.decode(t))
        uncles = [Header.from_rlp_items(u) for u in items[2]]
        version = rlp.decode_uint(items[3])
        extdata = items[4] if items[4] else None
        return cls(header, txs, uncles, version, extdata)
