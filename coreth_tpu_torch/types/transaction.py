"""Transactions: legacy, EIP-2930 access-list, EIP-1559 dynamic-fee.

Twin of reference core/types/{transaction.go, tx_legacy.go,
tx_access_list.go, tx_dynamic_fee.go, transaction_signing.go}.  The wire
formats and signing hashes are Ethereum protocol facts; the object model
(one frozen dataclass per inner payload + a thin ``Transaction`` wrapper
with a cached sender) is our own.

Access lists are ``[(address20, [key32, ...]), ...]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.crypto import secp256k1

LEGACY_TX_TYPE = 0x00
ACCESS_LIST_TX_TYPE = 0x01
DYNAMIC_FEE_TX_TYPE = 0x02

AccessList = List[Tuple[bytes, List[bytes]]]


def _al_rlp(access_list: AccessList) -> list:
    return [[addr, list(keys)] for addr, keys in access_list]


def _al_from_rlp(items) -> AccessList:
    return [(tup[0], list(tup[1])) for tup in items]


def _rlp_item_end(buf: bytes, pos: int) -> int:
    """End offset of the RLP item starting at ``pos`` (no decode)."""
    b0 = buf[pos]
    if b0 < 0x80:
        return pos + 1
    if b0 < 0xB8:
        return pos + 1 + (b0 - 0x80)
    if b0 < 0xC0:
        ll = b0 - 0xB7
        return pos + 1 + ll + int.from_bytes(buf[pos + 1:pos + 1 + ll],
                                             "big")
    if b0 < 0xF8:
        return pos + 1 + (b0 - 0xC0)
    ll = b0 - 0xF7
    return pos + 1 + ll + int.from_bytes(buf[pos + 1:pos + 1 + ll],
                                         "big")


def _typed_sighash_from_wire(wire: bytes, keep: int) -> bytes:
    """Signing hash of a DECODED typed tx straight from its wire bytes.

    The typed sighash is keccak(type || rlp(items[:-3])) and the wire
    encoding is type || rlp(items): the unsigned payload is a contiguous
    SLICE of the wire bytes, so re-wrapping that slice in a fresh list
    header replaces a full per-field RLP re-encode (visible at replay
    scale: the native baseline gets its sighashes packed outside the
    timed loop, this is the decoded-object equivalent)."""
    b0 = wire[1]
    hs = 1 if b0 < 0xF8 else 1 + (b0 - 0xF7)
    start = 1 + hs
    pos = start
    for _ in range(keep):
        pos = _rlp_item_end(wire, pos)
    body = wire[start:pos]
    return keccak256(
        wire[:1] + rlp._encode_length(len(body), 0xC0) + body)


@dataclass
class LegacyTx:
    nonce: int = 0
    gas_price: int = 0
    gas: int = 0
    to: Optional[bytes] = None  # None = contract creation
    value: int = 0
    data: bytes = b""
    v: int = 0
    r: int = 0
    s: int = 0

    tx_type = LEGACY_TX_TYPE

    @property
    def gas_tip_cap(self) -> int:
        return self.gas_price

    @property
    def gas_fee_cap(self) -> int:
        return self.gas_price

    @property
    def access_list(self) -> AccessList:
        return []

    @property
    def chain_id(self) -> Optional[int]:
        # Derived from V for EIP-155 signatures (transaction_signing.go).
        if self.v in (27, 28) or self.v == 0:
            return None
        return (self.v - 35) // 2

    def payload_rlp_items(self) -> list:
        return [
            rlp.encode_uint(self.nonce),
            rlp.encode_uint(self.gas_price),
            rlp.encode_uint(self.gas),
            self.to if self.to is not None else b"",
            rlp.encode_uint(self.value),
            self.data,
            rlp.encode_uint(self.v),
            rlp.encode_uint(self.r),
            rlp.encode_uint(self.s),
        ]

    def encode(self) -> bytes:
        return rlp.encode(self.payload_rlp_items())

    def sig_hash(self, chain_id: Optional[int]) -> bytes:
        fields = [
            rlp.encode_uint(self.nonce),
            rlp.encode_uint(self.gas_price),
            rlp.encode_uint(self.gas),
            self.to if self.to is not None else b"",
            rlp.encode_uint(self.value),
            self.data,
        ]
        if chain_id is not None:  # EIP-155
            fields += [rlp.encode_uint(chain_id), b"", b""]
        return keccak256(rlp.encode(fields))

    def raw_signature(self) -> Tuple[int, int, int]:
        """(r, s, recid) from the stored V."""
        if self.v in (27, 28):
            return self.r, self.s, self.v - 27
        return self.r, self.s, (self.v - 35) & 1

    def with_signature(self, r: int, s: int, recid: int,
                       chain_id: Optional[int]) -> "LegacyTx":
        v = (35 + 2 * chain_id + recid) if chain_id is not None else 27 + recid
        return LegacyTx(self.nonce, self.gas_price, self.gas, self.to,
                        self.value, self.data, v, r, s)


@dataclass
class AccessListTx:
    chain_id_: int = 0
    nonce: int = 0
    gas_price: int = 0
    gas: int = 0
    to: Optional[bytes] = None
    value: int = 0
    data: bytes = b""
    al: AccessList = field(default_factory=list)
    v: int = 0
    r: int = 0
    s: int = 0

    tx_type = ACCESS_LIST_TX_TYPE

    @property
    def gas_tip_cap(self) -> int:
        return self.gas_price

    @property
    def gas_fee_cap(self) -> int:
        return self.gas_price

    @property
    def access_list(self) -> AccessList:
        return self.al

    @property
    def chain_id(self) -> int:
        return self.chain_id_

    def payload_rlp_items(self) -> list:
        return [
            rlp.encode_uint(self.chain_id_),
            rlp.encode_uint(self.nonce),
            rlp.encode_uint(self.gas_price),
            rlp.encode_uint(self.gas),
            self.to if self.to is not None else b"",
            rlp.encode_uint(self.value),
            self.data,
            _al_rlp(self.al),
            rlp.encode_uint(self.v),
            rlp.encode_uint(self.r),
            rlp.encode_uint(self.s),
        ]

    def encode(self) -> bytes:
        return bytes([self.tx_type]) + rlp.encode(self.payload_rlp_items())

    def sig_hash(self, chain_id: Optional[int]) -> bytes:
        if chain_id is not None and chain_id != self.chain_id_:
            raise ValueError(
                f"tx chain id {self.chain_id_} != signer chain id {chain_id}")
        wire = getattr(self, "_wire", None)
        if wire is not None:
            return _typed_sighash_from_wire(wire, 8)
        fields = self.payload_rlp_items()[:-3]
        return keccak256(bytes([self.tx_type]) + rlp.encode(fields))

    def raw_signature(self) -> Tuple[int, int, int]:
        return self.r, self.s, self.v

    def with_signature(self, r, s, recid, chain_id) -> "AccessListTx":
        return AccessListTx(self.chain_id_, self.nonce, self.gas_price,
                            self.gas, self.to, self.value, self.data,
                            list(self.al), recid, r, s)


@dataclass
class DynamicFeeTx:
    chain_id_: int = 0
    nonce: int = 0
    gas_tip_cap_: int = 0
    gas_fee_cap_: int = 0
    gas: int = 0
    to: Optional[bytes] = None
    value: int = 0
    data: bytes = b""
    al: AccessList = field(default_factory=list)
    v: int = 0
    r: int = 0
    s: int = 0

    tx_type = DYNAMIC_FEE_TX_TYPE

    @property
    def gas_price(self) -> int:
        return self.gas_fee_cap_

    @property
    def gas_tip_cap(self) -> int:
        return self.gas_tip_cap_

    @property
    def gas_fee_cap(self) -> int:
        return self.gas_fee_cap_

    @property
    def access_list(self) -> AccessList:
        return self.al

    @property
    def chain_id(self) -> int:
        return self.chain_id_

    def payload_rlp_items(self) -> list:
        return [
            rlp.encode_uint(self.chain_id_),
            rlp.encode_uint(self.nonce),
            rlp.encode_uint(self.gas_tip_cap_),
            rlp.encode_uint(self.gas_fee_cap_),
            rlp.encode_uint(self.gas),
            self.to if self.to is not None else b"",
            rlp.encode_uint(self.value),
            self.data,
            _al_rlp(self.al),
            rlp.encode_uint(self.v),
            rlp.encode_uint(self.r),
            rlp.encode_uint(self.s),
        ]

    def encode(self) -> bytes:
        return bytes([self.tx_type]) + rlp.encode(self.payload_rlp_items())

    def sig_hash(self, chain_id: Optional[int]) -> bytes:
        if chain_id is not None and chain_id != self.chain_id_:
            raise ValueError(
                f"tx chain id {self.chain_id_} != signer chain id {chain_id}")
        wire = getattr(self, "_wire", None)
        if wire is not None:
            return _typed_sighash_from_wire(wire, 9)
        fields = self.payload_rlp_items()[:-3]
        return keccak256(bytes([self.tx_type]) + rlp.encode(fields))

    def raw_signature(self) -> Tuple[int, int, int]:
        return self.r, self.s, self.v

    def with_signature(self, r, s, recid, chain_id) -> "DynamicFeeTx":
        return DynamicFeeTx(self.chain_id_, self.nonce, self.gas_tip_cap_,
                            self.gas_fee_cap_, self.gas, self.to, self.value,
                            self.data, list(self.al), recid, r, s)


class Transaction:
    """Wrapper with cached hash/size/sender (reference transaction.go:53)."""

    __slots__ = ("inner", "_hash", "_sender")

    def __init__(self, inner):
        self.inner = inner
        self._hash: Optional[bytes] = None
        self._sender: Optional[bytes] = None

    # --- passthrough accessors --------------------------------------------
    @property
    def tx_type(self) -> int:
        return self.inner.tx_type

    @property
    def nonce(self) -> int:
        return self.inner.nonce

    @property
    def gas(self) -> int:
        return self.inner.gas

    @property
    def gas_price(self) -> int:
        return self.inner.gas_price

    @property
    def gas_tip_cap(self) -> int:
        return self.inner.gas_tip_cap

    @property
    def gas_fee_cap(self) -> int:
        return self.inner.gas_fee_cap

    @property
    def to(self) -> Optional[bytes]:
        return self.inner.to

    @property
    def value(self) -> int:
        return self.inner.value

    @property
    def data(self) -> bytes:
        return self.inner.data

    @property
    def access_list(self) -> AccessList:
        return self.inner.access_list

    @property
    def chain_id(self):
        return self.inner.chain_id

    def effective_gas_tip(self, base_fee: Optional[int]) -> int:
        """min(tip cap, fee cap - baseFee); negative => underpriced."""
        if base_fee is None:
            return self.gas_tip_cap
        return min(self.gas_tip_cap, self.gas_fee_cap - base_fee)

    def cost(self) -> int:
        return self.gas * self.gas_fee_cap + self.value

    # --- encoding ----------------------------------------------------------
    def encode(self) -> bytes:
        """Canonical wire encoding (binary for typed txs, RLP for legacy)."""
        return self.inner.encode()

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        if not data:
            raise ValueError("empty tx bytes")
        if data[0] >= 0xC0:  # RLP list => legacy
            items = rlp.decode(data)
            if len(items) != 9:
                raise ValueError("malformed legacy tx")
            return cls(LegacyTx(
                nonce=rlp.decode_uint(items[0]),
                gas_price=rlp.decode_uint(items[1]),
                gas=rlp.decode_uint(items[2]),
                to=items[3] if items[3] else None,
                value=rlp.decode_uint(items[4]),
                data=items[5],
                v=rlp.decode_uint(items[6]),
                r=rlp.decode_uint(items[7]),
                s=rlp.decode_uint(items[8]),
            ))
        typ = data[0]
        items = rlp.decode(data[1:])
        if typ == ACCESS_LIST_TX_TYPE:
            if len(items) != 11:
                raise ValueError("malformed access-list tx")
            inner = AccessListTx(
                chain_id_=rlp.decode_uint(items[0]),
                nonce=rlp.decode_uint(items[1]),
                gas_price=rlp.decode_uint(items[2]),
                gas=rlp.decode_uint(items[3]),
                to=items[4] if items[4] else None,
                value=rlp.decode_uint(items[5]),
                data=items[6],
                al=_al_from_rlp(items[7]),
                v=rlp.decode_uint(items[8]),
                r=rlp.decode_uint(items[9]),
                s=rlp.decode_uint(items[10]),
            )
            inner._wire = data  # sighash slices the original bytes
            return cls(inner)
        if typ == DYNAMIC_FEE_TX_TYPE:
            if len(items) != 12:
                raise ValueError("malformed dynamic-fee tx")
            inner = DynamicFeeTx(
                chain_id_=rlp.decode_uint(items[0]),
                nonce=rlp.decode_uint(items[1]),
                gas_tip_cap_=rlp.decode_uint(items[2]),
                gas_fee_cap_=rlp.decode_uint(items[3]),
                gas=rlp.decode_uint(items[4]),
                to=items[5] if items[5] else None,
                value=rlp.decode_uint(items[6]),
                data=items[7],
                al=_al_from_rlp(items[8]),
                v=rlp.decode_uint(items[9]),
                r=rlp.decode_uint(items[10]),
                s=rlp.decode_uint(items[11]),
            )
            inner._wire = data  # sighash slices the original bytes
            return cls(inner)
        raise ValueError(f"unknown tx type {typ:#x}")

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = keccak256(self.encode())
        return self._hash

    def size(self) -> int:
        return len(self.encode())

    # --- sender cache (reference sender_cacher / Sender) -------------------
    def cached_sender(self) -> Optional[bytes]:
        return self._sender

    def set_sender(self, addr: bytes) -> None:
        self._sender = addr


class LatestSigner:
    """Signer accepting every tx type, EIP-155-protected legacy included.

    Twin of reference transaction_signing.go LatestSigner / londonSigner.
    """

    def __init__(self, chain_id: int):
        self.chain_id = chain_id

    def sig_hash(self, tx: Transaction) -> bytes:
        inner = tx.inner
        if inner.tx_type == LEGACY_TX_TYPE:
            # Protected iff v encodes a chain id (or unsigned: use ours).
            cid = inner.chain_id if inner.v else self.chain_id
            return inner.sig_hash(cid)
        return inner.sig_hash(self.chain_id)

    def sender(self, tx: Transaction) -> bytes:
        inner = tx.inner
        if inner.tx_type != LEGACY_TX_TYPE and inner.chain_id != self.chain_id:
            raise ValueError("invalid chain id for signer")
        if inner.tx_type == LEGACY_TX_TYPE and inner.v not in (27, 28):
            if inner.chain_id != self.chain_id:
                raise ValueError("invalid chain id for signer")
        cached = tx.cached_sender()
        if cached is not None:
            return cached
        r, s, recid = inner.raw_signature()
        # Signature-value validation (reference transaction_signing.go:571
        # recoverPlain -> crypto.ValidateSignatureValues, homestead rules):
        # r,s in [1, N-1], low-s (EIP-2), y-parity in {0, 1}.  Rejecting
        # high-s kills tx malleability; geth/coreth enforce this for every
        # chain transaction.
        if recid not in (0, 1):
            raise ValueError("invalid signature y-parity")
        if not (0 < r < secp256k1.N and 0 < s <= secp256k1.N // 2):
            raise ValueError("invalid signature values")
        addr = secp256k1.recover_address(self.sig_hash(tx), r, s, recid)
        tx.set_sender(addr)
        return addr


def sign_tx(inner, priv: int, chain_id: int) -> Transaction:
    """Sign a payload with a private key; returns the wrapped Transaction."""
    sig_hash = inner.sig_hash(chain_id)
    r, s, recid = secp256k1.sign(sig_hash, priv)
    signed = inner.with_signature(r, s, recid, chain_id)
    tx = Transaction(signed)
    tx.set_sender(secp256k1.priv_to_address(priv))
    return tx
