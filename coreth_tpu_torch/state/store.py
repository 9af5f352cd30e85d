"""World state held in the repo's C++ tries.

The port's stand-in for the reference's state ``Database`` (trie node
store + code store), cut to what replay needs: the account trie, one
secure storage trie per contract (advanced in place, so each trie is
always at its account's current root), and the code store keyed by
code hash.  The chain builder and every replay engine own separate
stores: each advances its tries independently, and the roots are held
against the block headers.
"""

from __future__ import annotations

from typing import Dict, Optional

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.mpt import NativeSecureTrie
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH


def normalize_state_key(key: bytes) -> bytes:
    """The normal-storage partition of a slot key: bit 0 of byte 0
    cleared (Avalanche multicoin split, statedb.normalize_state_key)."""
    return bytes([key[0] & 0xFE]) + key[1:]


class StateStore:
    """Account trie + per-contract storage tries + code store."""

    def __init__(self, trie: Optional[NativeSecureTrie] = None):
        self.trie = trie if trie is not None else NativeSecureTrie()
        self.storage: Dict[bytes, NativeSecureTrie] = {}
        self.codes: Dict[bytes, bytes] = {EMPTY_CODE_HASH: b""}

    def storage_trie(self, addr: bytes) -> NativeSecureTrie:
        """The contract's storage trie (an empty one on first use)."""
        st = self.storage.get(addr)
        if st is None:
            st = self.storage[addr] = NativeSecureTrie()
        return st

    def storage_value(self, addr: bytes, key: bytes) -> int:
        """Committed value of (normalized) slot ``key``."""
        st = self.storage.get(addr)
        raw = st.get(key) if st is not None else None
        return int.from_bytes(rlp.decode(raw), "big") if raw else 0

    def set_storage(self, addr: bytes, key: bytes, value: int) -> None:
        st = self.storage_trie(addr)
        if value:
            st.update(key, rlp.encode(
                value.to_bytes(32, "big").lstrip(b"\x00")))
        elif st.get(key) is not None:
            st.delete(key)

    def put_code(self, code: bytes) -> bytes:
        h = keccak256(code)
        self.codes[h] = code
        return h

    def code(self, code_hash: bytes) -> bytes:
        return self.codes[code_hash]

