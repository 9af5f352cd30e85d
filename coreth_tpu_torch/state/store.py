"""World state held in secure tries: the repo's C++ tries or Python ones.

The port's stand-in for the reference's state ``Database`` (trie node
store + code store), cut to what replay needs: the account trie, one
secure storage trie per contract (advanced in place, so each trie is
always at its account's current root), and the code store keyed by
code hash.  The chain builder and every replay engine own separate
stores: each advances its tries independently, and the roots are held
against the block headers.

``backend`` picks the tries: ``"native"`` (the C++ ``NativeSecureTrie``,
the default), ``"py"`` (``mpt/trie.py``'s ``SecureTrie``, the
reference's ``CORETH_TRIE=py``), or ``"native"`` with ``check`` (the
``CheckedSecureTrie`` oracle, ``CORETH_TRIE_CHECK=1``).  Every trie the
store hands out comes from ``new_trie``, so storage tries made later
(a contract's first write, a StateDB's fresh account) share it.  A
replay engine takes the store as it is, and refuses one whose backend
is not the engine's ``trie=`` / ``trie_check=``.

``fault_observer`` and ``host_exec_check`` are the replay engine's
supervisor and oracle switch, read by the hostexec bridge through the
StateDB of the store (the reference stamps its ``Database`` the same
way), so engines in one process keep separate ladders.
"""

from __future__ import annotations

from typing import Dict

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.mpt.native_trie import (
    CheckedSecureTrie, NativeSecureTrie,
)
from coreth_tpu_torch.mpt.trie import SecureTrie
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH

BACKENDS = ("native", "py")


def normalize_state_key(key: bytes) -> bytes:
    """The normal-storage partition of a slot key: bit 0 of byte 0
    cleared (Avalanche multicoin split, statedb.normalize_state_key)."""
    return bytes([key[0] & 0xFE]) + key[1:]


def _check_backend(backend: str, check: bool) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"trie backend {backend!r}: 'native' or 'py'")
    if check and backend != "native":
        raise ValueError("the trie check re-derives the C++ trie's roots "
                         "on the Python trie: it needs backend 'native'")


class StateStore:
    """Account trie + per-contract storage tries + code store."""

    def __init__(self, trie=None, backend: str = "native",
                 check: bool = False):
        _check_backend(backend, check)
        self.backend = backend
        self.check = check
        self.trie = trie if trie is not None else self.new_trie()
        self.storage: Dict[bytes, object] = {}
        self.codes: Dict[bytes, bytes] = {EMPTY_CODE_HASH: b""}
        self.fault_observer = None
        self.host_exec_check = False

    def new_trie(self):
        """An empty secure trie of the store's backend."""
        if self.backend == "py":
            return SecureTrie()
        return CheckedSecureTrie(SecureTrie()) if self.check \
            else NativeSecureTrie()

    def storage_trie(self, addr: bytes):
        """The contract's storage trie (an empty one on first use)."""
        st = self.storage.get(addr)
        if st is None:
            st = self.storage[addr] = self.new_trie()
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

