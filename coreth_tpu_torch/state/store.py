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

Over a key-value store (``kv=``, ``rawdb``), the store is the
reference's ``Database(node_db=PersistentNodeDict(kv),
code_db=PersistentCodeDict(kv))``: ``commit()`` writes every trie's
hashed nodes into the node store (``commit_into`` on the C++ tries,
``commit`` on the Python ones), the code store writes through, and
``root=`` opens the tries at a state root from the nodes, for either
backend (``open_trie``).  A contract's storage trie is then opened at
its account's root the first time it is asked for.  Nodes reach the
key-value store only when a checkpoint flushes them
(``replay/checkpoint.py``), under the reference's keys, so either
package opens a store the other wrote.
"""

from __future__ import annotations

from typing import Optional

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.mpt.native_trie import (
    CheckedSecureTrie, NativeSecureTrie,
)
from coreth_tpu_torch.mpt.trie import MissingNodeError, SecureTrie
from coreth_tpu_torch.rawdb import PersistentCodeDict, PersistentNodeDict
from coreth_tpu_torch.types.account import (
    EMPTY_CODE_HASH, EMPTY_ROOT_HASH, StateAccount,
)

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


class _StorageTries(dict):
    """addr -> the contract's storage trie.  Over a node store, a trie
    missing here opens at its account's root the first time it is asked
    for (a store opened at a root holds the account trie only); a root
    whose node is not in the node store raises ``MissingNodeError``, as
    the reference's first read of such a trie does."""

    def __init__(self, store: "StateStore"):
        super().__init__()
        self._store = store

    def _open(self, addr: bytes):
        store = self._store
        if store.kv is None:
            return None
        raw = store.trie.get(addr)
        root = StateAccount.from_rlp(raw).root if raw is not None \
            else EMPTY_ROOT_HASH
        if root == EMPTY_ROOT_HASH:
            return None
        if root not in store.node_db:
            # a missing node closure must not read as empty storage
            raise MissingNodeError(
                f"storage trie of {addr.hex()} (root {root.hex()}) is "
                "not in the node store")
        trie = store.open_trie(root)
        dict.__setitem__(self, addr, trie)
        return trie

    def get(self, addr: bytes, default=None):
        trie = dict.get(self, addr)
        if trie is None:
            trie = self._open(addr)
        return default if trie is None else trie

    def __contains__(self, addr) -> bool:
        return self.get(addr) is not None

    def __getitem__(self, addr: bytes):
        trie = self.get(addr)
        if trie is None:
            raise KeyError(addr.hex())
        return trie


class StateStore:
    """Account trie + per-contract storage tries + code store, in memory
    or (``kv=``) over a key-value store's node and code records, opened
    at ``root`` when one is given."""

    def __init__(self, trie=None, backend: str = "native",
                 check: bool = False, kv=None,
                 root: Optional[bytes] = None):
        _check_backend(backend, check)
        if root is not None and (kv is None or trie is not None):
            raise ValueError("root= opens the tries from a kv= store")
        self.backend = backend
        self.check = check
        self.kv = kv
        if kv is None:
            self.node_db = {}
            self.codes = {}
        else:
            self.node_db = PersistentNodeDict(kv)
            self.codes = PersistentCodeDict(kv)
        dict.__setitem__(self.codes, EMPTY_CODE_HASH, b"")
        if root is not None:
            trie = self.open_trie(root)
        self.trie = trie if trie is not None else self.new_trie()
        self.storage = _StorageTries(self)
        self.fault_observer = None
        self.host_exec_check = False

    def new_trie(self):
        """An empty secure trie of the store's backend."""
        if self.backend == "py":
            return SecureTrie(db=self.node_db)
        return CheckedSecureTrie(SecureTrie(db=self.node_db)) \
            if self.check else NativeSecureTrie()

    def open_trie(self, root: bytes):
        """A secure trie of the store's backend at ``root``, read from
        the node store (a C++ trie is seeded from the Python one)."""
        base = SecureTrie(root_hash=root, db=self.node_db)
        if self.backend == "py":
            return base
        return CheckedSecureTrie(base) if self.check \
            else NativeSecureTrie.from_python_trie(base)

    def commit_trie(self, trie) -> bytes:
        """Write ``trie``'s hashed nodes into the node store; returns its
        root."""
        if self.backend == "py":
            return trie.commit()
        return trie.commit_into(self.node_db)

    def commit(self) -> bytes:
        """Write every trie's hashed nodes into the node store (not yet
        into the key-value store: a checkpoint flushes them) and return
        the state root.  An in-memory store has nothing to write."""
        if self.kv is None:
            return self.trie.hash()
        for st in dict.values(self.storage):
            self.commit_trie(st)
        return self.commit_trie(self.trie)

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

