"""C++-backed tries — the replay engine's commit-path backend.

Port of reference ``mpt/native_trie.py``: the secure (keccak-keyed)
account/storage trie over the C++ trie handle API of
``native/baseline.cc``, with the window-batched fold-and-root calls
(``fold_storage``, ``fold_accounts_root``) that commit a whole deduped
window in one ctypes crossing per trie, ``from_python_trie`` (a C++
trie seeded from a Python trie's leaves), ``commit_into`` (the trie's
hashed nodes exported into a node store), and the ordered trie that ``derive_sha`` hashes tx and receipt
lists into.

``CheckedSecureTrie`` is the reference's ``CORETH_TRIE_CHECK=1``
oracle (the engine's ``trie_check=True``): a C++ trie with its Python
twin (``mpt/trie.py``), every mutation applied to both and every root
re-derived on the twin.  The reference's backend switch
(``CORETH_TRIE``, ``backend()``) is the engine's ``trie=`` keyword, and
``require()`` is what a ``trie="native"`` engine calls: unlike the
reference, which quietly takes the Python trie when the library does
not load, it raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.crypto import native as _native
from coreth_tpu_torch.mpt.trie import Trie, nibbles_to_key
from coreth_tpu_torch.types.account import StateAccount

_declared = False


def require() -> None:
    """Raise unless the C++ trie library loads."""
    _lib()


class TrieOracleError(AssertionError):
    """``trie_check`` divergence: native and Python roots differ."""


def _lib():
    lib = _native._require()
    global _declared
    if not _declared:
        lib.coreth_trie_new.restype = ctypes.c_void_p
        lib.coreth_trie_new.argtypes = []
        lib.coreth_trie_free.argtypes = [ctypes.c_void_p]
        lib.coreth_trie_free.restype = None
        lib.coreth_trie_update_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64]
        lib.coreth_trie_update_batch.restype = None
        lib.coreth_trie_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32)]
        lib.coreth_trie_get.restype = ctypes.c_int
        lib.coreth_trie_hash.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.coreth_trie_hash.restype = None
        lib.coreth_trie_delete.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p]
        lib.coreth_trie_delete.restype = None
        lib.coreth_trie_fold_storage.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p]
        lib.coreth_trie_fold_storage.restype = None
        lib.coreth_trie_fold_accounts_root.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p]
        lib.coreth_trie_fold_accounts_root.restype = None
        lib.coreth_trie_update_ordered.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64]
        lib.coreth_trie_update_ordered.restype = None
        lib.coreth_trie_export.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.coreth_trie_export.restype = ctypes.c_uint64
        _declared = True
    return lib


class _Handle:
    def __init__(self):
        self._lib = _lib()
        self.h = self._lib.coreth_trie_new()

    def __del__(self):
        if getattr(self, "h", None):
            self._lib.coreth_trie_free(self.h)
            self.h = None

    def hash(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.coreth_trie_hash(self.h, out)
        return out.raw


class NativeSecureTrie(_Handle):
    """Secure trie: keys are keccak-hashed before they reach the trie."""

    def get(self, key: bytes) -> Optional[bytes]:
        return self.get_hashed(keccak256(key))

    def update(self, key: bytes, value: bytes) -> None:
        self.update_hashed(keccak256(key), value)

    def delete(self, key: bytes) -> None:
        self.delete_hashed(keccak256(key))

    def delete_hashed(self, key32: bytes) -> None:
        self._lib.coreth_trie_delete(self.h, key32)

    def get_hashed(self, key32: bytes) -> Optional[bytes]:
        cap = 4096
        out = ctypes.create_string_buffer(cap)
        ln = ctypes.c_uint32()
        if not self._lib.coreth_trie_get(self.h, key32, out, cap,
                                         ctypes.byref(ln)):
            return None
        if ln.value > cap:
            out = ctypes.create_string_buffer(ln.value)
            self._lib.coreth_trie_get(self.h, key32, out, ln.value,
                                      ctypes.byref(ln))
        return out.raw[:ln.value]

    def update_hashed(self, key32: bytes, value: bytes) -> None:
        lens = (ctypes.c_uint32 * 1)(len(value))
        self._lib.coreth_trie_update_batch(self.h, key32, value, lens, 1)

    @classmethod
    def from_python_trie(cls, trie: Trie) -> "NativeSecureTrie":
        """Seed from a Python Trie / SecureTrie (the keys it holds are
        already keccak-hashed; ``items()`` yields their nibbles)."""
        out = cls()
        for nibs, value in trie.items():
            out.update_hashed(nibbles_to_key(nibs), value)
        return out

    def commit_into(self, node_db) -> bytes:
        """Export every hashed node changed since the last export into
        ``node_db`` (hash -> node RLP); returns the root."""
        need = self._lib.coreth_trie_export(self.h, None, 0)
        if need:
            buf = ctypes.create_string_buffer(int(need))
            self._lib.coreth_trie_export(self.h, buf, need)
            raw = buf.raw
            off = 0
            while off < need:
                ln = int.from_bytes(raw[off + 32:off + 36], "little")
                node_db[raw[off:off + 32]] = raw[off + 36:off + 36 + ln]
                off += 36 + ln
        return self.hash()

    def fold_storage(self, keys32: bytes, vals32: bytes, n: int) -> bytes:
        """Fold a deduped window of storage writes (pre-hashed keys,
        raw 32-byte BE values, zero => delete); returns the new root."""
        if len(keys32) != 32 * n or len(vals32) != 32 * n:
            raise ValueError("storage fold buffers disagree with n")
        out = ctypes.create_string_buffer(32)
        self._lib.coreth_trie_fold_storage(self.h, keys32, vals32, n, out)
        return out.raw

    def fold_accounts_root(self, keys32: bytes, balances32: bytes,
                           nonces, roots32: bytes, code_hashes32: bytes,
                           mc: bytes, deletes: bytes) -> bytes:
        """Account fold (C++ RLP encoding) + rehash in one crossing."""
        n = len(deletes)
        if (len(keys32) != 32 * n or len(balances32) != 32 * n
                or len(nonces) != n or len(roots32) != 32 * n
                or len(code_hashes32) != 32 * n or len(mc) != n):
            raise ValueError("account fold buffers disagree with n")
        arr = (ctypes.c_uint64 * n)(*nonces)
        out = ctypes.create_string_buffer(32)
        self._lib.coreth_trie_fold_accounts_root(
            self.h, keys32, balances32, arr, roots32, code_hashes32, mc,
            deletes, n, out)
        return out.raw


class NativeOrderedTrie(_Handle):
    """derive_sha hasher: ``update`` buffers host-side, ``hash`` folds
    the rlp(index)-keyed items in ONE ctypes crossing."""

    def __init__(self):
        super().__init__()
        self._keys: List[bytes] = []
        self._vals: List[bytes] = []

    def update(self, key: bytes, value: bytes) -> None:
        if len(key) > 16:
            # the C++ ordered fold walks at most 16 key bytes (rlp(u64
            # index) caps at 9): a longer key would be truncated
            raise ValueError(
                f"NativeOrderedTrie keys cap at 16 bytes; got {len(key)}")
        self._keys.append(key)
        self._vals.append(value)

    def hash(self) -> bytes:
        n = len(self._keys)
        if n:
            kl = (ctypes.c_uint32 * n)(*map(len, self._keys))
            vl = (ctypes.c_uint32 * n)(*map(len, self._vals))
            self._lib.coreth_trie_update_ordered(
                self.h, b"".join(self._keys), kl, b"".join(self._vals),
                vl, n)
            self._keys.clear()
            self._vals.clear()
        return super().hash()


def derive_hasher() -> NativeOrderedTrie:
    """A fresh hasher for ``types.derive_sha``."""
    return NativeOrderedTrie()


class CheckedSecureTrie:
    """The ``trie_check`` differential oracle (reference
    ``CORETH_TRIE_CHECK=1``).

    Wraps a native trie and its Python ``SecureTrie`` twin: every
    mutation (the window-batched folds included) applies to BOTH, and
    every root derivation re-derives the root on the Python trie and
    raises ``TrieOracleError`` on the first divergence.  A debug / test
    mode: the twin costs the full Python fold the C++ trie exists to
    avoid."""

    def __init__(self, py_trie: Trie):
        self.py = py_trie
        self.native = NativeSecureTrie.from_python_trie(py_trie)
        self._check(seed=True)

    def _py_update_hashed(self, key32: bytes, value: bytes) -> None:
        # Trie.update on the twin writes by PRE-HASHED key (SecureTrie
        # would hash again)
        Trie.update(self.py, key32, value)

    def _check(self, seed: bool = False) -> bytes:
        n = self.native.hash()
        p = self.py.hash()
        if n != p:
            raise TrieOracleError(
                f"trie oracle divergence{' at seed' if seed else ''}: "
                f"native {n.hex()} != py {p.hex()}")
        return n

    # ------------------------------------------------------ secure ops
    def get(self, key: bytes) -> Optional[bytes]:
        return self.native.get(key)

    def update(self, key: bytes, value: bytes) -> None:
        self.native.update(key, value)
        self.py.update(key, value)

    def delete(self, key: bytes) -> None:
        self.native.delete(key)
        self.py.delete(key)

    def hash(self) -> bytes:
        return self._check()

    def commit_into(self, node_db) -> bytes:
        """Export the C++ trie's nodes into ``node_db`` and commit the
        twin into its own node store; the two roots must agree."""
        root = self.native.commit_into(node_db)
        py_root = self.py.commit()
        if root != py_root:
            raise TrieOracleError(
                f"trie oracle divergence at commit: native "
                f"{root.hex()} != py {py_root.hex()}")
        return root

    # ----------------------------------------------- window fold-and-root
    def fold_storage(self, keys32: bytes, vals32: bytes, n: int) -> bytes:
        root = self.native.fold_storage(keys32, vals32, n)
        for i in range(n):
            v = vals32[32 * i:32 * i + 32].lstrip(b"\x00")
            self._py_update_hashed(keys32[32 * i:32 * i + 32],
                                   rlp.encode(v) if v else b"")
        py_root = self.py.hash()
        if root != py_root:
            raise TrieOracleError(
                f"storage fold divergence: native {root.hex()} != "
                f"py {py_root.hex()}")
        return root

    def fold_accounts_root(self, keys32: bytes, balances32: bytes, nonces,
                           roots32: bytes, code_hashes32: bytes, mc: bytes,
                           deletes: bytes) -> bytes:
        root = self.native.fold_accounts_root(
            keys32, balances32, nonces, roots32, code_hashes32, mc,
            deletes)
        for i in range(len(deletes)):
            key32 = keys32[32 * i:32 * i + 32]
            if deletes[i]:
                self._py_update_hashed(key32, b"")
                continue
            self._py_update_hashed(key32, StateAccount(
                nonce=int(nonces[i]),
                balance=int.from_bytes(balances32[32 * i:32 * i + 32],
                                       "big"),
                root=roots32[32 * i:32 * i + 32],
                code_hash=code_hashes32[32 * i:32 * i + 32],
                is_multi_coin=bool(mc[i])).rlp())
        py_root = self.py.hash()
        if root != py_root:
            raise TrieOracleError(
                f"account fold divergence: native {root.hex()} != "
                f"py {py_root.hex()}")
        return root
