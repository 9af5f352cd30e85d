"""C++-backed tries — the replay engine's commit-path backend.

A cut of reference ``mpt/native_trie.py``: the secure (keccak-keyed)
account/storage trie over the C++ trie handle API of
``native/baseline.cc``, with the window-batched fold-and-root calls
(``fold_storage``, ``fold_accounts_root``) that commit a whole deduped
window in one ctypes crossing per trie, and the ordered trie that
``derive_sha`` hashes tx and receipt lists into.  The port has no
Python trie: roots are checked against the block headers, which is
what keeps the C++ folds honest here.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.crypto import native as _native

_declared = False


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
        self._lib.coreth_trie_delete(self.h, keccak256(key))

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
