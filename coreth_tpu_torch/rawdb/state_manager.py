"""Trie-node and contract-code mappings over a key-value store.

Port of reference ``rawdb/state_manager.py``'s two mappings (the
commit-interval ``TrieWriter`` belongs to the chain and is not part of
the port yet).  Trie code expects a mapping; these give it one with a
``KVStore`` behind it, under the schema's ``n`` (nodes) and ``c``
(code) prefixes, so a store either package wrote opens in the other.
"""

from __future__ import annotations

from typing import List

from coreth_tpu_torch.rawdb import schema
from coreth_tpu_torch.rawdb.kv import KVStore


class PersistentNodeDict(dict):
    """Trie-node mapping with a KVStore behind it: reads fall through
    to the store, writes stay in memory on a pending list until
    ``flush()`` copies them down (a checkpoint flushes them before it
    writes its record)."""

    PREFIX = schema.NODE_PREFIX

    def __init__(self, kv: KVStore):
        super().__init__()
        self.kv = kv
        self.pending: List[bytes] = []

    def get(self, key, default=None):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        v = self.kv.get(self.PREFIX + key)
        if v is not None:
            dict.__setitem__(self, key, v)
            return v
        return default

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key.hex())
        return v

    def __contains__(self, key):
        return self.get(key) is not None

    def __setitem__(self, key, value):
        is_new = not dict.__contains__(self, key)
        # value before pending: a concurrent flush that pops the key
        # must always see the value (nodes are never deleted, so a
        # popped key with a visible value cannot be lost)
        dict.__setitem__(self, key, value)
        if is_new:
            self.pending.append(key)

    def flush(self) -> int:
        """Write pending nodes to the store; returns the count.
        Pop-based, so one thread can flush while another keeps
        appending (each pop is atomic under the GIL; a key appended
        mid-flush is either written now or stays pending)."""
        n = 0
        while self.pending:
            try:
                key = self.pending.pop()
            except IndexError:
                break
            v = dict.get(self, key)
            if v is not None:
                self.kv.put(self.PREFIX + key, v)
                n += 1
        return n


class PersistentCodeDict(dict):
    """Contract-code mapping over a KVStore: write-through (code is
    small and immutable), read-through on a miss, so deployed code
    survives a restart."""

    PREFIX = schema.CODE_PREFIX

    def __init__(self, kv: KVStore):
        super().__init__()
        self.kv = kv

    def get(self, key, default=None):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        v = self.kv.get(self.PREFIX + key)
        if v is not None:
            dict.__setitem__(self, key, v)
            return v
        return default

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key.hex())
        return v

    def __contains__(self, key):
        return self.get(key) is not None

    def __setitem__(self, key, value):
        dict.__setitem__(self, key, value)
        self.kv.put(self.PREFIX + key, value)

    def items(self):
        # the live view is the union of memory and store; memory wins
        seen = set()
        for k, v in dict.items(self):
            seen.add(k)
            yield k, v
        for k, v in self.kv.items():
            if k[:1] == self.PREFIX and k[1:] not in seen:
                yield k[1:], v
