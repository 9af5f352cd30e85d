"""Durable storage: the key-value stores, the schema's flat-state and
checkpoint accessors, and the trie-node / code mappings over a store.

Port of reference ``rawdb/`` cut to what replay checkpoints need:
``FileDB`` (the append-only log with the torn-tail truncation on
reopen), ``MemDB``, the schema's flat entries, flat meta stamp and
replay-checkpoint record (byte-identical keys and RLP, so either
package reads a store the other wrote), and ``PersistentNodeDict`` /
``PersistentCodeDict``.  The freezer and the block / receipt accessors
belong to the chain and are not part of the port yet.
"""

from coreth_tpu_torch.rawdb.kv import FileDB, KVStore, MemDB
from coreth_tpu_torch.rawdb import schema
from coreth_tpu_torch.rawdb.state_manager import (
    PersistentCodeDict, PersistentNodeDict,
)

__all__ = ["FileDB", "KVStore", "MemDB", "PersistentCodeDict",
           "PersistentNodeDict", "schema"]
