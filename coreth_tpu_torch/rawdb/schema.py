"""The schema's flat-state and replay-checkpoint accessors.

Port of reference ``rawdb/schema.py``, cut to the three parts replay
checkpoints use: the flat-state entries, the flat meta stamp and the
replay-checkpoint record.  Keys and RLP are byte-identical to the
reference's, so either package reads a store the other wrote:

  'c' ++ code_hash                 -> contract code (PersistentCodeDict)
  'n' ++ node_hash                 -> trie node (PersistentNodeDict)
  'ReplayCheckpoint'[/worker]      -> rlp([num, hash, root, header-rlp])
  'fa' ++ keccak(addr)             -> rlp([num8, addr, account-fields])
  'fs' ++ keccak(addr) ++ slot     -> rlp([num8, addr, value])
  'fb' ++ keccak(addr)             -> num8 (storage barrier)
  'FlatMeta'                       -> rlp([num8, root])

Every flat value carries the writing generation's block number and the
raw-address preimage (the in-memory flat store is raw-keyed; keccak is
not invertible), so a reload can both rebuild the raw-keyed dicts and
skip entries newer than the checkpoint record it resumes from.  A
barrier marks an account destructed (or deleted) in that generation:
persisted 'fs' entries stamped BELOW it are dead (the same generation's
re-create writes, stamped equal, survive).  Without it a destruct and
re-create would resurrect stale slot values on reload (old entries are
never individually deletable: keccak keys are not enumerable per
account).
"""

from __future__ import annotations

from typing import Optional

from coreth_tpu_torch import rlp
from coreth_tpu_torch.rawdb.kv import KVStore

CODE_PREFIX = b"c"
NODE_PREFIX = b"n"
REPLAY_CHECKPOINT_KEY = b"ReplayCheckpoint"
FLAT_ACCOUNT_PREFIX = b"fa"
FLAT_STORAGE_PREFIX = b"fs"
FLAT_BARRIER_PREFIX = b"fb"
FLAT_META_KEY = b"FlatMeta"


def _num8(n: int) -> bytes:
    return n.to_bytes(8, "big")


# ------------------------------------------------------- replay checkpoint

def replay_checkpoint_key(worker: Optional[str] = None) -> bytes:
    """The checkpoint-record key, optionally scoped to one lane: a
    single engine keeps the bare key; a worker writing lane ``w``
    records under ``ReplayCheckpoint/w``, so lanes can share a store (or
    copies of one) without clobbering each other's records."""
    if worker is None:
        return REPLAY_CHECKPOINT_KEY
    return REPLAY_CHECKPOINT_KEY + b"/" + worker.encode()


def write_replay_checkpoint(kv: KVStore, number: int, block_hash: bytes,
                            root: bytes, header_rlp: bytes,
                            worker: Optional[str] = None) -> None:
    """The replay-resume record (replay/checkpoint.py): the last
    committed block's number and hash, the state root the engine's
    tries stand at, and the full header RLP (the resumed engine's
    ``parent_header``: AP4 fee validation needs the real parent's
    block_gas_cost and time)."""
    kv.put(replay_checkpoint_key(worker), rlp.encode([
        rlp.encode_uint(number), block_hash, root, header_rlp]))


def read_replay_checkpoint(kv: KVStore, worker: Optional[str] = None):
    """(number, block_hash, root, header_rlp) or None."""
    raw = kv.get(replay_checkpoint_key(worker))
    if raw is None:
        return None
    number, block_hash, root, header_rlp = rlp.decode(raw)
    return rlp.decode_uint(number), block_hash, root, header_rlp


# -------------------------------------------------------------- flat state

def write_flat_account(kv: KVStore, addr_hash: bytes, number: int,
                       addr: bytes, account) -> None:
    """One flat-base account entry.  ``account`` is the flat store's
    (balance, nonce, root, code_hash, multicoin) tuple, or None for a
    known-deleted account (the tombstone form)."""
    if account is None:
        fields = []
    else:
        balance, nonce, root, code_hash, multicoin = account
        fields = [rlp.encode_uint(balance), rlp.encode_uint(nonce),
                  root, code_hash, rlp.encode_uint(1 if multicoin
                                                   else 0)]
    kv.put(FLAT_ACCOUNT_PREFIX + addr_hash,
           rlp.encode([_num8(number), addr, fields]))


def parse_flat_account(key: bytes, value: bytes):
    """(number, addr, account_tuple | None) when ``key`` is a flat
    account entry, else None (not this table)."""
    if key[:2] != FLAT_ACCOUNT_PREFIX or len(key) != 2 + 32:
        return None
    number, addr, fields = rlp.decode(value)
    if not fields:
        return int.from_bytes(number, "big"), addr, None
    balance, nonce, root, code_hash, mc = fields
    return (int.from_bytes(number, "big"), addr,
            (rlp.decode_uint(balance), rlp.decode_uint(nonce), root,
             code_hash, bool(rlp.decode_uint(mc))))


def write_flat_storage(kv: KVStore, addr_hash: bytes, slot_key: bytes,
                       number: int, addr: bytes, value: int) -> None:
    kv.put(FLAT_STORAGE_PREFIX + addr_hash + slot_key,
           rlp.encode([_num8(number), addr, rlp.encode_uint(value)]))


def parse_flat_storage(key: bytes, value: bytes):
    """(number, addr, slot_key, value) for a flat storage entry, else
    None."""
    if key[:2] != FLAT_STORAGE_PREFIX or len(key) != 2 + 32 + 32:
        return None
    number, addr, val = rlp.decode(value)
    return (int.from_bytes(number, "big"), addr, key[2 + 32:],
            rlp.decode_uint(val))


def write_flat_barrier(kv: KVStore, addr_hash: bytes,
                       number: int) -> None:
    kv.put(FLAT_BARRIER_PREFIX + addr_hash, _num8(number))


def parse_flat_barrier(key: bytes, value: bytes):
    """(addr_hash, number) for a storage-barrier entry, else None."""
    if key[:2] != FLAT_BARRIER_PREFIX or len(key) != 2 + 32:
        return None
    return key[2:], int.from_bytes(value, "big")


def write_flat_meta(kv: KVStore, number: int, root: bytes) -> None:
    """The exporter's base stamp: the newest generation whose entries
    are durably written (informational: reloads trust the checkpoint
    record, with each entry's number stamp as the filter)."""
    kv.put(FLAT_META_KEY, rlp.encode([_num8(number), root]))


def read_flat_meta(kv: KVStore):
    raw = kv.get(FLAT_META_KEY)
    if raw is None:
        return None, None
    number, root = rlp.decode(raw)
    return int.from_bytes(number, "big"), root
