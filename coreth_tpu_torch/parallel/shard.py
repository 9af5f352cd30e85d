"""Shard-placement helpers for sharded replay state.

Port of reference ``parallel/shard.py``: one definition of "which shard
owns this state row", shared by every shard-major table (``DeviceState``
account and slot rows, the sharded transfer window).

- **accounts** bucket by the first byte of keccak(address): the hash
  the secure trie keys by, so placement is uniform even for sequential
  addresses;
- **contracts** bucket the same way (one contract's storage lives
  wholly on one shard);
- **slots** under key-range placement bucket by keccak of the slot key.

Rows are allocated shard-major: shard ``s`` owns rows
``[s*arena, (s+1)*arena)`` of a table of ``n_shards`` equal arenas, so
a shard translates a table row to its local row with one subtract.
Placement depends only on the address, never on discovery order, so
every width lays out the same rows.
"""

from __future__ import annotations

from typing import List, Optional


def account_bucket(addr_hash: bytes, n_shards: int) -> int:
    """Owning shard of an account row, from keccak256(address)."""
    if n_shards <= 1:
        return 0
    return addr_hash[0] % n_shards


def contract_bucket(addr_hash: bytes, n_shards: int) -> int:
    """Owning shard of a contract's storage (the account rule)."""
    return account_bucket(addr_hash, n_shards)


def slot_bucket(key_hash: bytes, n_shards: int) -> int:
    """Owning shard of one storage slot under key-range placement, from
    keccak256 of the raw 32-byte slot key."""
    if n_shards <= 1:
        return 0
    return key_hash[0] % n_shards


def remap_rows(rows, old_arena: int, new_arena: int) -> List[int]:
    """Row ids after an arena doubling: every row moves to
    ``shard*new_arena + local`` (shard = row//old_arena, local =
    row % old_arena)."""
    return [(r // old_arena) * new_arena + (r % old_arena) for r in rows]


def exchange_mode(touched: int, total: int, n_shards: int,
                  forced: Optional[str] = None,
                  density: float = 0.25) -> str:
    """Which collective carries a window's cross-shard exchange:
    ``"psum"`` (one all-reduce of the packed effect tensor) or
    ``"ppermute"`` (a ring of n-1 neighbour steps accumulating the same
    integer sums).  Integer adds are associative and commutative, so
    both give bit-identical tensors; the choice is performance only.
    ``forced`` ("psum" or "ppermute", the reference's
    ``CORETH_EXCHANGE``) wins; otherwise a touched set of at most
    ``density`` (``CORETH_EXCHANGE_DENSITY``) of the tables picks the
    ring."""
    if n_shards <= 1:
        return "psum"
    if forced in ("psum", "ppermute"):
        return forced
    return "ppermute" if touched <= density * max(1, total) else "psum"
