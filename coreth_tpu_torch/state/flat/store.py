"""Flat state store: O(1) reads, generational diffs, rollback.

Port of reference ``state/flat/store.py``.  The in-memory shape is two
dicts, ``accounts[addr]`` and ``storage[addr][slot_key]``, so a cold
read is a hash lookup instead of a Merkle-trie walk (geth's
``core/state/snapshot/`` role).  Keys are RAW addresses and slot keys
in memory: every producer (the commit pipeline's deduped window
effects, the host path's StateDB diff) and every consumer (the engine's
cold reads, the device table fills, StateDB resolution) already speaks
raw keys, so no keccak is paid on the read path.  The PERSISTED base is
hash-keyed (``fa ++ keccak(addr)`` / ``fs ++ keccak(addr) ++ slot``,
``rawdb/schema.py``) with the address preimage in the value; the
hashing happens on the exporter's thread, never on the execute thread.

Three value classes per key:

- a **generation diff**: authoritative, written by a commit unit (one
  flushed window, or one host-path block) with an undo entry captured
  at apply time;
- a **cold-read fill**: a read-through cache entry recorded when a
  consumer fell through to the trie; safe in the live dicts because a
  fill can only happen for a key NO generation since the base has
  written (otherwise the read would have hit), so its value is
  base-era and survives any rollback;
- ``DELETED``: known-absent (an account the trie does not contain), so
  existence checks are O(1) too.

Generations are the rollback and export unit.  ``apply_generation``
captures per-key undo; ``rollback_last`` pops the newest generation
and restores the pre-block flat view (the engine separately puts its
tries back at the generation's ``prev_root``).  The background
exporter (``exporter.py``) drains sealed generations in order; a
generation of a quarantined block is applied with ``hold=True`` and the
exporter stops in front of it until a later commit accepts the chain
past it (or the stream drains), so a rollback never races a durable
export.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from coreth_tpu_torch import faults
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.rawdb import schema
from coreth_tpu_torch.types import StateAccount

# the export queue hands back an already-exported (stale) generation —
# the queue-races-rollback shape; the exporter must detect and skip it
# instead of double-applying diffs to the shadow tries
PT_STALE = faults.declare(
    "flat/stale_generation",
    "export queue hands back an already-exported generation")

# known-absent marker (an account the trie provably lacks); also the
# generation-diff value for an account a block deletes (EIP-158 /
# SELFDESTRUCT).  Distinct from None, which means "flat does not know".
DELETED = "flat-deleted"

# undo-log marker: the key did not exist in the flat view before the
# generation wrote it (rollback removes it again)
_ABSENT = "flat-absent"

# account tuples are (balance, nonce, storage_root, code_hash,
# is_multi_coin) — the StateAccount fields in a shape cheap to build
# from the commit pipeline's staged state without an RLP round trip
AccountTuple = Tuple[int, int, bytes, bytes, bool]


class FlatError(Exception):
    pass


class FlatGeneration:
    """One commit unit's flat-state delta plus its undo log.

    kind: "window" (a flushed commit-pipeline window), "fallback"
    (a strict host-path block), "quarantine" (a tolerantly-applied
    poison block — the rollback target), or "checkpoint" (an empty
    marker generation that asks the exporter to write a durable
    checkpoint record at the current tip).
    """

    __slots__ = (
        "number", "block_hash", "root", "header", "prev_root",
        "prev_header", "accounts", "storage", "destructs",
        "undo_accounts", "undo_storage", "undo_destructs", "kind",
        "checkpoint", "hold", "exported", "rolled_back",
    )

    def __init__(self, number: int, block_hash: bytes, root: bytes,
                 header, prev_root: Optional[bytes],
                 prev_header, accounts: Dict[bytes, object],
                 storage: Dict[Tuple[bytes, bytes], int],
                 destructs, kind: str, checkpoint: bool, hold: bool):
        self.number = number
        self.block_hash = block_hash
        self.root = root
        self.header = header
        self.prev_root = prev_root
        self.prev_header = prev_header
        self.accounts = accounts
        self.storage = storage
        self.destructs = tuple(destructs)
        self.undo_accounts: Dict[bytes, object] = {}
        self.undo_storage: Dict[Tuple[bytes, bytes], object] = {}
        # addr -> the storage sub-dict popped by a destruct/delete
        # (None when the account had no tracked storage)
        self.undo_destructs: Dict[bytes, Optional[dict]] = {}
        self.kind = kind
        self.checkpoint = checkpoint
        self.hold = hold
        self.exported = False
        self.rolled_back = False


class FlatStore:
    """The live flat view + the generation log (single writer: the
    engine's execute thread; the export thread only reads sealed
    generations and flips their ``exported`` flag)."""

    # without an exporter attached, generations older than this are
    # pruned (their diff/undo payloads dropped) — the live dicts keep
    # the values, only rollback depth is bounded
    KEEP = 4

    def __init__(self):
        self.accounts: Dict[bytes, object] = {}
        self.storage: Dict[bytes, Dict[bytes, int]] = {}
        self.gens: List[FlatGeneration] = []
        # (number, block_hash, root, header) of the last REAL sealed
        # generation — the tip a checkpoint marker stamps
        self.tip: Optional[tuple] = None
        self.base_number: Optional[int] = None  # persisted-base stamp
        self._exporter_attached = False
        # most recent exported generation (payloads dropped): the
        # flat/stale_generation fault hands it back to model a queue
        # double-delivery
        self._last_exported: Optional[FlatGeneration] = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # keccak(addr) memo for the hash-keyed persisted form; only the
        # export thread populates it
        self._ah: Dict[bytes, bytes] = {}
        # ---- counters (snapshot(), the engine's flat/* gauges)
        self.account_hits = 0
        self.account_misses = 0
        self.storage_hits = 0
        self.storage_misses = 0
        self.fills = 0
        self.generations = 0
        self.rollbacks = 0
        self.loaded_entries = 0

    # ------------------------------------------------------------- reads
    def account(self, addr: bytes):
        """AccountTuple | DELETED | None (= flat does not know)."""
        v = self.accounts.get(addr)
        if v is None:
            self.account_misses += 1
        else:
            self.account_hits += 1
        return v

    def storage_value(self, addr: bytes, key: bytes) -> Optional[int]:
        """Committed slot value (0 = known-zero) or None (= unknown)."""
        sub = self.storage.get(addr)
        v = sub.get(key) if sub is not None else None
        if v is None:
            self.storage_misses += 1
        else:
            self.storage_hits += 1
        return v

    # ------------------------------------------------- read-through fills
    def fill_account(self, addr: bytes, value) -> None:
        """Record a trie-derived value for a key flat did not know.
        Only ever inserted when absent: a concurrent generation write
        must not be clobbered by a slower trie read."""
        if addr not in self.accounts:
            self.accounts[addr] = value
            self.fills += 1

    def fill_storage(self, addr: bytes, key: bytes, value: int) -> None:
        sub = self.storage.setdefault(addr, {})
        if key not in sub:
            sub[key] = value
            self.fills += 1

    # -------------------------------------------------------- generations
    def apply_generation(self, *, number: int, block_hash: bytes,
                         root: bytes, header,
                         prev_root: Optional[bytes] = None,
                         prev_header=None,
                         accounts: Optional[Dict[bytes, object]] = None,
                         storage: Optional[
                             Dict[Tuple[bytes, bytes], int]] = None,
                         destructs=(), kind: str = "window",
                         checkpoint: bool = False,
                         hold: bool = False) -> FlatGeneration:
        """Apply one commit unit's diff to the live view, capturing
        undo, and seal it as a generation.  ``destructs`` lists
        accounts destroyed during the block (their whole tracked
        storage dies, even if the account was re-created)."""
        gen = FlatGeneration(number, block_hash, root, header,
                             prev_root, prev_header,
                             dict(accounts or {}), dict(storage or {}),
                             destructs, kind, checkpoint, hold)
        for addr in gen.destructs:
            gen.undo_destructs[addr] = self.storage.pop(addr, None)
        for addr, v in gen.accounts.items():
            gen.undo_accounts[addr] = self.accounts.get(addr, _ABSENT)
            self.accounts[addr] = v
            if v is DELETED and addr not in gen.undo_destructs:
                gen.undo_destructs[addr] = self.storage.pop(addr, None)
        for (addr, key), val in gen.storage.items():
            sub = self.storage.setdefault(addr, {})
            gen.undo_storage[(addr, key)] = sub.get(key, _ABSENT)
            sub[key] = val
        with self._cv:
            if kind != "checkpoint":
                # the chain moved past any held (quarantined)
                # generation: the quarantine was accepted, release it
                # to the exporter
                for g in self.gens:
                    g.hold = False
                self.tip = (number, block_hash, root, header)
            self.gens.append(gen)
            self.generations += 1
            self._prune_locked()
            self._cv.notify_all()
        return gen

    def mark_checkpoint(self) -> Optional[FlatGeneration]:
        """Stamp a checkpoint at the current tip: an EMPTY marker
        generation the exporter turns into a durable record.  O(1) on
        the execute thread — this is the whole 'stamp cost'.  None
        when nothing was ever sealed."""
        if self.tip is None:
            return None
        number, block_hash, root, header = self.tip
        return self.apply_generation(
            number=number, block_hash=block_hash, root=root,
            header=header, kind="checkpoint", checkpoint=True)

    def rollback_last(self) -> FlatGeneration:
        """Pop the newest generation and restore the flat view to its
        ``prev_root`` state.  Refuses if the generation was already
        exported (it is durable — a rollback past it would need a
        checkpoint rewind, which reorg semantics do not require: the
        exporter holds in front of quarantined generations)."""
        with self._cv:
            if not self.gens:
                raise FlatError("rollback: no generations")
            gen = self.gens[-1]
            if gen.exported:
                raise FlatError(
                    f"rollback: generation {gen.number} already "
                    "exported (durable)")
            self.gens.pop()
        for (addr, key), prev in gen.undo_storage.items():
            sub = self.storage.get(addr)
            if sub is None:
                continue
            if prev is _ABSENT:
                sub.pop(key, None)
            else:
                sub[key] = prev
        for addr, prev in gen.undo_accounts.items():
            if prev is _ABSENT:
                self.accounts.pop(addr, None)
            else:
                self.accounts[addr] = prev
        for addr, sub in gen.undo_destructs.items():
            if sub is not None:
                self.storage[addr] = sub
            elif addr in self.storage and not self.storage[addr]:
                del self.storage[addr]
        gen.rolled_back = True
        with self._cv:
            # the tip is the previous real generation (if still known)
            self.tip = None
            for g in reversed(self.gens):
                if g.kind != "checkpoint":
                    self.tip = (g.number, g.block_hash, g.root,
                                g.header)
                    break
            self.rollbacks += 1
            self._cv.notify_all()
        return gen

    def last_generation(self) -> Optional[FlatGeneration]:
        with self._lock:
            return self.gens[-1] if self.gens else None

    # ------------------------------------------------------- export queue
    def attach_exporter(self) -> None:
        with self._lock:
            self._exporter_attached = True

    def next_for_export(self, timeout: float) -> Optional[FlatGeneration]:
        """Oldest unexported, unheld generation (export order = apply
        order), or None after ``timeout``.  The armed
        ``flat/stale_generation`` fault hands back an ALREADY-exported
        generation instead — the queue-races-rollback shape the
        exporter must detect (by its ``exported`` flag) and skip."""
        deadline_wait = timeout
        with self._cv:
            while True:
                nxt = None
                for g in self.gens:
                    if g.exported:
                        continue
                    if g.hold:
                        break
                    nxt = g
                    break
                if nxt is not None:
                    if self._last_exported is not None \
                            and faults.check(PT_STALE) is not None:
                        return self._last_exported
                    return nxt
                if not self._cv.wait(deadline_wait):
                    return None

    def mark_exported(self, gen: FlatGeneration) -> None:
        with self._cv:
            gen.exported = True
            # drop payloads; the live dicts carry the values
            gen.accounts = {}
            gen.storage = {}
            gen.undo_accounts = {}
            gen.undo_storage = {}
            gen.undo_destructs = {}
            self._last_exported = gen
            self._prune_locked()
            self._cv.notify_all()

    def mark_preexisting_exported(self) -> None:
        """Generations sealed BEFORE an exporter attached are covered
        by its seed commit (the caller persists the engine tries once,
        synchronously, at attach time) — mark them exported so the
        worker starts from the seed root, not from diffs whose base
        nodes were never durable."""
        with self._cv:
            for g in self.gens:
                if not g.exported:
                    g.exported = True
                    g.accounts = {}
                    g.storage = {}
                    g.undo_accounts = {}
                    g.undo_storage = {}
                    g.undo_destructs = {}
            self._prune_locked()
            self._cv.notify_all()

    def drained(self) -> bool:
        """True when the exporter has nothing LEFT it may process: a
        held (quarantined) generation — and everything stacked on it —
        deliberately stays unexported until the chain accepts past it,
        so it does not count against a drain (the final checkpoint
        then covers exactly the pre-quarantine prefix, which is what
        reorg semantics finalize)."""
        with self._lock:
            for g in self.gens:
                if g.hold:
                    return True
                if not g.exported:
                    return False
            return True

    def _prune_locked(self) -> None:
        """Bound the generation log: exported generations leave from
        the front; without an exporter, old generations beyond KEEP
        drop their payloads (rollback depth is bounded either way —
        the newest generation always survives)."""
        while len(self.gens) > 1 and self.gens[0].exported:
            self.gens.pop(0)
        if not self._exporter_attached:
            while len(self.gens) > self.KEEP:
                self.gens.pop(0)

    # -------------------------------------------------------- persistence
    def _addr_hash(self, addr: bytes) -> bytes:
        h = self._ah.get(addr)
        if h is None:
            h = keccak256(addr)
            self._ah[addr] = h
        return h

    def write_gen_entries(self, kv, gen: FlatGeneration) -> int:
        """Persist one generation's diff under the hash-keyed schema
        (export-thread only — this is where the keccaks happen).
        Every value is stamped with the generation's block number, so
        a reload after a crash can skip entries newer than the
        checkpoint record it resumes from.  Destructed (or deleted)
        accounts additionally land a STORAGE BARRIER: their persisted
        slot entries cannot be enumerated for deletion (keccak keys),
        so the barrier invalidates everything stamped below it —
        without it a destruct+re-create would resurrect stale slot
        values on reload."""
        n = 0
        barriers: Dict[bytes, None] = dict.fromkeys(gen.destructs)
        for addr in sorted(gen.accounts):
            v = gen.accounts[addr]
            if v is DELETED:
                barriers[addr] = None
            schema.write_flat_account(
                kv, self._addr_hash(addr), gen.number, addr,
                None if v is DELETED else v)
            n += 1
        for addr in sorted(barriers):
            schema.write_flat_barrier(kv, self._addr_hash(addr),
                                      gen.number)
            n += 1
        for (addr, key) in sorted(gen.storage):
            schema.write_flat_storage(
                kv, self._addr_hash(addr), key, gen.number, addr,
                gen.storage[(addr, key)])
            n += 1
        return n

    def load(self, kv, trusted_number: int) -> int:
        """Rebuild the persisted base from ``kv``, trusting only
        entries stamped at or below ``trusted_number`` (the checkpoint
        record's block — anything newer may have been exported ahead
        of the record the caller is resuming from).  Storage barriers
        (a destruct at generation N) drop slot entries stamped BELOW
        their generation; a barrier stamped past ``trusted_number``
        poisons the account's persisted storage entirely — whether the
        destruct belongs to the resumed timeline is unknowable, so the
        slots fall through to the trie.  Returns the entry count
        loaded."""
        barriers: Dict[bytes, int] = {}
        for raw_key, raw_val in kv.items():
            b = schema.parse_flat_barrier(raw_key, raw_val)
            if b is not None:
                barriers[b[0]] = b[1]
        n = 0
        for raw_key, raw_val in kv.items():
            acct = schema.parse_flat_account(raw_key, raw_val)
            if acct is not None:
                number, addr, tup = acct
                if number <= trusted_number:
                    self.accounts[addr] = DELETED if tup is None else tup
                    n += 1
                continue
            slot = schema.parse_flat_storage(raw_key, raw_val)
            if slot is not None:
                number, addr, key, value = slot
                if number > trusted_number:
                    continue
                bar = barriers.get(raw_key[2:2 + 32])
                if bar is not None and (bar > trusted_number
                                        or number < bar):
                    continue  # destructed under (or past) the barrier
                self.storage.setdefault(addr, {})[key] = value
                n += 1
        # a loaded DELETED account must not shadow resurrected storage:
        # entries above arrive in kv order, so re-drop storage of
        # accounts whose newest trusted record is DELETED
        for addr, v in self.accounts.items():
            if v is DELETED:
                self.storage.pop(addr, None)
        self.base_number = trusted_number
        self.loaded_entries = n
        return n

    # ------------------------------------------------------------ reports
    def snapshot(self) -> dict:
        return {
            "account_hits": self.account_hits,
            "account_misses": self.account_misses,
            "storage_hits": self.storage_hits,
            "storage_misses": self.storage_misses,
            "fills": self.fills,
            "generations": self.generations,
            "rollbacks": self.rollbacks,
            "loaded_entries": self.loaded_entries,
            "live_accounts": len(self.accounts),
            "live_storage": sum(len(s) for s in self.storage.values()),
        }


class FlatStateView:
    """StateDB-facing adapter (statedb.py consults it duck-typed, so
    ``state`` never imports this package): account and slot reads
    flat-first, with read-through fills.  ``check`` arms the caller-side
    differential oracle (the engine's ``flat_check``, the reference's
    ``CORETH_FLAT_CHECK``): the StateDB re-derives every flat hit from
    its trie and raises on a divergence."""

    DELETED = DELETED

    def __init__(self, flat: FlatStore, check: bool = False):
        self.flat = flat
        self.check = check

    def account_state(self, addr: bytes):
        """StateAccount | DELETED | None (= unknown, use the trie)."""
        v = self.flat.account(addr)
        if v is None or v is DELETED:
            return v
        return StateAccount(nonce=v[1], balance=v[0], root=v[2],
                            code_hash=v[3], is_multi_coin=v[4])

    def load_account(self, addr: bytes, trie, error=ValueError,
                     what: str = "account") -> Optional[StateAccount]:
        """Flat-first account read: the StateAccount, or None for an
        absent one.  A miss reads ``trie`` and fills the layer; under
        ``check`` a hit is re-derived from ``trie`` and a divergence
        raises ``error("flat oracle divergence (<what>) ...")``."""
        account = self.account_state(addr)
        if account is None:
            raw = trie.get(addr)
            account = StateAccount.from_rlp(raw) if raw is not None \
                else None
            self.fill_account(addr, account)
            return account
        if account is DELETED:
            account = None
        if self.check:
            raw = trie.get(addr)
            want = StateAccount.from_rlp(raw) if raw is not None else None
            if (want is None) != (account is None) or (
                    want is not None and want.rlp() != account.rlp()):
                raise error(
                    f"flat oracle divergence ({what}) at {addr.hex()}: "
                    f"flat={account!r} trie={want!r}")
        return account

    def storage_value(self, addr: bytes, key: bytes) -> Optional[int]:
        return self.flat.storage_value(addr, key)

    def fill_account(self, addr: bytes, account) -> None:
        """account: a StateAccount (present) or None (absent)."""
        if account is None:
            self.flat.fill_account(addr, DELETED)
        else:
            self.flat.fill_account(
                addr, (account.balance, account.nonce, account.root,
                       account.code_hash, account.is_multi_coin))

    def fill_storage(self, addr: bytes, key: bytes, value: int) -> None:
        self.flat.fill_storage(addr, key, value)


def flat_diff_from_statedb(statedb):
    """One host-path block's (accounts, storage, destructs) delta in
    FLAT key space (raw addresses / raw slot keys) from a
    finalised+hashed StateDB: the host-path / quarantine generation
    feed."""
    accounts: Dict[bytes, object] = {}
    storage: Dict[Tuple[bytes, bytes], int] = {}
    for addr in sorted(statedb._mutated):
        obj = statedb._objects.get(addr)
        if obj is None or obj.deleted or obj.suicided:
            accounts[addr] = DELETED
            continue
        a = obj.account
        accounts[addr] = (a.balance, a.nonce, a.root, a.code_hash,
                          a.is_multi_coin)
        for key, value in obj.written_storage.items():
            storage[(addr, key)] = int.from_bytes(value, "big")
    destructs = sorted(statedb._destructed)
    return accounts, storage, destructs
