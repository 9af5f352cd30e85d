"""Journaled world state over the port's ``StateStore``.

Port of reference ``state/statedb.py`` with the reference's ``Database``
(Python tries + node store) replaced by the engine's ``StateStore``
(tries advanced in place, C++ or Python by the store's backend): reads
fall through to ``store.trie``, the contracts' storage tries and the
code store; ``intermediate_root`` writes the accounts and storage into
those tries directly (a new storage trie comes from
``store.new_trie()``), remembering every key's prior raw value and
every storage trie it replaced, so ``restore()`` puts the store back
exactly where this StateDB found it, whatever the backend (a block
that fails its checks leaves no trace).  ``commit`` adds the block's
new code to the store and makes the writes final.  ``copy()`` gives a
view for speculative execution: the journaled overlay copied, the
store shared and only read (a copy cannot write the store: its
``intermediate_root``, ``commit`` and ``restore`` raise).  ``flat``
is the flat-state read path (``state/flat``'s ``FlatStateView``,
consulted duck-typed): account and slot reads go to it before the
tries and fill it on a miss, and with its ``check`` flag every hit is
re-derived from the trie (``ValueError("flat oracle ...")`` on a
divergence).  The snapshot and prefetcher read paths of the reference
are not part of the port.

Semantic twin of reference core/state/statedb.go + state_object.go +
journal.go:

- every mutation appends an undo thunk to the journal; ``snapshot()`` /
  ``revert_to_snapshot()`` replay undos (journal.go revert semantics);
- ``finalise(delete_empty)`` moves per-tx dirty storage into the pending
  set, deletes suicided/empty accounts, clears journal+refund
  (statedb.go:945);
- ``intermediate_root()`` pushes pending storage into storage tries,
  re-encodes dirty accounts into the account trie and returns the root
  (statedb.go:994);
- multicoin balances live in the account storage trie under coin-IDs with
  bit 0 of byte 0 set; normal state keys have that bit cleared
  (state_object.go:548-563 NormalizeCoinID/NormalizeStateKey);
- access list (EIP-2929), transient storage (EIP-1153), refunds, logs and
  predicate storage slots all journal-revert correctly.

Same-tx destruct+resurrect: unreachable through the EVM — a CREATE2
onto an address self-destructed earlier in the same tx fails the
address-collision check (the account keeps its code until the tx-end
Finalise), which matches geth; the destructed account's state stays
readable until tx end and is deleted at Finalise (both geth-matching,
pinned by tests/test_statetests.py).  Cross-tx destruct+resurrect
creates a fresh object with wiped storage.  Callers driving the
StateDB API directly (not through the EVM) should use create_account
for resurrection, which also wipes storage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.state.store import StateStore
from coreth_tpu_torch.types.account import (
    EMPTY_CODE_HASH, EMPTY_ROOT_HASH as EMPTY_ROOT, StateAccount,
)
from coreth_tpu_torch.types.receipt import Log
from coreth_tpu_torch.state.store import normalize_state_key  # noqa: F401

HASH_ZERO = b"\x00" * 32


def normalize_coin_id(coin_id: bytes) -> bytes:
    """OR bit 0 of byte 0 — multicoin storage partition."""
    return bytes([coin_id[0] | 0x01]) + coin_id[1:]


class StateObject:
    __slots__ = ("address", "account", "code", "origin_storage",
                 "dirty_storage", "pending_storage", "written_storage",
                 "suicided", "deleted", "dirty_code", "fresh",
                 "initial_root")

    def __init__(self, address: bytes, account: StateAccount,
                 fresh: bool) -> None:
        self.address = address
        self.account = account
        self.code: Optional[bytes] = None
        # committed (trie) values cache; authoritative when fresh
        self.origin_storage: Dict[bytes, bytes] = {}
        # writes inside the currently-executing tx
        self.dirty_storage: Dict[bytes, bytes] = {}
        # finalised writes from earlier txs in this block
        self.pending_storage: Dict[bytes, bytes] = {}
        # every slot actually written over the object's lifetime (the
        # snapshot diff feed — origin_storage also caches pure reads)
        self.written_storage: Dict[bytes, bytes] = {}
        self.suicided = False
        self.deleted = False
        self.dirty_code = False
        self.fresh = fresh  # created in this block — no backing trie
        self.initial_root = EMPTY_ROOT if fresh else account.root

    def empty(self) -> bool:
        return (self.account.nonce == 0 and self.account.balance == 0
                and self.account.code_hash == EMPTY_CODE_HASH
                and not self.account.is_multi_coin)


class StateDB:
    def __init__(self, store: StateStore, flat=None):
        """A block's (or a tx's) journaled view of ``store``, whose
        account trie stands at the state to execute on; ``flat``: the
        flat-state view read before the tries (None: the tries only)."""
        self.store = store
        self.flat = flat
        self._trie = store.trie
        self.original_root = self._trie.hash()
        self._objects: Dict[bytes, StateObject] = {}
        self._destructed: Set[bytes] = set()
        self._pending: Set[bytes] = set()
        # addresses that ever went dirty (survives commit clearing
        # _pending)
        self._mutated: Set[bytes] = set()
        self._journal: List = []  # (undo_fn, dirty_addr | None)
        self._dirty_counts: Dict[bytes, int] = {}
        self.refund = 0
        self.logs: List[Log] = []
        self._tx_hash = HASH_ZERO
        self._tx_index = 0
        self.created_this_tx: Set[bytes] = set()
        self._log_index = 0
        self.access_list_addresses: Set[bytes] = set()
        self.access_list_slots: Set[Tuple[bytes, bytes]] = set()
        self.transient: Dict[Tuple[bytes, bytes], bytes] = {}
        self.predicate_storage_slots: Dict[bytes, List[bytes]] = {}
        self._storage_tries: Dict[bytes, object] = {}
        # the store as this StateDB found it: each account key's prior
        # raw value, each storage-trie entry it replaced (None: none
        # was there), and each in-place storage write's prior raw value
        self._undo_accounts: Dict[bytes, Optional[bytes]] = {}
        self._undo_tries: Dict[bytes, object] = {}
        self._undo_slots: Dict[Tuple[int, bytes],
                               Tuple[object, Optional[bytes]]] = {}
        # monotone counter bumped on every mutation that can change
        # what a (contract, slot) or code resolution returns (storage
        # writes, deploys, journal reverts, suicides).  The hostexec
        # bridge compares it across txs to keep its native session's
        # committed-storage cache alive within a block and invalidate
        # it the moment an interpreter-path tx moves state under it.
        self.storage_gen = 0
        # companion counter for ACCOUNT-SHAPE changes storage_gen cannot
        # see: existence/emptiness transitions (object creation, balance
        # or nonce crossing zero, deploys, suicides, EIP-158 deletions,
        # journal reverts).  The hostexec bridge keeps its cached EOA
        # verdicts alive across txs only while BOTH generations hold.
        self.account_gen = 0
        # a copy() reads the store it shares and never writes it
        self._shared = False

    # ------------------------------------------------------------- journal
    def _append_journal(self, undo, addr: Optional[bytes] = None) -> None:
        self._journal.append((undo, addr))
        if addr is not None:
            self._dirty_counts[addr] = self._dirty_counts.get(addr, 0) + 1

    def snapshot(self) -> int:
        return len(self._journal)

    def revert_to_snapshot(self, snap: int) -> None:
        if snap > len(self._journal) or snap < 0:
            raise ValueError(f"invalid snapshot id {snap} "
                             f"(journal length {len(self._journal)})")
        if len(self._journal) > snap:
            self.storage_gen += 1  # undone writes may reappear changed
            self.account_gen += 1  # undone creations/balances too
        while len(self._journal) > snap:
            undo, addr = self._journal.pop()
            undo()
            if addr is not None:
                self._dirty_counts[addr] -= 1
                if self._dirty_counts[addr] == 0:
                    del self._dirty_counts[addr]

    # ------------------------------------------------------------- objects
    def _load_account(self, addr: bytes) -> Optional[StateAccount]:
        if self.flat is not None:
            return self.flat.load_account(addr, self._trie,
                                          what="statedb account")
        data = self._trie.get(addr)
        return StateAccount.from_rlp(data) if data is not None else None

    def _get_object(self, addr: bytes) -> Optional[StateObject]:
        obj = self._objects.get(addr)
        if obj is not None:
            return None if obj.deleted else obj
        account = self._load_account(addr)
        if account is None:
            return None
        obj = StateObject(addr, account, fresh=False)
        self._objects[addr] = obj
        return obj

    def _get_or_new_object(self, addr: bytes) -> StateObject:
        obj = self._get_object(addr)
        if obj is None:
            obj = self._create_object(addr)
        return obj

    def _create_object(self, addr: bytes) -> StateObject:
        prev = self._objects.get(addr)
        prev_trie = self._storage_tries.pop(addr, None)
        obj = StateObject(addr, StateAccount(), fresh=True)
        self._objects[addr] = obj

        def undo():
            if prev is not None:
                self._objects[addr] = prev
            else:
                self._objects.pop(addr, None)
            if prev_trie is not None:
                self._storage_tries[addr] = prev_trie
            else:
                self._storage_tries.pop(addr, None)

        self._append_journal(undo, addr)
        self.account_gen += 1  # a fresh object changes existence
        return obj

    def create_account(self, addr: bytes) -> None:
        """Explicit account creation; preserves balance (statedb.go:744)."""
        prev = self._get_object(addr)
        obj = self._create_object(addr)
        if prev is not None:
            obj.account.balance = prev.account.balance

    def exist(self, addr: bytes) -> bool:
        return self._get_object(addr) is not None

    def empty(self, addr: bytes) -> bool:
        obj = self._get_object(addr)
        return obj is None or obj.empty()

    # ------------------------------------------------------------- balance
    def get_balance(self, addr: bytes) -> int:
        obj = self._get_object(addr)
        return obj.account.balance if obj else 0

    def add_balance(self, addr: bytes, amount: int) -> None:
        obj = self._get_or_new_object(addr)
        if amount == 0:
            # touch: journal dirtiness so empty accounts die at finalise
            self._append_journal(lambda: None, addr)
            return
        self._set_balance(obj, obj.account.balance + amount)

    def sub_balance(self, addr: bytes, amount: int) -> None:
        if amount == 0:
            obj = self._get_object(addr)
            if obj is not None:
                self._append_journal(lambda: None, addr)
            return
        obj = self._get_or_new_object(addr)
        self._set_balance(obj, obj.account.balance - amount)

    def set_balance(self, addr: bytes, amount: int) -> None:
        self._set_balance(self._get_or_new_object(addr), amount)

    def _set_balance(self, obj: StateObject, amount: int) -> None:
        prev = obj.account.balance

        def undo():
            obj.account.balance = prev

        self._append_journal(undo, obj.address)
        if prev == 0 or amount == 0:
            # emptiness may flip (EIP-158): EOA verdicts go stale
            self.account_gen += 1
        obj.account.balance = amount

    # ----------------------------------------------------------- multicoin
    def get_balance_multi_coin(self, addr: bytes, coin_id: bytes) -> int:
        return int.from_bytes(
            self.get_state(addr, normalize_coin_id(coin_id),
                           _normalize=False), "big")

    def add_balance_multi_coin(self, addr: bytes, coin_id: bytes,
                               amount: int) -> None:
        if amount == 0:
            self.add_balance(addr, 0)  # touch
            return
        self.set_balance_multi_coin(
            addr, coin_id,
            self.get_balance_multi_coin(addr, coin_id) + amount)

    def sub_balance_multi_coin(self, addr: bytes, coin_id: bytes,
                               amount: int) -> None:
        if amount == 0:
            return
        self.set_balance_multi_coin(
            addr, coin_id,
            self.get_balance_multi_coin(addr, coin_id) - amount)

    def set_balance_multi_coin(self, addr: bytes, coin_id: bytes,
                               amount: int) -> None:
        obj = self._get_or_new_object(addr)
        if not obj.account.is_multi_coin:
            prev_flag = obj.account.is_multi_coin

            def undo():
                obj.account.is_multi_coin = prev_flag

            self._append_journal(undo, addr)
            obj.account.is_multi_coin = True
        self._set_state(obj, normalize_coin_id(coin_id),
                        amount.to_bytes(32, "big"))

    # --------------------------------------------------------------- nonce
    def get_nonce(self, addr: bytes) -> int:
        obj = self._get_object(addr)
        return obj.account.nonce if obj else 0

    def set_nonce(self, addr: bytes, nonce: int) -> None:
        obj = self._get_or_new_object(addr)
        prev = obj.account.nonce

        def undo():
            obj.account.nonce = prev

        self._append_journal(undo, addr)
        if prev == 0 or nonce == 0:
            self.account_gen += 1  # emptiness may flip
        obj.account.nonce = nonce

    # ---------------------------------------------------------------- code
    def get_code(self, addr: bytes) -> bytes:
        obj = self._get_object(addr)
        if obj is None:
            return b""
        if obj.code is None:
            obj.code = self.store.codes.get(obj.account.code_hash, b"")
        return obj.code

    def get_code_hash(self, addr: bytes) -> bytes:
        obj = self._get_object(addr)
        return obj.account.code_hash if obj else HASH_ZERO

    def get_code_size(self, addr: bytes) -> int:
        return len(self.get_code(addr))

    def set_code(self, addr: bytes, code: bytes) -> None:
        obj = self._get_or_new_object(addr)
        prev_code, prev_hash = obj.code, obj.account.code_hash

        def undo():
            obj.code, obj.account.code_hash = prev_code, prev_hash
            obj.dirty_code = False

        self._append_journal(undo, addr)
        self.storage_gen += 1  # a deploy changes code resolution
        self.account_gen += 1  # ... and the account's kind
        obj.code = code
        obj.account.code_hash = keccak256(code)
        obj.dirty_code = True

    # ------------------------------------------------------------- storage
    def _origin_value(self, obj: StateObject, key: bytes) -> bytes:
        if key in obj.origin_storage:
            return obj.origin_storage[key]
        fl = self.flat
        if obj.fresh:
            value = HASH_ZERO
        elif fl is not None \
                and (v := fl.storage_value(obj.address, key)) is not None:
            value = v.to_bytes(32, "big")
            if fl.check:
                want = self._trie_value(obj, key)
                if want != value:
                    raise ValueError(
                        f"flat oracle divergence (statedb slot) at "
                        f"{obj.address.hex()}/{key.hex()}: "
                        f"flat={value.hex()} trie={want.hex()}")
        else:
            value = self._trie_value(obj, key)
            if fl is not None:
                fl.fill_storage(obj.address, key,
                                int.from_bytes(value, "big"))
        obj.origin_storage[key] = value
        return value

    def _trie_value(self, obj: StateObject, key: bytes) -> bytes:
        trie = self._read_trie(obj)
        raw = trie.get(key) if trie is not None else None
        return rlp.decode(raw).rjust(32, b"\x00") \
            if raw is not None else HASH_ZERO

    def _read_trie(self, obj: StateObject):
        """The storage trie a pre-existing account's reads fall through
        to (None: it has no storage); reading installs nothing."""
        trie = self._storage_tries.get(obj.address)
        if trie is None:
            trie = self.store.storage.get(obj.address)
            if trie is None and obj.initial_root != EMPTY_ROOT:
                raise ValueError(
                    f"storage trie of {obj.address.hex()} (root "
                    f"{obj.initial_root.hex()}) is not in the store")
        return trie

    def _open_storage_trie(self, obj: StateObject):
        """The object's storage trie for writing: the store's own
        (written in place) for an account that existed before this
        StateDB, a new empty trie put in the store's place for one
        created here or one that had no storage."""
        trie = self._storage_tries.get(obj.address)
        if trie is None:
            trie = None if obj.fresh else self._read_trie(obj)
            if trie is None:
                trie = self.store.new_trie()
                self._swap_store_trie(obj.address, trie)
            self._storage_tries[obj.address] = trie
        return trie

    def _swap_store_trie(self, addr: bytes, trie) -> None:
        """Put ``trie`` (None: no trie) in the store for ``addr``,
        remembering the entry it replaces the first time."""
        if addr not in self._undo_tries:
            self._undo_tries[addr] = self.store.storage.get(addr)
        if trie is None:
            self.store.storage.pop(addr, None)
        else:
            self.store.storage[addr] = trie

    def get_state(self, addr: bytes, key: bytes, _normalize=True) -> bytes:
        if _normalize:
            key = normalize_state_key(key)
        obj = self._get_object(addr)
        if obj is None:
            return HASH_ZERO
        if key in obj.dirty_storage:
            return obj.dirty_storage[key]
        if key in obj.pending_storage:
            return obj.pending_storage[key]
        return self._origin_value(obj, key)

    def get_committed_state(self, addr: bytes, key: bytes) -> bytes:
        """Pre-tx value: pending else trie (state_object.go
        GetCommittedState).  No key normalization (statedb.go:419)."""
        obj = self._get_object(addr)
        if obj is None:
            return HASH_ZERO
        if key in obj.pending_storage:
            return obj.pending_storage[key]
        return self._origin_value(obj, key)

    def get_committed_state_ap1(self, addr: bytes, key: bytes) -> bytes:
        return self.get_committed_state(addr, normalize_state_key(key))

    def set_state(self, addr: bytes, key: bytes, value: bytes) -> None:
        obj = self._get_or_new_object(addr)
        self._set_state(obj, normalize_state_key(key), value)

    def _set_state(self, obj: StateObject, key: bytes, value: bytes) -> None:
        prev = self.get_state(obj.address, key, _normalize=False)
        if prev == value:
            return
        had_dirty = key in obj.dirty_storage
        prev_dirty = obj.dirty_storage.get(key)

        def undo():
            if had_dirty:
                obj.dirty_storage[key] = prev_dirty
            else:
                obj.dirty_storage.pop(key, None)

        self._append_journal(undo, obj.address)
        self.storage_gen += 1
        obj.dirty_storage[key] = value

    # ----------------------------------------------------------- transient
    def get_transient_state(self, addr: bytes, key: bytes) -> bytes:
        return self.transient.get((addr, key), HASH_ZERO)

    def set_transient_state(self, addr: bytes, key: bytes,
                            value: bytes) -> None:
        prev = self.get_transient_state(addr, key)
        if prev == value:
            return

        def undo():
            if prev == HASH_ZERO:
                self.transient.pop((addr, key), None)
            else:
                self.transient[(addr, key)] = prev

        self._append_journal(undo)
        self.transient[(addr, key)] = value

    # -------------------------------------------------------------- suicide
    def suicide(self, addr: bytes) -> bool:
        obj = self._get_object(addr)
        if obj is None:
            return False
        prev_suicided, prev_balance = obj.suicided, obj.account.balance

        def undo():
            obj.suicided = prev_suicided
            obj.account.balance = prev_balance

        self._append_journal(undo, addr)
        self.storage_gen += 1  # storage of addr vanishes at finalise
        self.account_gen += 1  # existence vanishes at finalise
        obj.suicided = True
        obj.account.balance = 0
        return True

    def has_suicided(self, addr: bytes) -> bool:
        obj = self._get_object(addr)
        return obj.suicided if obj else False

    # -------------------------------------------------------------- refund
    def add_refund(self, amount: int) -> None:
        prev = self.refund

        def undo():
            self.refund = prev

        self._append_journal(undo)
        self.refund += amount

    def sub_refund(self, amount: int) -> None:
        prev = self.refund
        if amount > prev:
            raise ValueError("refund counter below zero")

        def undo():
            self.refund = prev

        self._append_journal(undo)
        self.refund -= amount

    # ---------------------------------------------------------------- logs
    def set_tx_context(self, tx_hash: bytes, tx_index: int) -> None:
        self._tx_hash = tx_hash
        self._tx_index = tx_index
        # per-tx contract-creation marks (EIP-6780: SELFDESTRUCT only
        # deletes contracts created in the same transaction)
        self.created_this_tx = set()

    def mark_created_this_tx(self, addr: bytes) -> None:
        """Journaled EIP-6780 creation mark (geth createObjectChange)."""
        self.created_this_tx.add(addr)

        def undo():
            self.created_this_tx.discard(addr)
        self._append_journal(undo)

    def add_log(self, log: Log) -> None:
        log.tx_hash = self._tx_hash
        log.tx_index = self._tx_index
        log.index = self._log_index

        def undo():
            self.logs.pop()
            self._log_index -= 1

        self._append_journal(undo)
        self.logs.append(log)
        self._log_index += 1

    def get_logs(self) -> List[Log]:
        return list(self.logs)

    def tx_logs(self) -> List[Log]:
        """Logs of the current tx context."""
        return [l for l in self.logs if l.tx_hash == self._tx_hash
                and l.tx_index == self._tx_index]

    # ---------------------------------------------------------- access list
    def add_address_to_access_list(self, addr: bytes) -> None:
        if addr in self.access_list_addresses:
            return

        def undo():
            self.access_list_addresses.discard(addr)

        self._append_journal(undo)
        self.access_list_addresses.add(addr)

    def add_slot_to_access_list(self, addr: bytes, slot: bytes) -> None:
        self.add_address_to_access_list(addr)
        key = (addr, slot)
        if key in self.access_list_slots:
            return

        def undo():
            self.access_list_slots.discard(key)

        self._append_journal(undo)
        self.access_list_slots.add(key)

    def address_in_access_list(self, addr: bytes) -> bool:
        return addr in self.access_list_addresses

    def slot_in_access_list(self, addr: bytes, slot: bytes) -> Tuple[bool, bool]:
        return (addr in self.access_list_addresses,
                (addr, slot) in self.access_list_slots)

    # -------------------------------------------------------------- prepare
    def prepare(self, rules, sender: bytes, coinbase: bytes,
                dst: Optional[bytes], precompiles: List[bytes],
                access_list) -> None:
        """Per-tx setup (statedb.go:1219 Prepare)."""
        if rules.is_apricot_phase2:
            self.access_list_addresses = set()
            self.access_list_slots = set()
            self.access_list_addresses.add(sender)
            if dst is not None:
                self.access_list_addresses.add(dst)
            for p in precompiles:
                self.access_list_addresses.add(p)
            for addr, keys in access_list:
                self.access_list_addresses.add(addr)
                for k in keys:
                    self.access_list_slots.add((addr, k))
            if rules.is_durango:  # EIP-3651 warm coinbase
                self.access_list_addresses.add(coinbase)
            self.predicate_storage_slots = _prepare_predicate_slots(
                rules, access_list)
        self.transient = {}

    def get_predicate_storage_slots(self, addr: bytes):
        return self.predicate_storage_slots.get(addr)

    def set_predicate_storage_slots(self, addr: bytes, slots) -> None:
        self.predicate_storage_slots[addr] = slots

    # ------------------------------------------------------------- finalise
    def finalise(self, delete_empty_objects: bool) -> None:
        for addr in list(self._dirty_counts):
            obj = self._objects.get(addr)
            if obj is None:
                continue
            if obj.suicided or (delete_empty_objects and obj.empty()):
                if not obj.deleted:
                    self.account_gen += 1  # EIP-158 deletion
                obj.deleted = True
                self._destructed.add(addr)
            else:
                obj.pending_storage.update(obj.dirty_storage)
                obj.dirty_storage = {}
            self._pending.add(addr)
            self._mutated.add(addr)
        self._journal = []
        self._dirty_counts = {}
        self.refund = 0

    # ----------------------------------------------------------- root/commit
    def _trie_put(self, addr: bytes, data: Optional[bytes]) -> None:
        """Write (None: delete) one account of the store's trie."""
        prior = self._trie.get(addr)
        if addr not in self._undo_accounts:
            self._undo_accounts[addr] = prior
        if data is not None:
            self._trie.update(addr, data)
        elif prior is not None:
            self._trie.delete(addr)

    def _writes_store(self) -> None:
        if self._shared:
            raise RuntimeError("a StateDB copy shares its store and cannot "
                               "write it")

    def intermediate_root(self, delete_empty_objects: bool) -> bytes:
        self._writes_store()
        self.finalise(delete_empty_objects)
        for addr in sorted(self._pending):
            obj = self._objects.get(addr)
            if obj is None:
                continue
            if obj.deleted:
                self._trie_put(addr, None)
                self._storage_tries.pop(addr, None)
                self._swap_store_trie(addr, None)
                continue
            if (obj.fresh and addr not in self._storage_tries
                    and addr in self.store.storage):
                # a new account's storage starts empty, whatever trie an
                # earlier incarnation left in the store
                self._swap_store_trie(addr, None)
            if obj.pending_storage:
                trie = self._open_storage_trie(obj)
                for key, value in obj.pending_storage.items():
                    if (id(trie), key) not in self._undo_slots:
                        self._undo_slots[(id(trie), key)] = \
                            (trie, trie.get(key))
                    if value == HASH_ZERO:
                        trie.delete(key)
                    else:
                        trie.update(key, rlp.encode(value.lstrip(b"\x00")))
                    obj.origin_storage[key] = value
                    obj.written_storage[key] = value
                obj.pending_storage = {}
                obj.account.root = trie.hash()
            self._trie_put(addr, obj.account.rlp())
        self._pending.clear()
        return self._trie.hash()

    def commit(self, delete_empty_objects: bool = True,
               keep_undo: bool = False) -> bytes:
        """Hash, add the new code to the store and make the writes final
        (``restore`` no longer applies); returns the root.  With
        ``keep_undo`` the undo log stays, so ``restore()`` can still put
        the store back (the rollback of a quarantined block)."""
        self._writes_store()
        root = self.intermediate_root(delete_empty_objects)
        for obj in self._objects.values():
            if obj.dirty_code and obj.code is not None:
                self.store.codes[obj.account.code_hash] = obj.code
                obj.dirty_code = False
        if not keep_undo:
            self._undo_accounts = {}
            self._undo_tries = {}
            self._undo_slots = {}
        return root

    def restore(self) -> None:
        """Undo every write ``intermediate_root`` made to the store since
        this StateDB opened (or last committed): the storage tries'
        keys, the store's storage-trie entries, then the accounts."""
        self._writes_store()
        for (_tid, key), (trie, raw) in self._undo_slots.items():
            if raw is None:
                trie.delete(key)
            else:
                trie.update(key, raw)
        for addr, trie in self._undo_tries.items():
            if trie is None:
                self.store.storage.pop(addr, None)
            else:
                self.store.storage[addr] = trie
        for addr, raw in self._undo_accounts.items():
            if raw is None:
                self._trie.delete(addr)
            else:
                self._trie.update(addr, raw)
        self._undo_accounts = {}
        self._undo_tries = {}
        self._undo_slots = {}
        self._storage_tries = {}


    def copy(self) -> "StateDB":
        """A view for speculative execution (statedb.go:809 Copy): the
        objects, logs, refund, access lists, transient storage and tx
        context copied, the store shared.  The copy only reads the store
        (its tries, and the storage tries this StateDB opened), so its
        ``intermediate_root``, ``commit`` and ``restore`` raise.  The
        undo journal does not carry over (its thunks close over this
        StateDB's objects): snapshots of the copy start fresh."""
        new = StateDB(self.store, flat=self.flat)
        new._shared = True
        new._trie = self._trie
        new.original_root = self.original_root
        new._dirty_counts = dict(self._dirty_counts)
        for addr, obj in self._objects.items():
            cp = StateObject(addr, obj.account.copy(), obj.fresh)
            cp.code = obj.code
            cp.origin_storage = dict(obj.origin_storage)
            cp.dirty_storage = dict(obj.dirty_storage)
            cp.pending_storage = dict(obj.pending_storage)
            cp.written_storage = dict(obj.written_storage)
            cp.suicided = obj.suicided
            cp.deleted = obj.deleted
            cp.dirty_code = obj.dirty_code
            cp.initial_root = obj.initial_root
            new._objects[addr] = cp
        new._destructed = set(self._destructed)
        new._mutated = set(self._mutated)
        new._pending = set(self._pending)
        new.refund = self.refund
        new.logs = [Log(l.address, list(l.topics), l.data, l.block_number,
                        l.tx_hash, l.tx_index, l.block_hash, l.index,
                        l.removed) for l in self.logs]
        new._log_index = self._log_index
        new._tx_hash, new._tx_index = self._tx_hash, self._tx_index
        new.created_this_tx = set(self.created_this_tx)
        new.access_list_addresses = set(self.access_list_addresses)
        new.access_list_slots = set(self.access_list_slots)
        new.transient = dict(self.transient)
        new.predicate_storage_slots = dict(self.predicate_storage_slots)
        new._storage_tries = dict(self._storage_tries)
        new.storage_gen, new.account_gen = self.storage_gen, self.account_gen
        return new


def _prepare_predicate_slots(rules, access_list) -> Dict[bytes, List[bytes]]:
    """Collect access-list storage slots addressed to active predicate
    precompiles (reference predicate/predicate_slots.go)."""
    out: Dict[bytes, List[bytes]] = {}
    for addr, keys in access_list:
        if addr in rules.predicaters:
            out.setdefault(addr, []).append(b"".join(keys))
    return out
