"""Window-batched trie commit — state-root folding off the critical path.

Port of reference ``replay/commit.py``.  Finished blocks STAGE their
effects: contract storage writes deduped to the last value per
(contract, slot), account states to the last value per address, across
the whole window.  ``flush()`` — once per window, after the next
window's device launch is already queued on the transfer path, once
per block on the machine path — folds each contract's writes into its
storage trie, puts the new storage roots into the account fold, folds
the accounts, then checks the root against the last staged block's
header.  Intermediate per-block roots are never
materialized; the window root must equal the chain's.

The fold follows the store's backend (the engine's ``trie=``): on the
C++ tries one fold-and-root call per trie; on Python tries
(``trie="py"``, the reference's ``CORETH_TRIE=py``) the same deduped
loop through ``mpt/trie.py``, each trie then rehashed level by level by
``mpt/rehash.py device_rehash`` (K3's entry for the levels of at least
``engine.rehash_min_batch`` encodings, the host below that).  With
``trie_check`` the C++ folds run through ``CheckedSecureTrie``, which
re-derives every root on the Python twin.

With the engine's flat layer, a flush that lands on its header's root
seals the window as ONE flat generation (``FlatStore.apply_generation``,
reference ``commit.py:241-263``): each staged account's tuple with its
fresh storage root, an EIP-158 deletion as ``DELETED``, and the deduped
slot writes.

A flush passes the ``commit/flush_fail`` injection point first,
through the supervisor's retry policy (``retry_point``): a transient
fault retries, a persistent one is fatal (no other commit backend).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from coreth_tpu_torch import faults, obs, rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.mpt.rehash import device_rehash
from coreth_tpu_torch.state.flat import DELETED as FLAT_DELETED
from coreth_tpu_torch.types.account import (
    EMPTY_CODE_HASH, EMPTY_ROOT_HASH, StateAccount,
)

# Injection point: the window fold fails (a device rehash hiccup, an
# I/O error in the native trie).  Transient plans retry with the
# supervisor's backoff; a persistent flush failure is fatal — there is
# no alternative commit backend, so it surfaces to the caller.
PT_FLUSH = faults.declare(
    "commit/flush_fail", "window trie-fold flush failure")


class CommitPipeline:
    """Per-engine staging buffer + window flusher for trie commits."""

    def __init__(self, engine):
        self.e = engine
        # last-value-per-(contract, slot): values are ints (0 => delete)
        self.writes: Dict[Tuple[bytes, bytes], int] = {}
        # last-value-per-address: addr -> (balance, nonce)
        self.accounts: Dict[bytes, Tuple[int, int]] = {}
        self.expected_root: Optional[bytes] = None
        self.expected_number: Optional[int] = None
        self.expected_header = None
        self.staged_blocks = 0
        self.fold_s = 0.0
        self.fold_calls = 0
        self.fold_blocks = 0
        # slot-key keccak memo: slots recur across windows
        self._key_hash: Dict[bytes, bytes] = {}

    def stage(self, header, accounts: Dict[bytes, Tuple[int, int]],
              writes: Optional[Dict[Tuple[bytes, bytes], int]] = None
              ) -> None:
        """Queue one finished block's account states and storage writes;
        later stages of the same account or slot overwrite earlier ones
        (window dedup)."""
        self.accounts.update(accounts)
        if writes:
            self.writes.update(writes)
        self.expected_root = header.root
        self.expected_number = header.number
        self.expected_header = header
        self.staged_blocks += 1

    def pending(self) -> bool:
        return self.staged_blocks > 0

    def account_view(self, addr: bytes) -> Optional[Tuple[int, int]]:
        """(balance, nonce) staged but not yet folded, else None."""
        return self.accounts.get(addr)

    def base_value(self, contract: bytes, key: bytes) -> Optional[int]:
        """Staged-but-unfolded storage value, else None."""
        return self.writes.get((contract, key))

    def _hash_key(self, key: bytes) -> bytes:
        h = self._key_hash.get(key)
        if h is None:
            h = self._key_hash[key] = keccak256(key)
        return h

    def _rehash(self, trie) -> bytes:
        e = self.e
        return device_rehash(trie, min_batch=e.rehash_min_batch,
                             device=e.device)

    def _fold_storage(self) -> None:
        """One fold per written contract; the new roots go into
        ``state.roots`` for the account fold."""
        e = self.e
        by_contract: Dict[bytes, list] = {}
        for (contract, key), v in self.writes.items():
            by_contract.setdefault(contract, []).append((key, v))
        for contract, kvs in by_contract.items():
            st = e._storage_trie(contract)
            if e.trie_backend == "native":
                keys = b"".join(self._hash_key(k) for k, _v in kvs)
                vals = b"".join(v.to_bytes(32, "big") for _k, v in kvs)
                root = st.fold_storage(keys, vals, len(kvs))
            else:
                for key, v in kvs:
                    if v == 0:
                        st.delete(key)
                    else:
                        st.update(key, rlp.encode(
                            v.to_bytes(32, "big").lstrip(b"\x00")))
                root = self._rehash(st)
            e.state.roots[e.state.index[contract]] = root

    def _fold_accounts(self) -> bytes:
        e = self.e
        if e.trie_backend != "native":
            return self._fold_accounts_py()
        state = e.state
        n = len(self.accounts)
        keys = bytearray()
        bals = bytearray()
        roots = bytearray()
        hashes = bytearray()
        mc = bytearray(n)
        dels = bytearray(n)
        nlist = []
        for i, (addr, (balance, nonce)) in enumerate(self.accounts.items()):
            idx = state.index[addr]
            keys += state.addr_hashes[idx]
            code_hash = state.code_hashes[idx]
            storage_root = state.roots[idx]
            if (balance == 0 and nonce == 0
                    and code_hash == EMPTY_CODE_HASH
                    and storage_root == EMPTY_ROOT_HASH
                    and not state.multicoin[idx]):
                dels[i] = 1  # EIP-158 touched-empty deletion
            bals += balance.to_bytes(32, "big")
            roots += storage_root
            hashes += code_hash
            mc[i] = 1 if state.multicoin[idx] else 0
            nlist.append(nonce)
        return e.trie.fold_accounts_root(
            bytes(keys), bytes(bals), nlist, bytes(roots), bytes(hashes),
            bytes(mc), bytes(dels))

    def _fold_accounts_py(self) -> bytes:
        e = self.e
        state = e.state
        for addr, (balance, nonce) in self.accounts.items():
            idx = state.index[addr]
            code_hash = state.code_hashes[idx]
            storage_root = state.roots[idx]
            if (balance == 0 and nonce == 0
                    and code_hash == EMPTY_CODE_HASH
                    and storage_root == EMPTY_ROOT_HASH
                    and not state.multicoin[idx]):
                e.trie.delete(addr)  # EIP-158 touched-empty deletion
            else:
                e.trie.update(addr, StateAccount(
                    nonce=nonce, balance=balance, root=storage_root,
                    code_hash=code_hash,
                    is_multi_coin=state.multicoin[idx]).rlp())
        return self._rehash(e.trie)

    def flush(self) -> bytes:
        """Fold the staged window (storage first — the account fold
        consumes the fresh storage roots — then accounts), check the
        root against the last staged header, advance ``engine.root``."""
        if not self.staged_blocks:
            return self.e.root
        with obs.span("commit/flush", blocks=self.staged_blocks):
            return self._flush()

    def _flush(self) -> bytes:
        e = self.e
        from coreth_tpu_torch.replay.engine import ReplayError
        # the injected gate retries transient faults with backoff BEFORE
        # the fold runs (the fold itself must not re-run)
        e.supervisor.retry_point("commit", PT_FLUSH)
        prev_root = e.root
        t0 = time.monotonic()
        self._fold_storage()
        root = self._fold_accounts()
        dt = time.monotonic() - t0
        self.fold_s += dt
        e.stats.t_trie += dt
        self.fold_calls += 1
        self.fold_blocks += self.staged_blocks
        expected, number = self.expected_root, self.expected_number
        header = self.expected_header
        n_blocks = self.staged_blocks
        writes, accounts = self.writes, self.accounts
        self.writes = {}
        self.accounts = {}
        self.staged_blocks = 0
        self.expected_root = None
        self.expected_number = None
        self.expected_header = None
        if root != expected:
            raise ReplayError(
                f"state root mismatch at block {number} "
                f"(commit window of {n_blocks}): {root.hex()} != "
                f"{expected.hex()}")
        e.root = root
        if e.flat is not None:
            self._seal_generation(header, prev_root, root, accounts, writes)
        return root

    def _seal_generation(self, header, prev_root: bytes, root: bytes,
                         accounts, writes) -> None:
        """The folded window as one flat generation: the post-fold
        storage roots are in ``state.roots``, so the account tuples are
        complete (the checkpoint exporter re-derives and root-checks
        the tries from exactly this diff)."""
        state = self.e.state
        gen_accounts: Dict[bytes, object] = {}
        for addr, (balance, nonce) in accounts.items():
            idx = state.index[addr]
            code_hash = state.code_hashes[idx]
            storage_root = state.roots[idx]
            multicoin = bool(state.multicoin[idx])
            if (balance == 0 and nonce == 0
                    and code_hash == EMPTY_CODE_HASH
                    and storage_root == EMPTY_ROOT_HASH
                    and not multicoin):
                gen_accounts[addr] = FLAT_DELETED  # EIP-158 deletion
            else:
                gen_accounts[addr] = (balance, nonce, storage_root,
                                      code_hash, multicoin)
        self.e.flat.apply_generation(
            number=header.number, block_hash=header.hash(), root=root,
            header=header, prev_root=prev_root, accounts=gen_accounts,
            storage=writes, kind="window")
