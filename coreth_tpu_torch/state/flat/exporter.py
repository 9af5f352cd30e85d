"""Background checkpoint exporter: Merkleization off the execute thread.

Port of reference ``state/flat/exporter.py``.  A synchronous checkpoint
(``CheckpointManager(background=False)``) pays the whole durability
event on the execute thread: fold, export the engine's trie nodes,
fsync, write the record.  This exporter moves everything but the O(1)
generation stamp to a worker thread:

- it owns SHADOW tries of the engine store's backend over the store's
  node store, seeded at the engine's root when the exporter attaches,
  and re-derives each sealed flat generation's state by folding the
  generation's deduped diffs (the account trie and each contract's
  storage trie), holding the result against the generation's recorded
  (header) root, so a divergence between the flat layer and the chain
  never becomes a durable checkpoint;
- at a checkpoint marker it commits the shadow nodes into the node
  store, flushes them to the key-value log, and only THEN writes the
  flat meta stamp and the checkpoint record (a record implies its
  root's full node closure);
- it writes each generation's flat entries (hash-keyed, number-stamped)
  as it goes, so the persisted flat base trails the live view by at
  most the queue depth.

Crash consistency: a kill anywhere leaves the previous record
authoritative (nodes flushed before the record; flat entries newer than
the record are skipped on reload by their number stamps).  The
``checkpoint/crash_gap`` point fires at the same node-flush/record
boundary as the synchronous path; ``flat/torn_write`` between a
generation's flat-entry writes and the meta/record write.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from coreth_tpu_torch import faults, obs, rlp
from coreth_tpu_torch.rawdb import schema
from coreth_tpu_torch.state.flat.store import (
    DELETED, PT_STALE, FlatGeneration, FlatStore,
)
from coreth_tpu_torch.types import StateAccount
from coreth_tpu_torch.types.account import EMPTY_ROOT_HASH as EMPTY_ROOT

# the torn-flat-write seam: a crash (or injected error) between a
# generation's flat-entry writes and the meta/record write must leave
# the previous record authoritative; a transient error retries the
# durable step (entry puts are idempotent)
PT_TORN = faults.declare(
    "flat/torn_write",
    "crash window between flat-entry writes and the meta/record write")

# the node-flush/record boundary, shared with the synchronous path of
# replay/checkpoint.py, so one fault plan covers both paths
PT_CRASH_GAP = faults.declare(
    "checkpoint/crash_gap",
    "crash window between trie-node flush and checkpoint-record write")


class ExporterError(Exception):
    pass


# host-side poll cadences of the worker loop and the drain spin
_POLL_S = 0.05
_DRAIN_POLL_S = 0.005


class FlatExporter:
    """Drains a FlatStore's sealed generations on a worker thread and
    turns checkpoint markers into durable records."""

    DURABLE_RETRIES = 3

    def __init__(self, flat: FlatStore, store, kv, start_root: bytes):
        """``store``: the engine's ``StateStore`` over ``kv``; the
        shadow tries are of its backend (C++, Python, or C++ with the
        Python twin under ``check``) and read its node store, where the
        closure of ``start_root`` already is."""
        self.flat = flat
        self.store = store
        self.kv = kv
        self._backend = store.backend
        self.trie = self.store.open_trie(start_root)
        self.storage_tries: Dict[bytes, object] = {}
        self.on_record = None     # callback(gen) after a record lands
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ---- counters (export cost beside the stamp cost), written by
        # the export worker and read by snapshot()/drain() on the
        # caller's thread: every write holds _mu
        self._mu = threading.Lock()
        self.exports = 0
        self.records = 0
        self.stale_skips = 0
        self.entries_written = 0
        self.export_ns = 0        # worker wall time applying+writing

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        self.flat.attach_exporter()
        self._thread = threading.Thread(
            target=self._loop, name="flat-exporter", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)

    def drain(self, timeout_s: int = 60) -> None:
        """Block until every sealed generation is exported (the
        synchronous tail of a stream: the final checkpoint).  Raises
        the exporter's error, if any."""
        deadline = time.monotonic_ns() + timeout_s * 1_000_000_000
        while not self.flat.drained():
            if self.error is not None:
                raise ExporterError(
                    "flat exporter failed") from self.error
            if time.monotonic_ns() > deadline:
                raise ExporterError("flat exporter drain timed out")
            time.sleep(_DRAIN_POLL_S)
        if self.error is not None:
            raise ExporterError("flat exporter failed") from self.error

    # --------------------------------------------------------------- loop
    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.error is not None:
                time.sleep(_POLL_S)
                continue
            gen = self.flat.next_for_export(_POLL_S)
            if gen is None:
                continue
            if gen.exported or gen.rolled_back:
                # a stale handout (the flat/stale_generation shape):
                # double-applying its diffs would corrupt the shadow
                # tries — detect by flag and skip
                with self._mu:
                    self.stale_skips += 1
                continue
            t0 = time.monotonic_ns()
            try:
                self._export(gen)
            except Exception as exc:
                # a failed export must not end this thread unseen:
                # drain() raises it on the caller's thread
                with self._mu:
                    self.error = exc
            finally:
                dt = time.monotonic_ns() - t0
                with self._mu:
                    self.export_ns += dt

    # ------------------------------------------------------------- export
    def _storage_trie(self, addr: bytes):
        st = self.storage_tries.get(addr)
        if st is None:
            raw = self.trie.get(addr)
            root = StateAccount.from_rlp(raw).root if raw is not None \
                else EMPTY_ROOT
            st = self.store.open_trie(root)
            self.storage_tries[addr] = st
        return st

    def _apply(self, gen: FlatGeneration) -> None:
        """Fold one generation's diffs into the shadow tries and verify
        the root — the background Merkleization."""
        for addr in gen.destructs:
            # the pre-destruct storage is dead wholesale (even on
            # destruct+re-create); later slot writes repopulate
            self.storage_tries[addr] = self.store.open_trie(EMPTY_ROOT)
        by_contract: Dict[bytes, list] = {}
        for (addr, key) in sorted(gen.storage):
            by_contract.setdefault(addr, []).append(key)
        for addr, keys in by_contract.items():
            st = self._storage_trie(addr)
            for key in keys:
                v = gen.storage[(addr, key)]
                if v == 0:
                    st.delete(key)
                else:
                    st.update(key, rlp.encode(
                        v.to_bytes(32, "big").lstrip(b"\x00")))
        for addr in sorted(gen.accounts):
            v = gen.accounts[addr]
            if v is DELETED:
                self.trie.delete(addr)
                self.storage_tries.pop(addr, None)
                continue
            balance, nonce, root, code_hash, multicoin = v
            st = self.storage_tries.get(addr)
            if st is not None and st.hash() != root:
                raise ExporterError(
                    f"shadow storage root diverged for "
                    f"{addr.hex()} at block {gen.number}")
            self.trie.update(addr, StateAccount(
                nonce=nonce, balance=balance, root=root,
                code_hash=code_hash, is_multi_coin=multicoin).rlp())
        got = self.trie.hash()
        if got != gen.root:
            raise ExporterError(
                f"shadow state root diverged at block {gen.number}: "
                f"{got.hex()} != {gen.root.hex()}")

    def _durable(self, gen: FlatGeneration) -> None:
        """The write-ordered durability step (retryable: every write
        is an idempotent put)."""
        written = self.flat.write_gen_entries(self.kv, gen)
        with self._mu:
            self.entries_written += written
        faults.fire(PT_TORN)
        if gen.checkpoint:
            # nodes first — the record-implies-closure invariant
            self.store.commit_trie(self.trie)
            for st in self.storage_tries.values():
                self.store.commit_trie(st)
            self.store.node_db.flush()
            self.kv.flush()
            faults.fire(PT_CRASH_GAP)
            schema.write_flat_meta(self.kv, gen.number, gen.root)
            schema.write_replay_checkpoint(
                self.kv, gen.number, gen.block_hash, gen.root,
                gen.header.encode())
            self.kv.flush()
            with self._mu:
                self.records += 1
            if self.on_record is not None:
                self.on_record(gen)

    def _export(self, gen: FlatGeneration) -> None:
        # flow id = block number: the block's trace arrow continues
        # from the execute thread onto this worker's timeline row
        with obs.span("flat/export", flow=gen.number,
                      checkpoint=bool(gen.checkpoint)):
            self._apply(gen)
            for attempt in range(self.DURABLE_RETRIES):
                try:
                    self._durable(gen)
                    break
                except faults.FaultInjected:
                    if attempt == self.DURABLE_RETRIES - 1:
                        raise
                    continue
            self.flat.mark_exported(gen)
            with self._mu:
                self.exports += 1

    # ------------------------------------------------------------ report
    def snapshot(self) -> dict:
        return {
            "backend": self._backend,
            "exports": self.exports,
            "records": self.records,
            "stale_skips": self.stale_skips,
            "entries_written": self.entries_written,
            "export_ms": self.export_ns // 1_000_000,
            "failed": self.error is not None,
        }
