"""Crash-consistent checkpoint and resume for replay.

Port of reference ``replay/checkpoint.py``.  The commit pipeline
decouples execution from commitment (``replay/commit.py``); this module
makes the committed prefix a durable restart point.  At window-commit
boundaries the engine persists

  1. its trie nodes (the account trie and every live storage trie),
     through the engine store's node store (``StateStore(kv=)``, a
     ``PersistentNodeDict`` flushed to the append-only key-value log),
     then
  2. one small checkpoint record: the last committed block's number and
     hash, the state root, and the full header RLP (the resumed
     engine's ``parent_header``, which AP4+ fee validation requires).

The write order is the crash-consistency argument: the nodes are
fsynced before the record, so whichever record a reader finds, its
root's whole node closure is already durable.  A crash between the two
leaves the PREVIOUS record pointing at a complete trie (the new nodes
are unreachable orphans; tries are content-addressed, so orphans are
harmless).  The torn-tail truncation of ``rawdb.kv`` covers a kill in
the middle of a write.

The streaming pipeline is not part of the port yet, so a caller feeds
``CheckpointManager.on_committed`` itself, after each ``replay`` call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from coreth_tpu_torch import faults, obs
from coreth_tpu_torch.rawdb import schema
# fired between the node flush and the checkpoint-record write: the
# torn-checkpoint seam (a crash here must leave the PREVIOUS record
# valid); one point for the synchronous and the background path
from coreth_tpu_torch.state.flat.exporter import PT_CRASH_GAP
from coreth_tpu_torch.types.block import Header


@dataclass
class Checkpoint:
    number: int
    block_hash: bytes
    root: bytes
    header: Header


def load_checkpoint(kv) -> Optional[Checkpoint]:
    """The durable checkpoint record, or None on a fresh store."""
    rec = schema.read_replay_checkpoint(kv)
    if rec is None:
        return None
    number, block_hash, root, header_rlp = rec
    return Checkpoint(number=number, block_hash=block_hash, root=root,
                      header=Header.decode(header_rlp))


def resume_engine(config, kv, **engine_kw):
    """(engine, checkpoint) resumed from ``kv``'s record, or (None, None)
    when there is none (the caller starts from genesis).

    The engine's store is opened over ``kv`` at the record's root, with
    the backend that ``engine_kw``'s ``trie=`` / ``trie_check=`` ask for
    (the reference takes a ``Database`` over the same store instead).
    The persisted flat base reloads too: the entries stamped at or below
    the record's block are exactly the committed prefix (the exporter
    may have written newer ones before a crash; their number stamps
    exclude them), so the resumed engine starts with a warm flat layer
    instead of walking the tries cold."""
    ckpt = load_checkpoint(kv)
    if ckpt is None:
        return None, None
    from coreth_tpu_torch.replay.engine import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    store = StateStore(backend=engine_kw.get("trie", "native"),
                       check=engine_kw.get("trie_check", False), kv=kv,
                       root=ckpt.root)
    eng = ReplayEngine(config, store, parent_header=ckpt.header, **engine_kw)
    if eng.flat is not None:
        eng.flat.load(kv, ckpt.number)
    return eng, ckpt


class CheckpointManager:
    """Owns the checkpoint cadence of one engine.

    ``every`` is in committed blocks (the reference's
    ``CORETH_CHECKPOINT``); the caller feeds :meth:`on_committed` from
    its commit path and the manager checkpoints at every ``every``
    blocks.  The engine's store must be over ``kv`` (``StateStore(kv=)``).

    Two durability modes:

    - **background** (the default whenever the engine carries a flat
      layer; ``background=False`` is the reference's
      ``CORETH_CHECKPOINT_SYNC=1``): the execute thread only STAMPS a
      checkpoint marker into the flat store's generation log, O(1) and
      measured in ``stamp_ns``, and the
      :class:`~coreth_tpu_torch.state.flat.FlatExporter` worker
      re-derives the trie from the sealed diff generations, fsyncs the
      nodes and writes the record off the critical path.
    - **synchronous**: :meth:`write` folds, exports the engine's own
      tries and writes the record on the caller's thread.

    Both keep the write order (nodes durable before the record), so a
    found record always implies its root's full node closure.
    """

    def __init__(self, engine, kv, every: int,
                 background: Optional[bool] = None):
        if every <= 0:
            raise ValueError("checkpoint interval must be positive")
        if engine.store.kv is not kv:
            raise ValueError("checkpointing needs the engine's store over "
                             "the same kv (StateStore(kv=kv))")
        self.engine = engine
        self.kv = kv
        self.every = every
        self.written = 0
        self.last_number: Optional[int] = None
        self._since = 0
        self.stamp_ns = 0     # execute-thread cost of background stamps
        self.write_ns = 0     # execute-thread cost of synchronous writes
        flat = engine.flat
        if background is None:
            background = flat is not None
        if background and flat is None:
            raise ValueError("background checkpoints need the flat layer "
                             "(ReplayEngine(flat=True))")
        self.exporter = None
        if background:
            from coreth_tpu_torch.state.flat import FlatExporter
            # seed the shadow tries with a ONE-TIME synchronous commit of
            # the engine's current state: generations sealed before this
            # point are covered by the seed, so the worker starts cleanly
            # whenever the manager attaches
            seed_root = engine.commit()
            flat.mark_preexisting_exported()
            self.exporter = FlatExporter(flat, engine.store, kv,
                                         seed_root)
            self.exporter.on_record = self._on_record
            self.exporter.start()

    def _on_record(self, gen) -> None:
        """Exporter-thread callback: one durable record landed."""
        self.written += 1
        self.last_number = gen.number

    def on_committed(self, n_blocks: int) -> bool:
        """Account ``n_blocks`` newly committed blocks; checkpoint when
        the interval fills.  Returns True iff one was stamped or
        written."""
        self._since += n_blocks
        if self._since < self.every:
            return False
        self._since = 0
        if self.exporter is not None:
            return self.stamp()
        self.write()
        return True

    def stamp(self) -> bool:
        """Background mode: mark the flat store's tip as a checkpoint
        boundary (an empty marker generation the exporter turns into
        nodes and a record).  This is the only checkpoint work the
        execute thread pays."""
        self.engine.commit_pipe.flush()
        t0 = time.monotonic_ns()
        gen = self.engine.flat.mark_checkpoint()
        self.stamp_ns += time.monotonic_ns() - t0
        obs.instant("checkpoint/stamp", stamped=gen is not None)
        return gen is not None

    def drain(self, timeout_s: int = 120) -> None:
        """Block until the exporter has made every stamped checkpoint
        durable (the final checkpoint of a run)."""
        if self.exporter is not None:
            self.exporter.drain(timeout_s)

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.stop()

    def write(self) -> Optional[Checkpoint]:
        """Persist the current committed state as the restart point.  In
        background mode this stamps the tip and DRAINS the exporter;
        otherwise it is the on-thread export."""
        if self.exporter is not None:
            self.stamp()
            self.drain()
            # None when nothing could land (a held quarantine generation
            # blocks the exporter: a quarantined tip is not final)
            return load_checkpoint(self.kv)
        t0 = time.monotonic_ns()
        try:
            with obs.span("checkpoint/write_sync"):
                return self._write_sync()
        finally:
            self.write_ns += time.monotonic_ns() - t0

    def _write_sync(self) -> Checkpoint:
        eng = self.engine
        eng.commit_pipe.flush()
        header = eng.parent_header
        if header is None or not isinstance(header, Header):
            raise ValueError(
                "checkpointing needs the engine's parent_header (the last "
                "committed block's real header)")
        root = eng.commit()  # trie nodes -> the store's node store
        eng.store.node_db.flush()
        self.kv.flush()
        faults.fire(PT_CRASH_GAP)
        schema.write_replay_checkpoint(
            self.kv, header.number, header.hash(), root, header.encode())
        self.kv.flush()
        self.written += 1
        self.last_number = header.number
        return Checkpoint(number=header.number, block_hash=header.hash(),
                          root=root, header=header)

    def snapshot(self) -> dict:
        out = {"every": self.every, "written": self.written,
               "last_number": self.last_number,
               "background": self.exporter is not None,
               "stamp_us": self.stamp_ns // 1_000,
               "write_ms": self.write_ns // 1_000_000}
        if self.exporter is not None:
            out["exporter"] = self.exporter.snapshot()
        return out
