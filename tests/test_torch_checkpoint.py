"""The port's rawdb, checkpoints and flat exporter on the CPU, against
the JAX reference.

Mirrors tests/test_rawdb.py (the FileDB round trip :30, the torn tail
:51, the deferred node dict :68: both packages write the same log files
byte for byte), tests/test_checkpoint_resume.py (the record round trip
:45, the torn checkpoint keeping the previous record in background and
sync modes :91) and the exporter cases of tests/test_flat_state.py
whose streaming pipeline only feeds ``on_committed`` (:376, :413, :457,
:476, :505): here the manager is driven by hand, ``on_committed`` after
each chunk of blocks, as the pipeline would after each committed block.
The checkpoints carry state across the packages both ways: a FileDB
the reference's ``CheckpointManager`` wrote (record, nodes, flat base)
resumes in the port's ``resume_engine`` and replays to the true root,
and the reverse.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu import faults as rfaults
from coreth_tpu import rawdb as rrawdb
from coreth_tpu.replay import checkpoint as rckpt
from coreth_tpu.types import Block as RBlock
from coreth_tpu.types.block import Header as RHeader

from coreth_tpu_torch import faults, rawdb
from coreth_tpu_torch.chain import Genesis
from coreth_tpu_torch.faults import FaultInjected, FaultPlan, FaultSpec
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.replay import checkpoint as tckpt
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.state.flat import ExporterError
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.types.block import Header

import test_shard_replay as SR
from ckpt_child import open_db
from test_torch_trie_backend import _port_alloc

KW = dict(capacity=256, batch_pad=64, window=4, device="cpu")


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    faults.disarm()
    rfaults.disarm()


@pytest.fixture(scope="module")
def transfers():
    return SR._build_chain(8, SR._gen_transfer)


@pytest.fixture(scope="module")
def tokens():
    return SR._build_chain(6, SR._gen_erc20)


def _fresh(blocks, cls=Block):
    return [cls.decode(b.encode()) for b in blocks]


def _log(tmp_path, name):
    return str(tmp_path / name / "chain.db")


# ------------------------------------------------------------------ rawdb

def _filedb_script(pkg, path):
    db = pkg.FileDB(path)
    db.put(b"a", b"1")
    db.put(b"b", b"2")
    db.put(b"a", b"3")       # overwrite
    db.delete(b"b")
    db.close()
    db2 = pkg.FileDB(path)
    seen = [db2.get(b"a"), db2.get(b"b"), db2._garbage]
    db2.compact()
    seen.append(db2.get(b"a"))
    db2.put(b"c", b"4")
    db2.close()
    db3 = pkg.FileDB(path)
    seen += [db3.get(b"a"), db3.get(b"c")]
    db3.close()
    with open(path, "rb") as f:
        return seen, f.read()


def test_filedb_roundtrip_and_reopen(tmp_path):
    ref = _filedb_script(rrawdb, str(tmp_path / "r.log"))
    port = _filedb_script(rawdb, str(tmp_path / "t.log"))
    assert port == ref
    assert port[0] == [b"3", None, 2, b"3", b"3", b"4"]


def _torn_script(pkg, path):
    db = pkg.FileDB(path)
    db.put(b"k1", b"v1")
    db.close()
    # a crash mid-write: half a record appended
    with open(path, "ab") as f:
        f.write(b"\x05\x00\x00\x00\x10\x00\x00\x00par")
    db2 = pkg.FileDB(path)
    seen = [db2.get(b"k1")]
    db2.put(b"k2", b"v2")    # appends land after the truncated tail
    db2.close()
    db3 = pkg.FileDB(path)
    seen.append(db3.get(b"k2"))
    db3.close()
    with open(path, "rb") as f:
        return seen, f.read()


def test_filedb_truncates_torn_tail(tmp_path):
    ref = _torn_script(rrawdb, str(tmp_path / "r.log"))
    port = _torn_script(rawdb, str(tmp_path / "t.log"))
    assert port == ref and port[0] == [b"v1", b"v2"]


def test_persistent_node_dict_defers_until_flush():
    def script(pkg):
        kv = pkg.MemDB()
        nodes = pkg.PersistentNodeDict(kv)
        nodes[b"\x01" * 32] = b"node1"
        seen = [kv.get(b"n" + b"\x01" * 32), nodes.flush(),
                kv.get(b"n" + b"\x01" * 32)]
        fresh = pkg.PersistentNodeDict(kv)
        seen.append(fresh[b"\x01" * 32])
        with pytest.raises(KeyError):
            fresh[b"\x02" * 32]
        code = pkg.PersistentCodeDict(kv)
        code[b"\x03" * 32] = b"\x60\x00"
        seen.append(sorted(kv.items()))
        return seen

    assert script(rawdb) == script(rrawdb)
    assert script(rawdb)[:4] == [None, 1, b"node1", b"node1"]


def test_checkpoint_record_roundtrip(tmp_path):
    """The record, written by either package, reads back in both."""
    h = Header(number=7, root=b"\x11" * 32, time=1234, gas_limit=8_000_000)
    assert h.encode() == RHeader(number=7, root=b"\x11" * 32, time=1234,
                                 gas_limit=8_000_000).encode()
    for writer in (rawdb, rrawdb):
        path = str(tmp_path / writer.__name__ / "c.db")
        kv = writer.FileDB(path)
        assert tckpt.load_checkpoint(kv) is None
        writer.schema.write_replay_checkpoint(kv, 7, h.hash(), h.root,
                                              h.encode())
        writer.schema.write_replay_checkpoint(kv, 5, h.hash(), h.root,
                                              h.encode(), worker="w1")
        kv.close()
        for reader, db in ((tckpt, rawdb), (rckpt, rrawdb)):
            kv2 = db.FileDB(path)
            ck = reader.load_checkpoint(kv2)
            assert (ck.number, ck.block_hash, ck.root) \
                == (7, h.hash(), h.root)
            assert ck.header.encode() == h.encode()
            assert db.schema.read_replay_checkpoint(kv2, "w1")[0] == 5
            kv2.close()


@pytest.mark.parametrize("backend", ["native", "py"])
def test_missing_storage_closure_raises(backend):
    """A store over a key-value store whose account names a storage root
    that is not in the node store raises, as the reference's trie does on
    its first read, instead of reading zeros."""
    from coreth_tpu.mpt.trie import MissingNodeError as RMissingNodeError
    from coreth_tpu.mpt.trie import SecureTrie as RSecureTrie
    from coreth_tpu_torch.mpt.trie import MissingNodeError
    from coreth_tpu_torch.types import StateAccount
    store = StateStore(backend=backend, kv=rawdb.MemDB())
    addr, lost = b"\x0a" * 20, b"\x0b" * 20
    store.trie.update(addr, StateAccount(nonce=1).rlp())
    store.trie.update(lost, StateAccount(nonce=1, root=b"\x77" * 32).rlp())
    assert store.storage.get(addr) is None
    assert store.storage_value(addr, b"\x00" * 32) == 0
    with pytest.raises(MissingNodeError, match="not in the node store"):
        store.storage_value(lost, b"\x00" * 32)
    with pytest.raises(RMissingNodeError):
        RSecureTrie(root_hash=b"\x77" * 32, db={}).get(b"\x00" * 32)


# ------------------------------------------------------------ checkpoints

def _disk_engine(path, **kw):
    """A port engine over a fresh FileDB: (kv, store, engine)."""
    kv = rawdb.FileDB(path)
    store = StateStore(backend=kw.get("trie", "native"), kv=kv)
    g = Genesis(config=CFG, gas_limit=8_000_000,
                alloc=_port_alloc()).to_block(store)
    eng = ReplayEngine(CFG, store, parent_header=g.header,
                       **dict(KW, **kw))
    return kv, store, eng


def _ref_disk_engine(path):
    kv, db = open_db(os.path.dirname(path))
    g = SR.Genesis(config=SR.CFG, gas_limit=8_000_000,
                   alloc=SR._alloc()).to_block(db)
    eng = SR.ReplayEngine(SR.CFG, db, g.root, parent_header=g.header,
                          capacity=256, batch_pad=64, window=4)
    return kv, db, eng


def _stream(eng, mgr, blocks, cls=Block, every=2):
    """Replay ``blocks`` in chunks of ``every``, feeding the manager after
    each (the streaming pipeline's commit callback), then the final
    checkpoint."""
    for i in range(0, len(blocks), every):
        chunk = _fresh(blocks[i:i + every], cls)
        eng.replay(chunk)
        mgr.on_committed(len(chunk))
    mgr.write()


def test_background_checkpoint_off_execute_thread(tmp_path, transfers):
    """The execute thread only stamps generation boundaries while the
    exporter thread re-derives the tries and writes the records; a
    resume reloads the persisted flat base and finishes on the exact
    root."""
    path = _log(tmp_path, "bg")
    kv, _store, eng = _disk_engine(path)
    mgr = tckpt.CheckpointManager(eng, kv, every=2)
    _stream(eng, mgr, transfers[:6])
    ck = mgr.snapshot()
    mgr.close()
    assert ck["background"] is True and ck["written"] >= 2
    exp = ck["exporter"]
    assert exp["exports"] > 0 and exp["records"] == ck["written"]
    assert not exp["failed"] and exp["entries_written"] > 0
    assert ck["last_number"] == transfers[5].number
    kv.close()

    kv2 = rawdb.FileDB(path)
    eng2, ckpt = tckpt.resume_engine(CFG, kv2, **KW)
    assert ckpt.number == transfers[5].number
    assert eng2.root == transfers[5].header.root
    assert eng2.flat.loaded_entries > 0
    assert eng2.replay(_fresh(transfers[6:])) == transfers[-1].header.root
    kv2.close()


@pytest.mark.parametrize("backend", ["native", "py"])
def test_exporter_shadow_trie_backend(tmp_path, tokens, backend):
    """The exporter's shadow tries are of the engine store's backend; an
    ERC-20 chain, so the contract's storage trie folds too.  Both land
    the records and the resume root."""
    path = _log(tmp_path, backend)
    kv, _store, eng = _disk_engine(path, trie=backend)
    mgr = tckpt.CheckpointManager(eng, kv, every=2)
    _stream(eng, mgr, tokens)
    ck = mgr.snapshot()
    mgr.close()
    assert ck["written"] >= 2
    assert ck["exporter"]["backend"] == backend
    assert ck["exporter"]["records"] == ck["written"]
    assert eng.root == tokens[-1].header.root
    kv.close()
    kv2 = rawdb.FileDB(path)
    eng2, ckpt = tckpt.resume_engine(CFG, kv2, trie=backend, **KW)
    assert ckpt.root == tokens[ckpt.number - 1].header.root
    kv2.close()


def test_checkpoint_sync_mode(tmp_path, transfers):
    """``background=False`` (the reference's ``CORETH_CHECKPOINT_SYNC=1``):
    the same records, no exporter thread."""
    kv, _store, eng = _disk_engine(_log(tmp_path, "sync"))
    mgr = tckpt.CheckpointManager(eng, kv, every=3, background=False)
    _stream(eng, mgr, transfers[:6], every=3)
    snap = mgr.snapshot()
    assert snap["background"] is False and snap["written"] >= 2
    assert snap["last_number"] == transfers[5].number
    kv.close()


@pytest.mark.parametrize("background", [False, True])
def test_torn_checkpoint_keeps_previous(tmp_path, transfers, background):
    """``checkpoint/crash_gap``: a failure between the node flush and the
    record write leaves the previous record authoritative; a resume from
    it replays the tail to the true root.  The synchronous write raises
    FaultInjected; the exporter retries, gives up, and the drain raises
    ExporterError."""
    path = _log(tmp_path, str(background))
    kv, _store, eng = _disk_engine(path)
    eng.replay(_fresh(transfers[:4]))
    mgr = tckpt.CheckpointManager(eng, kv, every=1, background=background)
    mgr.write()
    first = tckpt.load_checkpoint(kv)
    assert first.number == transfers[3].number
    eng.replay(_fresh(transfers[4:]))
    with faults.armed(FaultPlan({"checkpoint/crash_gap": FaultSpec()})):
        with pytest.raises(ExporterError if background else FaultInjected):
            mgr.write()
    mgr.close()
    ck = tckpt.load_checkpoint(kv)
    assert (ck.number, ck.root) == (first.number, first.root)
    kv.close()
    kv2 = rawdb.FileDB(path)
    eng2, ckpt = tckpt.resume_engine(CFG, kv2, **KW)
    assert ckpt.number == first.number
    assert eng2.replay(_fresh(transfers[ckpt.number:])) \
        == transfers[-1].header.root
    kv2.close()


def test_torn_flat_write_retries(tmp_path, transfers):
    """``flat/torn_write``, transient: the exporter's bounded retry absorbs
    the failures (its writes are idempotent puts); the records land."""
    kv, _store, eng = _disk_engine(_log(tmp_path, "torn"))
    with faults.armed(FaultPlan({"flat/torn_write":
                                 FaultSpec(times=2)})) as plan:
        mgr = tckpt.CheckpointManager(eng, kv, every=2)
        _stream(eng, mgr, transfers[:6])
        assert plan.fired()["flat/torn_write"] == 2
    snap = mgr.snapshot()
    mgr.close()
    assert snap["written"] >= 2 and not snap["exporter"]["failed"]
    assert eng.root == transfers[5].header.root
    kv.close()


def test_torn_flat_write_persistent_keeps_previous(tmp_path, transfers):
    """``flat/torn_write``, persistent: the exporter exhausts its retries
    and the drain raises; the record before the fault stays, and a
    resume from it replays to the true root."""
    path = _log(tmp_path, "persist")
    kv, _store, eng = _disk_engine(path)
    with faults.armed(FaultPlan({"flat/torn_write": FaultSpec(after=2)})):
        mgr = tckpt.CheckpointManager(eng, kv, every=2)
        with pytest.raises(ExporterError):
            _stream(eng, mgr, transfers)
    mgr.close()
    ck = tckpt.load_checkpoint(kv)
    assert ck is not None and ck.number < transfers[-1].number
    kv.close()
    kv2 = rawdb.FileDB(path)
    eng2, ckpt = tckpt.resume_engine(CFG, kv2, **KW)
    assert eng2.replay(_fresh(transfers[ckpt.number:])) \
        == transfers[-1].header.root
    kv2.close()


def test_stale_generation_handout_skipped(tmp_path, transfers):
    """``flat/stale_generation``: the queue hands back an exported
    generation; the exporter skips it by its flag and the later records
    stay right."""
    kv, _store, eng = _disk_engine(_log(tmp_path, "stale"))
    with faults.armed(FaultPlan({"flat/stale_generation":
                                 FaultSpec(times=3)})):
        mgr = tckpt.CheckpointManager(eng, kv, every=2)
        _stream(eng, mgr, transfers)
    snap = mgr.snapshot()
    mgr.close()
    assert snap["exporter"]["stale_skips"] >= 1
    assert not snap["exporter"]["failed"] and snap["written"] >= 2
    assert snap["last_number"] == transfers[-1].number
    assert eng.root == transfers[-1].header.root
    kv.close()


def test_exporter_under_a_short_switch_interval(tmp_path, transfers):
    """The execute thread sealing and stamping a generation every block
    while the exporter drains them, with the interpreter switching
    threads every microsecond: every record lands on its block's root,
    the exporter's thread ends on close, and the resume is exact."""
    path = _log(tmp_path, "stress")
    kv, _store, eng = _disk_engine(path, window=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = tckpt.CheckpointManager(eng, kv, every=1)
        roots = {}

        def landed(gen, real=mgr._on_record):
            roots[gen.number] = gen.root
            real(gen)

        mgr.exporter.on_record = landed
        _stream(eng, mgr, transfers[:6], every=1)
        mgr.close()
    finally:
        sys.setswitchinterval(interval)
    assert not mgr.exporter._thread.is_alive()
    assert not mgr.snapshot()["exporter"]["failed"]
    assert roots and all(root == transfers[n - 1].header.root
                         for n, root in roots.items())
    assert max(roots) == transfers[5].number
    kv.close()
    kv2 = rawdb.FileDB(path)
    eng2, ckpt = tckpt.resume_engine(CFG, kv2, **KW)
    assert ckpt.number == transfers[5].number
    assert eng2.replay(_fresh(transfers[6:])) == transfers[-1].header.root
    kv2.close()


def test_quarantined_tip_is_not_exported(tmp_path, transfers):
    """A quarantined block's generation is held: the final checkpoint
    covers the prefix before it, and after ``rollback_block`` the true
    block replays and checkpoints."""
    kv, _store, eng = _disk_engine(_log(tmp_path, "hold"))
    mgr = tckpt.CheckpointManager(eng, kv, every=2)
    _stream(eng, mgr, transfers[:4])
    bad = _fresh(transfers[4:5])[0]
    bad.transactions.pop()
    assert eng.quarantine_block(bad)
    mgr.on_committed(1)
    assert mgr.write().number == transfers[3].number
    eng.rollback_block(bad)
    _stream(eng, mgr, transfers[4:])
    mgr.close()
    assert tckpt.load_checkpoint(kv).number == transfers[-1].number
    kv.close()


# ------------------------------------------------- state across packages

def test_reference_checkpoint_resumes_in_the_port(tmp_path, tokens):
    """A FileDB the reference's background CheckpointManager wrote
    (record, trie nodes, code, flat base) resumes in the port's
    ``resume_engine`` and replays the tail to the true root."""
    path = _log(tmp_path, "ref")
    kv, _db, ref = _ref_disk_engine(path)
    mgr = rckpt.CheckpointManager(ref, kv, every=2)
    for i in range(0, 4, 2):
        ref.replay(_fresh(tokens[i:i + 2], RBlock))
        mgr.on_committed(2)
    mgr.write()
    mgr.close()
    kv.close()
    kv2 = rawdb.FileDB(path)
    port, ckpt = tckpt.resume_engine(CFG, kv2, **KW)
    assert ckpt.number == tokens[3].number
    assert port.flat.loaded_entries > 0
    assert port.replay(_fresh(tokens[4:])) == tokens[-1].header.root
    kv2.close()


def test_port_checkpoint_resumes_in_the_reference(tmp_path, tokens):
    """The reverse: the reference resumes a store the port wrote."""
    path = _log(tmp_path, "port")
    kv, _store, port = _disk_engine(path)
    mgr = tckpt.CheckpointManager(port, kv, every=2)
    _stream(port, mgr, tokens[:4])
    mgr.close()
    kv.close()
    kv2, db2 = open_db(os.path.dirname(path))
    ref, ckpt = rckpt.resume_engine(SR.CFG, db2, kv2, capacity=256,
                                    batch_pad=64, window=4)
    assert ckpt.number == tokens[3].number
    assert ref.flat.loaded_entries > 0
    assert ref.replay(_fresh(tokens[4:], RBlock)) == tokens[-1].header.root
    kv2.close()
