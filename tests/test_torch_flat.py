"""The port's flat-state layer on the CPU, against the JAX reference.

Mirrors tests/test_flat_state.py: the store (reads, fills and
generations :76, destruct masks and rollback :109, the persistence trust
filter :127 and destruct barrier :167, the checkpoint marker and
hold/release :205), the read path (the oracle-armed replay over
transfer / erc20 / swap x native / py :243, the oracle catching a
poisoned entry in the engine and in ``StateDB`` :261, flat on against
off :283), the rollback (quarantine then rollback on both backends
:308, the refusal of a non-quarantine tip :355) and
``flat_diff_from_statedb`` :526.  Each case runs both packages in this
process on the same inputs and compares them: the store cases the
observations and the persisted key-value records byte for byte, the
replay cases the roots (each the header's) and the flat snapshots'
generation counts.  The reference's switches are its environment
(``CORETH_FLAT``, ``CORETH_FLAT_CHECK``, ``CORETH_TRIE``); the port's are
the engine's keywords.  The pipeline-driven cases wait for the
streaming pipeline; the exporter's cases, driven by hand, are in
tests/test_torch_checkpoint.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu.rawdb.kv import MemDB as RMemDB
from coreth_tpu.replay.engine import ReplayError as RReplayError
from coreth_tpu.state import Database as RDatabase
from coreth_tpu.state import StateDB as RStateDB
from coreth_tpu.state import flat as rflat
from coreth_tpu.types import Block as RBlock

from coreth_tpu_torch.rawdb import MemDB
from coreth_tpu_torch.replay import ReplayError
from coreth_tpu_torch.state import StateDB, StateStore
from coreth_tpu_torch.state import flat as tflat
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH, EMPTY_ROOT_HASH

import test_shard_replay as SR
from test_torch_trie_backend import _engine

A1 = b"\x11" * 20
A2 = b"\x22" * 20
H7 = b"\x77" * 32
H3 = b"\x03" * 32

PACKAGES = {"ref": rflat, "port": tflat}


def _acct(bal, nonce=0):
    return (bal, nonce, EMPTY_ROOT_HASH, EMPTY_CODE_HASH, False)


class _Hdr:
    """Minimal header stand-in for store-level tests."""

    def __init__(self, number):
        self.number = number

    def encode(self):
        return b"hdr%d" % self.number


def _gen(fs, number, **kw):
    return fs.apply_generation(
        number=number, block_hash=bytes([number]) * 32,
        root=bytes([0x0a + number]) * 32, header=_Hdr(number), **kw)


def _obs(pkg, v):
    """A read's result with the package's DELETED marker as a name."""
    return "DELETED" if v is pkg.DELETED else v


def _both(scenario):
    """``scenario(pkg)`` on the reference and the port; their
    observations must be equal."""
    got = {name: scenario(pkg) for name, pkg in PACKAGES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# ------------------------------------------------------------------ store

def test_store_reads_fills_and_generations():
    def scenario(pkg):
        fs = pkg.FlatStore()
        seen = [fs.account(A1)]
        fs.fill_account(A1, _acct(100))
        fs.fill_account(A1, _acct(999))          # fills never clobber
        fs.fill_storage(A1, H7, 42)
        seen += [fs.account(A1), fs.storage_value(A1, H7),
                 fs.storage_value(A1, b"\x01" * 32)]
        gen = _gen(fs, 1, prev_root=b"\x0b" * 32,
                   accounts={A1: _acct(50, 1), A2: pkg.DELETED},
                   storage={(A1, H7): 7, (A2, b"\x02" * 32): 9})
        seen += [fs.account(A1), _obs(pkg, fs.account(A2)),
                 fs.storage_value(A1, H7),
                 fs.storage_value(A2, b"\x02" * 32), gen.kind,
                 fs.snapshot()]
        fs.rollback_last()
        seen += [fs.account(A1), fs.account(A2), fs.storage_value(A1, H7),
                 fs.storage_value(A2, b"\x02" * 32), fs.snapshot()]
        return seen

    seen = _both(scenario)
    assert seen[1:4] == [_acct(100), 42, None]
    assert seen[4:9] == [_acct(50, 1), "DELETED", 7, 9, "window"]
    assert seen[9]["generations"] == 1
    assert seen[10:14] == [_acct(100), None, 42, None]
    assert seen[14]["rollbacks"] == 1


def test_store_destruct_masks_and_rollback_restores():
    def scenario(pkg):
        fs = pkg.FlatStore()
        fs.fill_storage(A1, H7, 5)
        fs.fill_storage(A1, H3, 6)
        _gen(fs, 1, prev_root=b"\x0b" * 32, accounts={A1: _acct(1, 1)},
             storage={(A1, H7): 8}, destructs=[A1], kind="quarantine",
             hold=True)
        seen = [fs.storage_value(A1, H7), fs.storage_value(A1, H3)]
        fs.rollback_last()
        return seen + [fs.storage_value(A1, H7), fs.storage_value(A1, H3)]

    assert _both(scenario) == [8, None, 5, 6]


def _persisted(pkg, gens, trusted):
    """Write ``gens`` (kwargs of apply_generation) through a store into
    a fresh MemDB of the package, then load it at each trusted number:
    (the records, {trusted: (count, reads)})."""
    fs = pkg.FlatStore()
    kv = (RMemDB if pkg is rflat else MemDB)()
    for number, kw in gens:
        fs.write_gen_entries(kv, _gen(fs, number, **kw))
    loads = {}
    for t in trusted:
        warm = pkg.FlatStore()
        n = warm.load(kv, trusted_number=t)
        loads[t] = (n, [_obs(pkg, warm.account(A1)),
                        _obs(pkg, warm.account(A2)),
                        warm.storage_value(A1, H7),
                        warm.storage_value(A1, H3),
                        warm.storage_value(A2, H7)])
    return dict(kv.items()), loads


def _cross_load(records, trusted):
    """The port's FlatStore loading the records the reference wrote."""
    kv = MemDB()
    for k, v in records.items():
        kv.put(k, v)
    fs = tflat.FlatStore()
    n = fs.load(kv, trusted_number=trusted)
    return n, [_obs(tflat, fs.account(A1)), _obs(tflat, fs.account(A2)),
               fs.storage_value(A1, H7), fs.storage_value(A1, H3),
               fs.storage_value(A2, H7)]


def test_store_persistence_trust_filter():
    """Entries persist number-stamped, byte for byte as the reference
    writes them; a reload trusts only entries at or below the
    checkpoint record's block."""
    gens = [(3, dict(accounts={A1: _acct(10, 1)}, storage={(A1, H7): 70})),
            (6, dict(accounts={A2: _acct(20, 2), A1: "DELETED"},
                     storage={(A2, H7): 99}))]

    def run(pkg):
        return _persisted(pkg, [
            (n, dict(kw, accounts={a: pkg.DELETED if v == "DELETED" else v
                                   for a, v in kw["accounts"].items()}))
            for n, kw in gens], (3, 6))

    ref, port = run(rflat), run(tflat)
    assert port == ref
    records, loads = port
    assert loads[3] == (0, [None, None, None, None, None])
    assert loads[6][1] == ["DELETED", _acct(20, 2), None, None, 99]
    assert _cross_load(records, 6) == loads[6]


def test_store_persistence_destruct_barrier():
    """A destruct and re-create must not resurrect stale persisted slot
    entries on reload: the barrier kills the entries stamped below it,
    and one past the trusted number poisons the account's persisted
    storage."""
    gens = [(3, dict(accounts={A1: _acct(10, 1)},
                     storage={(A1, H7): 70, (A1, H3): 30})),
            (6, dict(accounts={A1: _acct(1, 1)}, storage={(A1, H7): 700},
                     destructs=[A1]))]
    ref, port = (_persisted(pkg, gens, (3, 6)) for pkg in (rflat, tflat))
    assert port == ref
    records, loads = port
    assert loads[6][1][:4] == [_acct(1, 1), None, 700, None]
    assert loads[3][1][2:4] == [None, None]
    assert _cross_load(records, 6) == loads[6]


def test_store_checkpoint_marker_and_hold_release():
    def scenario(pkg):
        fs = pkg.FlatStore()
        _gen(fs, 1, accounts={A1: _acct(1)}, storage={})
        mk = fs.mark_checkpoint()
        seen = [mk.kind, mk.checkpoint, mk.number, mk.root]
        q = _gen(fs, 2, accounts={A1: _acct(2)}, storage={},
                 kind="quarantine", hold=True)
        fs.attach_exporter()
        got = fs.next_for_export(0.01)
        seen.append(got.number)
        fs.mark_exported(got)
        fs.mark_exported(mk)
        seen += [fs.next_for_export(0.01), fs.drained()]
        _gen(fs, 3, accounts={A1: _acct(3)}, storage={})
        seen += [q.hold, fs.next_for_export(0.01) is q]
        return seen

    assert _both(scenario) == ["checkpoint", True, 1, b"\x0b" * 32, 1,
                               None, True, False, True]


def test_diff_from_statedb_shapes():
    """flat_diff_from_statedb in raw key space: mutated accounts, written
    slots, the destruct set."""
    def run(sdb, pkg):
        sdb.add_balance(A1, 1000)
        sdb.set_state(A1, H7, (5).to_bytes(32, "big"))
        sdb.add_balance(A2, 1)
        sdb.suicide(A2)
        sdb.intermediate_root(True)
        accounts, storage, destructs = pkg.flat_diff_from_statedb(sdb)
        return ({a: _obs(pkg, v) for a, v in accounts.items()}, storage,
                destructs)

    ref = run(RStateDB(EMPTY_ROOT_HASH, RDatabase()), rflat)
    port = run(StateDB(StateStore()), tflat)
    assert port == ref
    accounts, storage, destructs = port
    assert accounts[A1][0] == 1000 and accounts[A2] == "DELETED"
    assert storage[(A1, bytes([H7[0] & 0xFE]) + H7[1:])] == 5
    assert destructs == [A2]


# -------------------------------------------------------------- read path

@pytest.fixture(scope="module")
def chains():
    return {"transfer": SR._build_chain(4, SR._gen_transfer),
            "erc20": SR._build_chain(4, SR._gen_erc20),
            "swap": SR._build_chain(3, SR._gen_swap)}


def _fresh(blocks, cls=Block):
    return [cls.decode(b.encode()) for b in blocks]


def _ref_engine(monkeypatch, backend="native", flat="1", check=False):
    monkeypatch.setenv("CORETH_TRIE", backend)
    monkeypatch.setenv("CORETH_FLAT", flat)
    if check:
        monkeypatch.setenv("CORETH_FLAT_CHECK", "1")
    else:
        monkeypatch.delenv("CORETH_FLAT_CHECK", raising=False)
    db = RDatabase()
    g = SR.Genesis(config=SR.CFG, gas_limit=8_000_000,
                   alloc=SR._alloc()).to_block(db)
    return SR.ReplayEngine(SR.CFG, db, g.root, parent_header=g.header,
                           capacity=256, batch_pad=64, window=4)


@pytest.mark.parametrize("backend", ["native", "py"])
@pytest.mark.parametrize("workload", ["transfer", "erc20", "swap"])
def test_flat_oracle_armed_replay(monkeypatch, chains, workload, backend):
    """``flat_check=True`` re-derives every flat hit from the tries over a
    whole replay; the roots are the headers' and the generation count
    the reference's under ``CORETH_FLAT_CHECK=1``."""
    blocks = chains[workload]
    ref = _ref_engine(monkeypatch, backend, check=True)
    assert ref.replay(_fresh(blocks, RBlock)) == blocks[-1].header.root
    port, _store = _engine(trie=backend, flat_check=True)
    assert port._flat_check and port.flat is not None
    assert port.replay(_fresh(blocks)) == blocks[-1].header.root
    snap = port.flat.snapshot()
    assert snap["generations"] == ref.flat.snapshot()["generations"] > 0
    assert snap["fills"] > 0
    assert port.supervisor.strikes == 0


def test_flat_oracle_catches_divergence(monkeypatch, chains):
    """A poisoned flat entry is caught, not served, in both packages: by
    the engine's oracle (ReplayError) and by StateDB's (ValueError)."""
    blocks = chains["transfer"]
    victim = b"\x9a" * 20              # never touched by the chain
    ref = _ref_engine(monkeypatch, check=True)
    ref.replay(_fresh(blocks, RBlock))
    port, store = _engine(flat_check=True)
    port.replay(_fresh(blocks))
    for eng, err in ((ref, RReplayError), (port, ReplayError)):
        eng.flat.fill_account(victim, _acct(123456))
        with pytest.raises(err, match="flat oracle"):
            eng._account(victim)
        eng.flat.accounts.pop(victim)
        eng.flat.fill_account(victim, _acct(777))
    sdb = RStateDB(ref.commit(), ref.db, flat=ref._flat_view())
    with pytest.raises(ValueError, match="flat oracle"):
        sdb.get_balance(victim)
    sdb = StateDB(store, flat=port._flat_view())
    with pytest.raises(ValueError, match="flat oracle"):
        sdb.get_balance(victim)
    # a poisoned slot, through the machine path's reads and StateDB's
    slot = (SR.TOKEN, b"\x00" * 31 + b"\x05")
    port.flat.fill_storage(*slot, 99)
    with pytest.raises(ReplayError, match="flat oracle"):
        port.committed_value(*slot)
    sdb = StateDB(store, flat=port._flat_view())
    with pytest.raises(ValueError, match="flat oracle"):
        sdb.get_state(*slot)


@pytest.mark.parametrize("flat", [False, True])
def test_flat_ab_equivalence(monkeypatch, chains, flat):
    """``flat=False`` (the reference's ``CORETH_FLAT=0``) walks the tries
    only, with the same roots."""
    blocks = chains["erc20"]
    ref = _ref_engine(monkeypatch, flat="1" if flat else "0")
    assert ref.replay(_fresh(blocks, RBlock)) == blocks[-1].header.root
    port, _store = _engine(flat=flat)
    assert port.replay(_fresh(blocks)) == blocks[-1].header.root
    assert (port.flat is None) == (ref.flat is None) == (not flat)
    if flat:
        assert port.flat.snapshot()["generations"] \
            == ref.flat.snapshot()["generations"]


# --------------------------------------------------------------- rollback

def _corrupt_drop_tx(block, cls):
    """A poison block whose COMPUTED state diverges: the body lost its
    last tx while the header still claims it."""
    bad = cls.decode(block.encode())
    bad.transactions.pop()
    return bad


@pytest.mark.parametrize("backend", ["native", "py"])
def test_quarantine_then_rollback_engine(monkeypatch, backend):
    """Quarantine a diverging block, roll it back through the flat
    layer's undo, and re-converge to the strict-mode root: the same
    reasons, roots and counts as the reference at every step."""
    blocks = SR._build_chain(6, SR._gen_mixed)
    ref = _ref_engine(monkeypatch, backend)
    port, store = _engine(trie=backend)
    for eng, cls in ((ref, RBlock), (port, Block)):
        eng.replay(_fresh(blocks[:3], cls))
    assert port.root == ref.root == blocks[2].header.root
    pre_root = port.root
    reasons = ref.quarantine_block(_corrupt_drop_tx(blocks[3], RBlock))
    bad = _corrupt_drop_tx(blocks[3], Block)
    assert port.quarantine_block(bad) == reasons and reasons
    assert port.root == ref.root != blocks[3].header.root
    assert port.flat.last_generation().kind == "quarantine"
    assert ref.rollback_block(
        _corrupt_drop_tx(blocks[3], RBlock)) == pre_root
    assert port.rollback_block(bad) == pre_root
    assert port.root == store.trie.hash() == pre_root
    assert port.stats.blocks_rolled_back \
        == ref.stats.blocks_rolled_back == 1
    assert port.flat.snapshot()["rollbacks"] == 1
    for eng, cls in ((ref, RBlock), (port, Block)):
        assert eng.replay(_fresh(blocks[3:], cls)) == blocks[-1].header.root
    assert port.flat.snapshot()["generations"] \
        == ref.flat.snapshot()["generations"]


def test_rollback_refuses_non_quarantine_tip(monkeypatch, chains):
    blocks = chains["transfer"]
    ref = _ref_engine(monkeypatch)
    ref.replay(_fresh(blocks, RBlock))
    with pytest.raises(RReplayError, match="rollback target"):
        ref.rollback_block(blocks[-1])
    port, _store = _engine()
    port.replay(_fresh(blocks))
    with pytest.raises(ReplayError, match="rollback target"):
        port.rollback_block(_fresh(blocks)[-1])
    off, _store = _engine(flat=False)
    with pytest.raises(ReplayError, match="flat layer"):
        off.rollback_block(_fresh(blocks)[-1])
