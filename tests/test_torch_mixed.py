"""The Avalanche-semantics segment (BASELINE config 4) on the port's
replay engine, against the JAX reference's, on the CPU.

Mirrors tests/test_mixed_segment.py:152 (the replay) and :167 (the
multicoin state): both engines, each with a ``DummyEngine`` whose
callbacks are wired to an atomic backend over its own shared-memory hub
seeded alike, replay the reference-built 8-block segment (the port with
``device="cpu"``, the kernels' plain versions): atomic ExtData and
``nativeAssetCall`` blocks on the host path, transfer blocks on the
device path, the same roots and counters; the port builds the same
segment byte for byte (``torch_mixed_cases``).  Then: the port's
builder against the reference's on ``workloads/mixed.py``'s chain
(wire bytes equal block by block, and the port's replay of it), a
header with a wrong ``ext_data_gas_used`` and a block that re-spends
its parent's UTXO, which both engines refuse with the same pending
atomic effects left behind.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu import atomic as R
from coreth_tpu.chain import Genesis as RGenesis
from coreth_tpu.chain import GenesisAccount as RAccount
from coreth_tpu.chain import generate_chain as r_generate_chain
from coreth_tpu.consensus.engine import DummyEngine as RDummyEngine
from coreth_tpu.params import TEST_APRICOT_PHASE5_CONFIG as RCFG
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.state import Database
from coreth_tpu.workloads import mixed as rmixed

from coreth_tpu_torch import atomic as T
from coreth_tpu_torch.chain import Genesis, GenesisAccount
from coreth_tpu_torch.consensus.engine import ConsensusError
from coreth_tpu_torch.params import TEST_APRICOT_PHASE5_CONFIG as CFG
from coreth_tpu_torch.state import StateDB
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.workloads import mixed as tmixed

from tests import test_mixed_segment as seg
import torch_mixed_cases as M

MIXED_KEYS = [0x7000 + i for i in range(4)]


@pytest.fixture(scope="module")
def segment():
    """The reference-built 8-block segment: (its hub, blocks)."""
    memory, _genesis, _gblock, blocks = seg.build_mixed_segment(8)
    return memory, blocks


def _fresh(blocks):
    return [Block.decode(b.encode()) for b in blocks]


def test_mixed_segment_replay(segment):
    """Both engines replay the reference-built segment to its root, 4
    blocks on the host path and 4 on the device; the port's builder
    gives the same blocks byte for byte from a hub seeded alike."""
    r_memory, blocks = segment
    _genesis, port_blocks = M.build_segment()
    assert [b.encode() for b in port_blocks] == [b.encode() for b in blocks]
    assert blocks[0].ext_data() != b"" and blocks[4].ext_data() != b""
    ref = seg.replay_engine_for(RGenesis(
        config=RCFG, gas_limit=8_000_000,
        alloc={a: RAccount(balance=10**21) for a in seg.ADDRS}), r_memory)
    want = blocks[-1].root
    assert ref.replay(blocks) == want
    eng, store, backend = M.replay_engine("cpu")
    assert backend.shared_memory.memory._spaces == r_memory._spaces
    assert eng.replay(_fresh(blocks)) == want
    eng.close()
    assert store.trie.hash() == want
    assert (eng.stats.blocks_fallback, eng.stats.blocks_device) == (4, 4)
    assert (ref.stats.blocks_fallback, ref.stats.blocks_device) == (4, 4)
    assert eng.stats.txs == ref.stats.txs
    # each atomic block is pending: verified, not yet accepted
    assert sorted(backend._pending) == sorted(
        b.hash() for b in blocks if b.ext_data())


def test_mixed_segment_multicoin_state(segment):
    _r_memory, blocks = segment
    eng, store, _backend = M.replay_engine("cpu")
    eng.replay(_fresh(blocks))
    eng.close()
    assert eng.commit() == blocks[-1].root
    statedb = StateDB(store)
    assert statedb.get_balance_multi_coin(M.ASSET_RECIPIENT, M.ASSET) \
        == (1000 + 1) + (1000 + 5)
    assert statedb.get_balance_multi_coin(M.ADDRS[0], M.ASSET) \
        == 777_000 - 1001


def test_port_builder_matches_reference_builder():
    """``workloads/mixed.py`` at 16 blocks x 4 txs: the port's builder
    (its ``engine=`` path) gives the reference's blocks byte for byte,
    and the port replays them: 2 import and 1 nativeAssetCall blocks on
    the host path, the import blocks pending in the backend."""
    genesis, blocks = tmixed.build_mixed_chain(CFG, 16, 4, MIXED_KEYS)
    _rg, r_blocks = rmixed.build_mixed_chain(RCFG, 16, 4, MIXED_KEYS)
    assert [b.encode() for b in blocks] == [b.encode() for b in r_blocks]
    assert [i for i, b in enumerate(blocks) if b.ext_data()] == [0, 8]
    eng, _gb, backend = tmixed.replay_engine(genesis, 16, MIXED_KEYS[0],
                                             device="cpu", window=4,
                                             capacity=256, batch_pad=64)
    assert eng.replay(_fresh(r_blocks)) == blocks[-1].root
    eng.close()
    assert (eng.stats.blocks_fallback, eng.stats.blocks_device) == (3, 13)
    assert sorted(backend._pending) == sorted(
        blocks[i].hash() for i in (0, 8))


def _ref_engine(memory, genesis, window=4):
    """The reference's engine with callbacks over ``memory``: (engine,
    backend)."""
    db = Database()
    gblock = genesis.to_block(db)
    backend = R.AtomicBackend(rmixed.CTX,
                              memory.new_shared_memory(rmixed.CTX.chain_id))
    cb = R.make_callbacks(backend, RCFG, pending_atomic_txs=lambda: [])
    return RReplayEngine(RCFG, db, gblock.root, parent_header=gblock.header,
                         engine=RDummyEngine(cb=cb), window=window,
                         capacity=256, batch_pad=64), backend


def _port_mixed_engine(r_genesis):
    """The port's engine (``workloads/mixed.py replay_engine``) for the
    genesis of a reference-built chain: (engine, backend)."""
    genesis = Genesis(config=CFG, gas_limit=8_000_000, alloc={
        a: GenesisAccount(balance=v.balance)
        for a, v in r_genesis.alloc.items()})
    eng, _gb, backend = tmixed.replay_engine(
        genesis, 16, MIXED_KEYS[0], device="cpu", window=4, capacity=256,
        batch_pad=64)
    return eng, backend


def test_wrong_ext_data_gas_used_refused_by_both():
    """Block 8 (the second import) with its header's ext_data_gas_used
    off by one: both engines replay blocks 0-7 and refuse block 8 in
    Finalize."""
    r_genesis, blocks = rmixed.build_mixed_chain(RCFG, 9, 4, MIXED_KEYS)
    bad = Block.decode(blocks[8].encode())
    bad.header.ext_data_gas_used += 1
    r_memory, _ = rmixed.seed_memory(16, MIXED_KEYS[0])
    ref, r_backend = _ref_engine(r_memory, r_genesis)
    ref.replay(blocks[:8])
    with pytest.raises(Exception, match="invalid extDataGasUsed"):
        ref.replay([bad])
    port, backend = _port_mixed_engine(r_genesis)
    assert port.replay(_fresh(blocks[:8])) == blocks[7].root
    with pytest.raises(ConsensusError, match="invalid extDataGasUsed"):
        port.replay([bad])
    port.close()
    assert port.root == blocks[7].root == port.trie.hash()
    # the refused block's atomic effect stays pending in both, as its
    # callback ran before the check
    assert sorted(backend._pending) == sorted(r_backend._pending) == \
        sorted([blocks[0].hash(), bad.hash()])


def test_respent_utxo_refused_by_both():
    """Block 1 imports block 0's UTXOs again (a new tx id).  The builder
    is made to forget block 0's pending effect, so block 1 is otherwise
    valid; replaying, both backends hold block 0 as a processing
    ancestor (the walk follows pending parents only, so the re-spend
    sits in its child), and both engines refuse block 1 with
    "processing ancestor", the port's root and store at block 0."""
    keys = MIXED_KEYS
    genesis, _ = rmixed.build_mixed_chain(RCFG, 0, 4, keys)
    memory, utxos = rmixed.seed_memory(16, keys[0])
    backend = R.AtomicBackend(rmixed.CTX,
                              memory.new_shared_memory(rmixed.CTX.chain_id))
    pending = []
    engine = RDummyEngine(cb=R.make_callbacks(
        backend, RCFG, pending_atomic_txs=lambda: pending))
    db = Database()
    gblock = genesis.to_block(db)
    _bi, avax_u, asset_u = utxos[0]

    def gen(i, bg):
        tx = rmixed._import_tx(avax_u, asset_u, M.ADDRS[0], keys[0])
        if i == 1:
            for h in list(backend._pending):
                backend.reject(h)
            tx.unsigned.outs[0].amount -= 1
            tx.sign([[keys[0]], [keys[0]]])
        pending[:] = [tx]

    blocks, _ = r_generate_chain(RCFG, gblock, db, 2, gen, gap=10,
                                 engine=engine)
    assert blocks[0].ext_data() != blocks[1].ext_data() != b""
    r_memory, _ = rmixed.seed_memory(16, keys[0])
    ref, r_backend = _ref_engine(r_memory, genesis)
    with pytest.raises(Exception, match="processing ancestor"):
        ref.replay(blocks)
    port, backend = _port_mixed_engine(genesis)
    with pytest.raises(T.tx.AtomicTxError, match="processing ancestor"):
        port.replay(_fresh(blocks))
    port.close()
    assert port.root == blocks[0].root == port.trie.hash()
    assert sorted(backend._pending) == sorted(r_backend._pending) == \
        [blocks[0].hash()]
