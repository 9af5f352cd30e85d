"""The port's replay engine on its exact host path, against the JAX
reference's, on the CPU.

Each case replays the same blocks (built by the reference's builder)
through both engines: the reference at its defaults (the host path,
the window rewind, and the serial short-circuit with
``CORETH_SERIAL_SHORTCIRCUIT=1``), the port with ``device="cpu"`` (the
kernels' plain versions) and its defaults, ``serial_shortcircuit``
included.  Roots must equal the headers and each other, and the
host-path and machine counters must be equal.  Mirrors
tests/test_replay.py:110 (contract blocks), :340 (a would-revert token
transfer), :416 (the speculative window discarded on a rewind), :460
(a mid-window rewind, also on a 2-shard mesh) and tests/test_hostexec.py
:404/:440 (serial swap blocks, alone and between token blocks), plus an
Apricot Phase 1 token chain and a block whose header root is wrong (the
host path raises with the engine's root and the store at the prefix).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import pytest

from coreth_tpu.chain import Genesis as RGenesis
from coreth_tpu.chain import GenesisAccount as RAccount
from coreth_tpu.chain import generate_chain as r_generate_chain
from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.params import TEST_APRICOT_PHASE1_CONFIG as RAP1
from coreth_tpu.params import TEST_CHAIN_CONFIG as RCFG
from coreth_tpu.parallel import make_mesh as r_make_mesh
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.state import Database
from coreth_tpu.types import DynamicFeeTx as RDynamicFeeTx
from coreth_tpu.types import LegacyTx as RLegacyTx
from coreth_tpu.types import sign_tx as r_sign_tx
from coreth_tpu.workloads import erc20 as rerc20

from coreth_tpu_torch.chain import Genesis, GenesisAccount
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.params import TEST_APRICOT_PHASE1_CONFIG as AP1
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.parallel import make_mesh
from coreth_tpu_torch.replay import ReplayEngine, ReplayError
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.workloads import erc20 as terc20

from test_torch_host import host_chain
from test_torch_machine_replay import (
    ADDRS, KEYS, POOL, TOKEN, _chains,
)

GWEI = 10**9


@pytest.fixture
def defaults(monkeypatch):
    """Both packages at their defaults; learned premap recipes start
    and end empty."""
    for k in ("CORETH_SERIAL_SHORTCIRCUIT", "CORETH_NO_TOKEN_FASTPATH",
              "CORETH_DEVICE_OCC", "CORETH_SPECIALIZE", "CORETH_HOST_EXEC",
              "CORETH_MACHINE_WINDOW"):
        monkeypatch.delenv(k, raising=False)
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()
    yield monkeypatch
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()


def _both(rgen, pgen, rblocks, window=16, mesh=None, rmesh=None,
          rcfg=RCFG, cfg=CFG, **port_kw):
    """Both engines (capacity 256, batch_pad 64) replay the chain to the
    last header's root.  Returns (ref, port)."""
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(rcfg, db, rgb.root, parent_header=rgb.header,
                        capacity=256, batch_pad=64, window=window,
                        mesh=rmesh)
    want = rblocks[-1].header.root
    assert ref.replay(rblocks) == want
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(cfg, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, window=window, device="cpu", mesh=mesh,
                        **port_kw)
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == want
    assert store.trie.hash() == want
    port.close()
    assert (port.stats.blocks_device, port.stats.blocks_fallback,
            port.stats.txs) == (ref.stats.blocks_device,
                                ref.stats.blocks_fallback, ref.stats.txs)
    return ref, port


def test_contract_blocks_take_the_host_path(defaults):
    """CREATE, CREATE2 + SELFDESTRUCT (and the resurrection), a revert
    and precompile calls run on the host path; the transfer block after
    them runs on the device (tests/test_replay.py:110)."""
    rgen, pgen, rblocks, _ = host_chain()
    ref, port = _both(rgen, pgen, rblocks)
    assert port.stats.blocks_fallback == 3
    assert port.stats.blocks_device == 1
    assert port.stats.t_fallback > 0


# ------------------------------------------------------ transfer rewinds
def _rewind_chain(n_blocks, spender_block, spender_keys, fresh=None):
    """Transfers from KEYS[0]; in ``spender_block`` KEYS[0] pays a
    poorly funded key a large amount and that key spends more than its
    pre-block balance in the same block: valid in order, rejected by the
    device's solvency check, which ignores same-block credits
    (tests/test_replay.py:416, :460).  ``fresh`` = (block, count): from
    that block on, each block pays the same ``count`` new accounts
    instead."""
    poor = spender_keys
    big = 3 * 10**23

    def alloc(acct):
        a = {addr: acct(balance=10**24) for addr in ADDRS}
        for k in poor:
            a[ADDRS[k]] = acct(balance=10**17)
        return a

    rgen = RGenesis(config=RCFG, gas_limit=8_000_000, alloc=alloc(RAccount))
    db = Database()
    rgb = rgen.to_block(db)
    nonces = [0] * len(KEYS)

    def tx(bg, k, to, value):
        bg.add_tx(r_sign_tx(RDynamicFeeTx(
            chain_id_=RCFG.chain_id, nonce=nonces[k], gas_tip_cap_=GWEI,
            gas_fee_cap_=300 * GWEI, gas=21_000, to=to, value=value),
            KEYS[k], RCFG.chain_id))
        nonces[k] += 1

    def gen(i, bg):
        if i == spender_block:
            for k in poor:
                tx(bg, 0, ADDRS[k], big)
                tx(bg, k, ADDRS[7], big // 2)
        elif fresh is not None and i >= fresh[0]:
            for j in range(fresh[1]):
                tx(bg, 3 + j % 3, b"\xa1" + j.to_bytes(2, "big") * 9
                   + b"\xa1", 1 + j)
        else:
            # the block after the rejected one has a funded sender seen
            # nowhere before: its row first reaches the tables when that
            # block's window is issued, speculatively
            tx(bg, 0, bytes([0x42 + i]) * 20, 777)
            tx(bg, 5 if i == spender_block + 1 else 6,
               bytes([0x52 + i]) * 20, 778)

    rblocks, _ = r_generate_chain(RCFG, rgb, db, n_blocks, gen, gap=2)
    pgen = Genesis(config=CFG, gas_limit=8_000_000,
                   alloc=alloc(GenesisAccount))
    assert pgen.to_block(StateStore()).hash() == rgb.hash()
    return rgen, pgen, rblocks


def test_speculative_window_is_discarded(defaults):
    """window=1: block 1 rewinds while block 2's window, launched on the
    stale tables, is in flight; it is discarded and replayed
    (tests/test_replay.py:416).  Block 2's sender was first staged by
    that window's issue: the discard re-stages it, or block 2 would read
    a zero balance and take the host path too."""
    rgen, pgen, rblocks = _rewind_chain(3, 1, [1])
    ref, port = _both(rgen, pgen, rblocks, window=1)
    assert port.stats.blocks_fallback == 1
    assert port.stats.blocks_device == 2


@pytest.mark.parametrize("n", [None, 2])
def test_mid_window_rewind(defaults, n):
    """One window of five blocks, the fourth rejected by the device: the
    prefix re-applies on K1 (K8 on the mesh), the block runs on the host
    path, the tail resumes (tests/test_replay.py:460)."""
    rgen, pgen, rblocks = _rewind_chain(5, 3, [1, 2])
    launches = []
    issue = ReplayEngine._issue_window_run

    def spy(self, items, fetch=True):
        launches.append((len(items), fetch))
        return issue(self, items, fetch)

    defaults.setattr(ReplayEngine, "_issue_window_run", spy)
    ref, port = _both(rgen, pgen, rblocks,
                      mesh=make_mesh(n) if n else None,
                      rmesh=r_make_mesh(jax.devices("cpu")[:n]) if n
                      else None)
    assert port.stats.blocks_fallback == 1
    assert port.stats.blocks_device == 4
    # the window, the state-only re-apply of its 3-block prefix, the tail
    assert launches == [(5, True), (3, False), (1, True)]


@pytest.mark.parametrize("n", [None, 2])
def test_rewind_after_table_growth_rebuilds_rows(defaults, n):
    """window=1: while block 1's window is in flight, block 2's
    classification indexes 40 new accounts and the tables (capacity 32)
    grow; block 1 then rewinds, and the failed window's tables have a
    stale shape (on the mesh stale arena rows too), so every row is
    rebuilt from the host state before the host path runs (block 3 pays
    the new accounts again, so a table missing their rows shows).  The
    port
    alone: its roots are held to the headers the reference's builder
    made (the reference has no test of this path)."""
    _rgen, pgen, rblocks = _rewind_chain(4, 1, [1], fresh=(2, 40))
    rebuilds = []
    rebuild = ReplayEngine._rebuild_device_rows

    def spy(self):
        rebuilds.append(self.state.capacity)
        return rebuild(self)

    defaults.setattr(ReplayEngine, "_rebuild_device_rows", spy)
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=32,
                        batch_pad=64, window=1, device="cpu",
                        mesh=make_mesh(n) if n else None)
    want = rblocks[-1].header.root
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == want
    port.close()
    assert store.trie.hash() == want
    assert rebuilds == [64]
    assert (port.stats.blocks_fallback, port.stats.blocks_device) == (1, 3)


def test_wrong_header_root_raises_at_the_prefix(defaults):
    """A host-path block whose header root is wrong raises with .block
    set; the engine's root and the store's account trie stay at the
    previous block (the host path restores what it wrote)."""
    rgen, pgen, rblocks, _ = host_chain()
    blocks = [Block.decode(b.encode()) for b in rblocks]
    bad = blocks[1]
    bad.header.root = b"\x13" * 32
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, device="cpu")
    with pytest.raises(ReplayError, match="state root mismatch") as exc:
        port.replay(blocks)
    port.close()
    assert exc.value.block is bad
    assert port.root == rblocks[0].header.root == store.trie.hash()
    assert port.stats.blocks_fallback == 1
    # the prefix state is whole: block 1 replays on it from a fresh engine
    port2 = ReplayEngine(CFG, store, parent_header=rblocks[0].header,
                         capacity=256, batch_pad=64, device="cpu")
    good = [Block.decode(b.encode()) for b in rblocks[1:]]
    assert port2.replay(good) == rblocks[-1].header.root
    port2.close()


# ------------------------------------------------ token and serial paths
def _token(i, k, to, amount, gas=100_000):
    return (k, TOKEN, "transfer", (to, amount), gas, 0)


def test_would_revert_token_transfer_rides_the_machine(defaults):
    """An overdrawn token transfer is not fast-path classifiable: it runs
    on the machine (status 0 on the device), the blocks around it on the
    token fast path (tests/test_replay.py:340)."""
    def txs(i):
        if i == 1:
            return [_token(i, 6, ADDRS[0], 10**30)]
        return [_token(i, 0, ADDRS[1], 1000)]

    rgen, pgen, rblocks = _chains(3, txs)
    ref, port = _both(rgen, pgen, rblocks)
    assert port.stats.blocks_fallback == 0
    assert port._machine.blocks == ref._machine.blocks == 1


def test_serial_swap_blocks_skip_the_device(defaults):
    """Swap blocks (one contract, constant keys) go straight to the
    native session: no OCC round, no window launch
    (tests/test_hostexec.py:404)."""
    def txs(i):
        return [(k, POOL, "swap", 1000 + 13 * i + k, 200_000, 0)
                for k in range(5)]

    rgen, pgen, rblocks = _chains(3, txs)
    ref, port = _both(rgen, pgen, rblocks)
    pm, rm = port._machine, ref._machine
    c = pm.counters()
    assert (pm.serial_blocks, pm.native_txs, pm.host_txs, pm.rounds) == \
        (rm.serial_blocks, rm.native_txs, rm.host_txs, rm.rounds) == \
        (3, 15, 0, 0)
    assert c["window_launches"] == c["launches"] == 0


def test_serial_and_token_blocks_interleave(defaults):
    """Swap blocks short-circuit, token blocks (keccak-keyed slots) stay
    on device OCC: the detector does not over-trigger
    (tests/test_hostexec.py:440, token fast path off on both sides)."""
    defaults.setenv("CORETH_NO_TOKEN_FASTPATH", "1")
    defaults.setenv("CORETH_SPECIALIZE", "0")

    def txs(i):
        if i % 2 == 0:
            return [(k, POOL, "swap", 500 + 11 * i + k, 200_000, 0)
                    for k in range(4)]
        return [_token(i, k, ADDRS[(k + 1) % 4], 10 + k) for k in range(4)]

    rgen, pgen, rblocks = _chains(4, txs)
    ref, port = _both(rgen, pgen, rblocks, token_fastpath=False,
                      specialize=False)
    pm, rm = port._machine, ref._machine
    assert (pm.serial_blocks, pm.blocks) == (rm.serial_blocks, rm.blocks) \
        == (2, 4)
    assert pm.counters()["window_launches"] > 0


def test_apricot_phase1_token_chain_matches_reference(defaults):
    """Before Apricot Phase 2 the machine takes no block: token
    transfers still ride the fast path (their exec gas measured on the
    host interpreter), while a block with a ``balanceOf`` call runs on
    the host path."""
    keys = [0x4100 + i for i in range(3)]
    from coreth_tpu.crypto.secp256k1 import priv_to_address
    addrs = [priv_to_address(k) for k in keys]

    def alloc(acct, erc20):
        a = {addr: acct(balance=10**24) for addr in addrs}
        a[TOKEN] = erc20.token_genesis_account({x: 10**18 for x in addrs})
        return a

    rgen = RGenesis(config=RAP1, gas_limit=8_000_000,
                    alloc=alloc(RAccount, rerc20))
    db = Database()
    rgb = rgen.to_block(db)
    nonces = [0] * len(keys)

    def gen(i, bg):
        for k in range(3):
            if i == 2:
                to, data, gas, value = bytes([0x30 + k]) * 20, b"", \
                    21_000, 5
            else:
                to, gas, value = TOKEN, 100_000, 0
                data = rerc20.transfer_calldata(addrs[(k + 1) % 3], 10 + k)
                if i == 1 and k == 2:
                    data = rerc20.BALANCEOF_SELECTOR + b"\x00" * 12 \
                        + addrs[0]
            bg.add_tx(r_sign_tx(RLegacyTx(
                nonce=nonces[k], gas_price=300 * GWEI, gas=gas, to=to,
                value=value, data=data), keys[k], RAP1.chain_id))
            nonces[k] += 1

    rblocks, _ = r_generate_chain(RAP1, rgb, db, 3, gen, gap=2)
    pgen = Genesis(config=AP1, gas_limit=8_000_000,
                   alloc=alloc(GenesisAccount, terc20))
    ref, port = _both(rgen, pgen, rblocks, rcfg=RAP1, cfg=AP1)
    assert port.stats.blocks_fallback == 1
    assert port.stats.blocks_device == 2
