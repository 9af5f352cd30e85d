"""The port's ERC-20 token fast path on the CPU, against the JAX reference
at its default configuration (``CORETH_NO_TOKEN_FASTPATH`` unset).

Chains of token ``transfer()`` calls (and value transfers beside them)
come from the reference's chain builder; both engines replay the same
blocks, the port with ``device="cpu"`` (the window kernel's plain
version, slot half included).  The roots of every window fold must agree
with each other and with the headers, and the token slots the two
engines indexed must hold the same keys and values.  The exec-gas
variants the port measures on its native session must equal the
reference's interpreter measurements at every fork the session runs.
A last case alternates token fast-path blocks with machine windows on
the same contract.  Mirrors tests/test_replay.py:261-380.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu.chain import Genesis as RGenesis
from coreth_tpu.chain import GenesisAccount as RAccount
from coreth_tpu.chain import generate_chain as r_generate_chain
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.params import TEST_CHAIN_CONFIG as RCFG
from coreth_tpu.params import config as rconfig
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.state import Database
from coreth_tpu.types import Block as RBlock
from coreth_tpu.types import DynamicFeeTx as RDynamicFeeTx
from coreth_tpu.types import sign_tx as r_sign_tx
from coreth_tpu.workloads import erc20 as rerc20

from coreth_tpu_torch.chain import Genesis, GenesisAccount
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.params import config as tconfig
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.workloads import erc20 as terc20

from test_torch_occ_replay import _record_flushes

GWEI = 10**9
KEYS = [0x1000 + i for i in range(8)]
ADDRS = [priv_to_address(k) for k in KEYS]
TOKEN = bytes([0x77]) * 20


@pytest.fixture
def reference_default(monkeypatch):
    """The reference at its defaults: the token fast path on, the
    machine path on fused windows with K7 (the port's defaults too)."""
    for k in ("CORETH_NO_TOKEN_FASTPATH", "CORETH_DEVICE_OCC",
              "CORETH_SPECIALIZE", "CORETH_SERIAL_SHORTCIRCUIT",
              "CORETH_MACHINE_WINDOW"):
        monkeypatch.delenv(k, raising=False)
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()
    return monkeypatch


def token_txs(i, txs_per_block, nonces):
    """tests/test_replay.py build_token_chain's default block: every
    third recipient the next key (an SSTORE reset), the rest fresh
    holders (an SSTORE set).  Tuples (key, to, value, gas, calldata)."""
    out = []
    for j in range(txs_per_block):
        k = (i * txs_per_block + j) % len(KEYS)
        to = ADDRS[(k + 1) % len(KEYS)] if j % 3 == 0 \
            else bytes([0x50 + (j % 40)]) * 20
        out.append((k, TOKEN, 0, 100_000,
                    rerc20.transfer_calldata(to, 10 + j)))
    return out


def token_chains(n_blocks, txs_of):
    """The reference's chain over tests/test_replay.py's token genesis
    (8 funded keys holding 10**18 tokens each), ``txs_of(i, nonces)``
    giving block i's txs; the port's genesis must be the same block.
    Returns (reference genesis, port genesis, reference blocks)."""
    def alloc(acct, erc20):
        a = {addr: acct(balance=10**24) for addr in ADDRS}
        a[TOKEN] = erc20.token_genesis_account({addr: 10**18
                                                for addr in ADDRS})
        return a
    rgen = RGenesis(config=RCFG, gas_limit=8_000_000,
                    alloc=alloc(RAccount, rerc20))
    db = Database()
    rgb = rgen.to_block(db)
    nonces = [0] * len(KEYS)

    def gen(i, bg):
        for k, to, value, gas, data in txs_of(i, nonces):
            bg.add_tx(r_sign_tx(RDynamicFeeTx(
                chain_id_=RCFG.chain_id, nonce=nonces[k], gas_tip_cap_=GWEI,
                gas_fee_cap_=300 * GWEI, gas=gas, to=to, value=value,
                data=data), KEYS[k], RCFG.chain_id))
            nonces[k] += 1
    rblocks, _ = r_generate_chain(RCFG, rgb, db, n_blocks, gen, gap=2)
    pgen = Genesis(config=CFG, gas_limit=8_000_000,
                   alloc=alloc(GenesisAccount, terc20))
    assert pgen.to_block(StateStore()).hash() == rgb.hash()
    return rgen, pgen, rblocks


def replay_both(rgen, pgen, rblocks, mesh=None, rmesh=None, window=16,
                **port_kw):
    """Both engines (capacity 256, batch_pad 64) replay the chain; every
    fold's root must agree and equal the headers.  Returns (ref, port)."""
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header,
                        capacity=256, batch_pad=64, window=window,
                        mesh=rmesh)
    ref_roots = _record_flushes(ref.commit_pipe)
    want = rblocks[-1].header.root
    assert ref.replay([RBlock.decode(b.encode()) for b in rblocks]) == want
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, window=window, device="cpu", mesh=mesh,
                        **port_kw)
    port_roots = _record_flushes(port.commit_pipe)
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == want
    port.close()
    assert port_roots == ref_roots and port_roots
    assert ref.stats.blocks_fallback == 0
    assert port.stats.blocks_device == ref.stats.blocks_device
    return ref, port


def assert_slots_equal(ref, port):
    """The token slots both engines indexed: the same keys in the same
    order, the same mirror values."""
    assert port.state.slot_keys == ref.state.slot_keys
    assert port.state.slot_host == ref.state.slot_host


def test_replay_token_transfers_on_device(reference_default):
    """tests/test_replay.py:261: four blocks of 16 token calls replay on
    the window path, the machine never runs, and the folded storage
    holds the mirror's values."""
    rgen, pgen, rblocks = token_chains(
        4, lambda i, nonces: token_txs(i, 16, nonces))
    ref, port = replay_both(rgen, pgen, rblocks)
    assert port.stats.blocks_device == 4 and port._machine is None
    assert_slots_equal(ref, port)
    assert len(port.state.slot_keys) > 8
    for sid, (contract, key) in enumerate(port.state.slot_keys[1:], 1):
        assert port.storage_value(contract, key) == port.state.slot_host[sid]
    assert port.storage_epoch == 4


def test_replay_token_zero_amount_noop_variant(reference_default):
    """tests/test_replay.py:284: zero-amount transfers (the noop gas
    variant) between nonzero ones."""
    def txs(i, nonces):
        return [(0, TOKEN, 0, 100_000, rerc20.transfer_calldata(
            ADDRS[1], 0 if j % 2 else 7)) for j in range(6)]
    rgen, pgen, rblocks = token_chains(2, txs)
    ref, port = replay_both(rgen, pgen, rblocks)
    assert port.stats.blocks_device == 2 and port._machine is None
    assert_slots_equal(ref, port)


def test_replay_mixed_native_and_token_block(reference_default):
    """tests/test_replay.py:306: value transfers and token calls in one
    block, one window step."""
    def txs(i, nonces):
        out = []
        for j in range(8):
            if j % 2 == 0:
                out.append((j % 4, bytes([0x60 + j]) * 20, 123, 21_000, b""))
            else:
                out.append((j % 4, TOKEN, 0, 100_000, rerc20.transfer_calldata(
                    bytes([0x61 + j]) * 20, 5)))
        return out
    rgen, pgen, rblocks = token_chains(2, txs)
    ref, port = replay_both(rgen, pgen, rblocks)
    assert port.stats.blocks_device == 2 and port._machine is None
    assert_slots_equal(ref, port)


def test_replay_token_insufficient_goes_to_the_machine_then_resumes(
        reference_default):
    """tests/test_replay.py:340: an overdraw would revert, so its block
    is not the fast path's; the machine path replays it (a status-0
    receipt) and the next token block classifies on the refreshed
    slots."""
    def txs(i, nonces):
        if i == 1:
            return [(6, TOKEN, 0, 100_000,
                     rerc20.transfer_calldata(ADDRS[0], 10**30))]
        return [(0, TOKEN, 0, 100_000,
                 rerc20.transfer_calldata(ADDRS[1], 1000))]
    rgen, pgen, rblocks = token_chains(3, txs)
    ref, port = replay_both(rgen, pgen, rblocks)
    assert port.stats.blocks_device == 3
    assert port._machine.blocks == ref._machine.blocks == 1
    assert_slots_equal(ref, port)


def test_self_transfer_block_goes_to_the_machine(reference_default):
    """A self-transfer takes another SSTORE sequence: its whole block is
    the machine path's, as in the reference."""
    def txs(i, nonces):
        to = ADDRS[2] if i == 1 else ADDRS[3]
        return [(2, TOKEN, 0, 100_000, rerc20.transfer_calldata(to, 9)),
                (4, TOKEN, 0, 100_000, rerc20.transfer_calldata(ADDRS[5], 4))]
    rgen, pgen, rblocks = token_chains(3, txs)
    ref, port = replay_both(rgen, pgen, rblocks)
    assert port._machine.blocks == ref._machine.blocks == 1
    assert_slots_equal(ref, port)


def test_token_fastpath_off_sends_token_blocks_to_the_machine(
        reference_default):
    """``token_fastpath=False`` is the reference's
    ``CORETH_NO_TOKEN_FASTPATH=1``: every token block on the machine."""
    reference_default.setenv("CORETH_NO_TOKEN_FASTPATH", "1")
    reference_default.setenv("CORETH_SPECIALIZE", "0")
    rgen, pgen, rblocks = token_chains(
        2, lambda i, nonces: token_txs(i, 6, nonces))
    ref, port = replay_both(rgen, pgen, rblocks, token_fastpath=False,
                            specialize=False)
    assert port._machine.blocks == ref._machine.blocks == 2
    assert len(port.state.slot_keys) == 1 and port.storage_epoch == 0


# forks of a config whose boundaries sit at 0, 10, 20 and 30 seconds:
# Apricot Phase 1 / 2 / 3 and Durango (and Cancun on the last config)
_FORK_CONFIGS = [
    ("ap1..durango", dict(apricot_phase1_time=0, apricot_phase2_time=10,
                          apricot_phase3_time=20, apricot_phase4_time=20,
                          apricot_phase5_time=20,
                          apricot_phase_pre6_time=20,
                          apricot_phase6_time=20,
                          apricot_phase_post6_time=20, banff_time=20,
                          cortina_time=20, durango_time=30)),
    ("cancun", dict(apricot_phase1_time=0, apricot_phase2_time=0,
                    apricot_phase3_time=0, apricot_phase4_time=0,
                    apricot_phase5_time=0, apricot_phase_pre6_time=0,
                    apricot_phase6_time=0, apricot_phase_post6_time=0,
                    banff_time=0, cortina_time=0, durango_time=0,
                    cancun_time=0)),
]


@pytest.mark.parametrize("name,kw", _FORK_CONFIGS, ids=[c[0] for c in
                                                          _FORK_CONFIGS])
def test_exec_gas_variants_match_reference(name, kw):
    """The three variants measured by the port's ``EVM.call`` (the
    native session from Apricot Phase 2 on, the host interpreter before)
    equal the reference's measurements at every fork boundary,
    TEST_CHAIN_CONFIG's and Apricot Phase 1's included.  (Before the
    host interpreter was ported the port refused to measure at Apricot
    Phase 1.)"""
    cases = [(CFG, RCFG, 1, 0)]
    tcfg = tconfig.ChainConfig(chain_id=43111, **kw)
    rcfg = rconfig.ChainConfig(chain_id=43111, **kw)
    cases += [(tcfg, rcfg, 1, t) for t in (0, 10, 20, 30)]
    for tc, rc, number, t in cases:
        for v in ("noop", "set", "reset"):
            assert terc20.measure_transfer_exec_gas(tc, number, t, v) == \
                rerc20.measure_transfer_exec_gas(rc, number, t, v), (t, v)


# ------------------------------------- token blocks between machine windows
def _alternating_txs(i, nonces):
    """Even blocks: token transfers among the funded keys (the fast
    path).  Odd blocks: transfers among the same keys plus one
    ``balanceOf`` call, which the fast path does not take, so the block
    is a machine window on the same contract."""
    out = [(k, TOKEN, 0, 100_000, rerc20.transfer_calldata(
        ADDRS[(k + 1 + i) % 8], 1000 + 37 * i + k)) for k in range(6)]
    if i % 2:
        out.append((7, TOKEN, 0, 100_000, rerc20.BALANCEOF_SELECTOR
                    + b"\x00" * 12 + ADDRS[(i + 2) % 8]))
    return out


@pytest.mark.parametrize("device_occ", [True, False])
def test_token_blocks_alternate_with_machine_windows(reference_default,
                                                     device_occ):
    """Token blocks and machine blocks take turns on the same token's
    slots: each machine window must start from the token blocks' writes
    (the window runner rebuilds when ``storage_epoch`` moved), and each
    token block must classify on the machine blocks' writes (the
    machine path refreshes ``slot_host`` and the device slot table).
    Fold roots equal the reference's and the headers."""
    reference_default.setenv("CORETH_DEVICE_OCC", "1" if device_occ else "0")
    reference_default.setenv("CORETH_SPECIALIZE", "0")
    rgen, pgen, rblocks = token_chains(6, _alternating_txs)
    ref, port = replay_both(rgen, pgen, rblocks, window=2,
                            device_occ=device_occ, specialize=False)
    mx = port._machine
    assert mx.blocks == ref._machine.blocks == 3
    assert port.stats.blocks_device == 6
    assert port.storage_epoch == 3
    assert_slots_equal(ref, port)
    st = port.state
    for sid, (contract, key) in enumerate(st.slot_keys[1:], 1):
        assert port.storage_value(contract, key) == st.slot_host[sid]
    if device_occ:
        assert mx.windows == 3
