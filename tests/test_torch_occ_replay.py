"""The port's fused OCC window path (K6 through ``MachineWindowRunner``)
end to end on the CPU, against the JAX reference.

The reference ``ReplayEngine`` runs its default machine configuration
without specialisation (``CORETH_DEVICE_OCC=1``,
``CORETH_SPECIALIZE=0``; ``CORETH_NO_TOKEN_FASTPATH=1`` and
``CORETH_SERIAL_SHORTCIRCUIT=0`` so token calls and swaps take the
machine), the port's engine runs ``device="cpu", device_occ=True,
specialize=False, token_fastpath=False`` (K6's plain version; tests/test_torch_specialize.py
covers ``specialize=True``). Both replay the same blocks: the roots of
every window fold must agree with each other (and with the headers,
which each fold checks), and the window counters (blocks, rounds,
windows, launches per window, dirty blocks, discovery re-launches,
predicted premaps and their hits) must be equal. The learned-recipe
stores of both packages are module-level, so each test clears them
first. Mirrors tests/test_occ_device.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.state import Database

from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.evm.precompiles import BLACKHOLE_ADDR
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block

from test_occ_device import (
    ALLOW_RUNTIME, ARR_RUNTIME, ESCAPER_CODE, setat_calldata,
    spend_calldata,
)
from test_torch_machine_replay import (
    ADDRS, POOL, RCFG, TOKEN, _chains, _erc20_txs,
)

ALLOW = b"\x78" * 20
ARR = b"\x7a" * 20
ESCAPER = b"\x76" * 20

# counters the port's window path must share with the reference's
COUNTERS = ("blocks", "rounds", "windows", "window_attempts",
            "dirty_blocks", "discovery_dispatches", "premap_predicted",
            "premap_hits", "premap_nested", "premap_array")


@pytest.fixture
def reference_env(monkeypatch):
    """The reference's default machine path without K7; returns the
    monkeypatch for reference-only settings."""
    monkeypatch.setenv("CORETH_DEVICE_OCC", "1")
    monkeypatch.setenv("CORETH_SPECIALIZE", "0")
    monkeypatch.setenv("CORETH_NO_TOKEN_FASTPATH", "1")
    monkeypatch.setenv("CORETH_SERIAL_SHORTCIRCUIT", "0")
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()
    return monkeypatch


def _record_flushes(pipe):
    """Wrap a commit pipeline's flush to record every folded root."""
    roots = []
    flush = pipe.flush

    def recording():
        staged = pipe.staged_blocks
        root = flush()
        if staged:
            roots.append(root)
        return root
    pipe.flush = recording
    return roots


def _ref_replay(monkeypatch, rgen, rblocks, window):
    with monkeypatch.context() as mp:
        if window is not None:
            mp.setenv("CORETH_MACHINE_WINDOW", str(window))
        db = Database()
        rgb = rgen.to_block(db)
        ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header,
                            window=4)
        roots = _record_flushes(ref.commit_pipe)
        assert ref.replay(rblocks) == rblocks[-1].header.root
    assert ref.stats.blocks_fallback == 0
    return ref, roots


def _port_engine(pgen, window=None, device_occ=True):
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, window=4, device="cpu",
                        device_occ=device_occ, specialize=False,
                        token_fastpath=False, serial_shortcircuit=False)
    if window is not None:
        port._machine_executor().WINDOW = window
    return port


def _counters(eng, reference: bool) -> dict:
    mx = eng._machine
    extra = mx.machine_counters() if reference else mx.counters()
    return {k: extra[k] if k in extra else getattr(mx, k)
            for k in COUNTERS}


def _replay_both(env, n_blocks, txs_of, extra=None, window=None):
    """Both engines replay the chain through their window paths; the
    fold roots and the counters must agree.  Returns (ref, port)."""
    rgen, pgen, rblocks = _chains(n_blocks, txs_of, extra)
    ref, ref_roots = _ref_replay(env, rgen, rblocks, window)
    radapter.RECIPES.clear()
    port = _port_engine(pgen, window)
    port_roots = _record_flushes(port.commit_pipe)
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == \
        rblocks[-1].header.root
    port.close()
    assert port_roots == ref_roots
    assert _counters(port, False) == _counters(ref, True)
    return ref, port


def _tx(k, to, kind, arg, gas=200_000, value=0):
    return (k, to, kind, arg, gas, value)


def test_erc20_machine_window_matches_reference_and_per_block(
        reference_env):
    """The benchmark's ERC-20 shape: next-sender links (slow sweep,
    rounds > 1) between fresh-holder transfers; the window run also
    lands the per-block (``device_occ=False``) run's root."""
    _ref, port = _replay_both(reference_env, 3, _erc20_txs)
    mx = port._machine
    c = mx.counters()
    assert mx.blocks == 3 and mx.windows >= 1 and mx.rounds > 0
    assert c["window_launches"] == mx.window_attempts
    assert c["launches"] == 0 and c["window_steps"] > 0
    _rg, pgen, rblocks = _chains(3, _erc20_txs, port_builder=False)
    tadapter.RECIPES.clear()
    per_block = _port_engine(pgen, device_occ=False)
    assert per_block.replay([Block.decode(b.encode()) for b in rblocks]) \
        == port.root
    per_block.close()
    assert per_block._machine.windows == 0
    assert per_block._machine.launches > 0


def test_erc20_next_sender_shape(reference_env):
    """Token transfers to the next key in every lane (the reference's
    erc20-machine equivalence shape)."""
    _ref, port = _replay_both(reference_env, 3, lambda i: [
        _tx(k, TOKEN, "transfer", (ADDRS[(k + 1) % 8], 5 + k))
        for k in range(6)])
    assert port._machine.host_txs == 0


def test_swap_full_conflict_window_2(reference_env):
    """Every swap conflicts with every other: the window converges on
    the device, one lane per round, across pipelined windows."""
    _ref, port = _replay_both(reference_env, 5, lambda i: [
        _tx(k, POOL, "swap", 1000 + 17 * i + k) for k in range(6)],
        window=2)
    mx = port._machine
    assert mx.blocks == 5 and mx.host_txs == 0 and mx.windows >= 3
    assert mx.rounds >= 5 * 5


def test_mixed_shape(reference_env):
    _replay_both(reference_env, 3, lambda i: [
        _tx(0, POOL, "swap", 500 + i),
        _tx(1, TOKEN, "transfer", (b"\x45" * 20, 77)),
        _tx(2, bytes([0x46]) * 20, "raw", b"", 21_000, 5),
        _tx(3, POOL, "swap", 900 + i)])


def test_table_growth_across_pipelined_windows(reference_env):
    """Fresh slots every block push the table past its 64-row floor
    while windows pipeline; senders' slots are rewritten every block,
    so a table or mirror lagging a window would break a root."""
    _ref, port = _replay_both(reference_env, 8, lambda i: [
        _tx(k, TOKEN, "transfer",
            (bytes([0x60 + i]) + bytes([k]) * 19, 3 + k))
        for k in range(8)], window=2)
    mx = port._machine
    assert mx.blocks == 8 and mx.dirty_blocks == 0 and mx.windows >= 4
    assert mx._runner.table_cap >= 128


def test_predicted_premap(reference_env):
    """Fresh recipients every block: after the first window's discovery
    the learned recipes premap every lane's keys before launch."""
    _ref, port = _replay_both(reference_env, 8, lambda i: [
        _tx(k, TOKEN, "transfer",
            (bytes([0x80 + i]) + bytes([k]) * 19, 3 + k))
        for k in range(6)], window=2)
    c = port._machine.counters()
    assert c["premap_predicted"] > 0 and c["premap_hits"] > 0
    assert c["discovery_dispatches"] <= 2
    assert c["window_launches"] / port._machine.blocks <= 1.1


def test_nested_premap_allowance(reference_env):
    """Allowance-style nested-mapping keys learn as second-level
    recipes."""
    extra = {ALLOW: (0, 1, ALLOW_RUNTIME)}
    _ref, port = _replay_both(reference_env, 8, lambda i: [
        _tx(k, ALLOW, "raw",
            spend_calldata(bytes([0xB0 + i]) + bytes([k]) * 19, 5 + k))
        for k in range(6)], extra=extra, window=2)
    c = port._machine.counters()
    assert c["premap_nested"] > 0 and c["premap_hits"] > 0
    assert c["discovery_dispatches"] <= 2


def test_array_premap(reference_env):
    """Dynamic-array element keys (keccak(slot) + i) learn as array
    recipes."""
    extra = {ARR: (0, 1, ARR_RUNTIME)}
    _ref, port = _replay_both(reference_env, 8, lambda i: [
        _tx(k, ARR, "raw", setat_calldata(1000 * i + 7 * k, 5 + k))
        for k in range(6)], extra=extra, window=2)
    c = port._machine.counters()
    assert c["premap_array"] > 0 and c["premap_hits"] > 0
    assert c["discovery_dispatches"] <= 2


def test_transfer_blocks_stop_machine_runs(reference_env):
    """Pure value-transfer blocks inside one machine lookahead end each
    machine run and go to the transfer path.  The transfer classifier
    first indexes the coinbase (funded at genesis) while looking ahead,
    before the run's machine blocks have paid it their fees; the folds
    must replace that staged genesis balance before the transfer block
    reads it.  The transfer blocks also pay an address that the first
    machine block pays."""
    payee = b"\x43" * 20
    extra = {BLACKHOLE_ADDR: (10**18, 0, b"")}

    def txs(i):
        if i % 3 == 2:
            return [_tx(k, payee if k % 2 else bytes([0x60 + k]) * 20,
                        "raw", b"", 21_000, 999 + k) for k in range(4, 8)]
        out = [_tx(k, POOL, "swap", 100 + 11 * i + k) for k in range(4)]
        if i == 0:
            out.append(_tx(5, payee, "raw", b"", 21_000, 12345))
        return out

    _ref, port = _replay_both(reference_env, 7, txs, extra=extra)
    mx = port._machine
    assert port.stats.blocks_device == 7
    assert mx.blocks == 5 and mx.windows == 3 and mx.dirty_blocks == 0


def test_host_escape_raises_where_reference_falls_back(reference_env):
    """A lane the machine cannot run (memory past mem_cap: HOST) dirties
    its block; the per-block path meets the same escape, so the
    reference takes that block on its host path, and so does the port:
    roots, ``blocks_fallback`` and ``dirty_blocks`` equal.  (Before the
    host path was ported the port refused at exactly that block.)"""
    extra = {ESCAPER: (0, 1, ESCAPER_CODE)}

    def txs(i):
        if i == 1:
            return [_tx(0, POOL, "swap", 321),
                    _tx(1, ESCAPER, "raw", b"", 100_000)]
        return [_tx(k, POOL, "swap", 100 + 13 * i + k) for k in range(4)]

    rgen, pgen, rblocks = _chains(3, txs, extra, port_builder=False)
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header,
                        window=4)
    assert ref.replay(rblocks) == rblocks[-1].header.root
    assert ref.stats.blocks_fallback == 1
    port = _port_engine(pgen)
    blocks = [Block.decode(b.encode()) for b in rblocks]
    assert port.replay(blocks) == rblocks[-1].header.root
    port.close()
    assert port.stats.blocks_fallback == ref.stats.blocks_fallback == 1
    assert port._machine.dirty_blocks == ref._machine.dirty_blocks == 1
    assert port._machine.blocks == ref._machine.blocks == 2
