"""The port's machine-block slice end to end on the CPU, against the JAX
reference.

Chains of contract calls (ERC-20 ``transfer()``/``balanceOf()``, swaps
into the shared-slot pool, reverts, transfers in between) come from both
chain builders and must be the same blocks. The reference
``ReplayEngine`` (``CORETH_NO_TOKEN_FASTPATH=1``, and
``CORETH_SERIAL_SHORTCIRCUIT=0`` so swaps take OCC too) and the port's
engine (``device="cpu"``: the kernels' plain versions;
``token_fastpath=False``) replay the same
blocks one by one, both in the per-block OCC configuration
(``CORETH_DEVICE_OCC=0`` / ``device_occ=False``: K5) and, where a case
holds in both, also in the fused window configuration
(``CORETH_DEVICE_OCC=1`` with ``CORETH_SPECIALIZE=0`` /
``device_occ=True, specialize=False``: K6, one-block windows): the roots
must agree with each other and with the headers after every block, and
the machine counters (blocks, OCC rounds, conflict-suffix txs) must
agree. Mirrors tests/test_machine_block.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

from coreth_tpu.chain import Genesis as RGenesis
from coreth_tpu.chain import GenesisAccount as RAccount
from coreth_tpu.chain import generate_chain as r_generate_chain
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.params import TEST_CHAIN_CONFIG as RCFG
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.state import Database
from coreth_tpu.types import DynamicFeeTx as RDynamicFeeTx
from coreth_tpu.types import sign_tx as r_sign_tx
from coreth_tpu.workloads import erc20 as rerc20
from coreth_tpu.workloads import swap as rswap

from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block, DynamicFeeTx, sign_tx
from coreth_tpu_torch.workloads import erc20 as terc20
from coreth_tpu_torch.workloads import swap as tswap

GWEI = 10**9
KEYS = [0x2000 + i for i in range(8)]
ADDRS = [priv_to_address(k) for k in KEYS]
POOL = b"\x70" * 20
TOKEN = b"\x71" * 20

# (DynamicFeeTx, sign_tx, erc20, swap, GenesisAccount) of each package
REF = (RDynamicFeeTx, r_sign_tx, rerc20, rswap, RAccount, RCFG)
PORT = (DynamicFeeTx, sign_tx, terc20, tswap, GenesisAccount, CFG)


@pytest.fixture
def reference_env(monkeypatch):
    """The reference's per-block OCC configuration (K3+K4+K5 only)."""
    monkeypatch.setenv("CORETH_DEVICE_OCC", "0")
    monkeypatch.setenv("CORETH_NO_TOKEN_FASTPATH", "1")
    monkeypatch.setenv("CORETH_SERIAL_SHORTCIRCUIT", "0")


def _occ_env(monkeypatch, device_occ: bool) -> None:
    """Switch the reference to the port's configuration: its fused
    window path without K7 when ``device_occ``, else per-block OCC.
    Both packages' learned-recipe stores start empty."""
    monkeypatch.setenv("CORETH_DEVICE_OCC", "1" if device_occ else "0")
    monkeypatch.setenv("CORETH_SPECIALIZE", "0")
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()


def _alloc(pkg, extra=None):
    _tx, _sign, erc20, swap, Account, _cfg = pkg
    alloc = {a: Account(balance=10**24) for a in ADDRS}
    alloc[POOL] = swap.pool_genesis_account(10**15, 10**15)
    alloc[TOKEN] = erc20.token_genesis_account({a: 10**21 for a in ADDRS})
    for addr, (balance, nonce, code) in (extra or {}).items():
        alloc[addr] = Account(balance=balance, nonce=nonce, code=code)
    return alloc


def _gen(pkg, txs_of):
    """gen(i, bg) adding txs_of(i) = [(key, to, kind, arg, gas, value)]
    with kind "transfer" (arg = (to, amount)), "balanceof" (arg =
    holder), "swap" (arg = amount in) or "raw" (arg = calldata)."""
    Tx, sign, erc20, swap, _acct, cfg = pkg
    nonces = [0] * len(KEYS)

    def gen(i, bg):
        for k, to, kind, arg, gas, value in txs_of(i):
            if kind == "transfer":
                data = erc20.transfer_calldata(*arg)
            elif kind == "balanceof":
                data = erc20.BALANCEOF_SELECTOR + b"\x00" * 12 + arg
            elif kind == "swap":
                data = swap.swap_calldata(arg)
            else:
                data = arg
            bg.add_tx(sign(Tx(
                chain_id_=cfg.chain_id, nonce=nonces[k], gas_tip_cap_=GWEI,
                gas_fee_cap_=300 * GWEI, gas=gas, to=to, value=value,
                data=data), KEYS[k], cfg.chain_id))
            nonces[k] += 1
    return gen


def _chains(n_blocks, txs_of, extra=None, port_builder=True):
    """Both builders' chains; asserts they are the same blocks.  The
    port's builder is skipped for chains it cannot build (calls that
    need the host interpreter)."""
    rgen = RGenesis(config=RCFG, gas_limit=8_000_000,
                    alloc=_alloc(REF, extra))
    db = Database()
    rgb = rgen.to_block(db)
    rblocks, _ = r_generate_chain(RCFG, rgb, db, n_blocks,
                                  _gen(REF, txs_of), gap=2)
    pgen = Genesis(config=CFG, gas_limit=8_000_000,
                   alloc=_alloc(PORT, extra))
    store = StateStore()
    pgb = pgen.to_block(store)
    assert pgb.hash() == rgb.hash()
    if port_builder:
        pblocks, _ = generate_chain(CFG, pgb, store, n_blocks,
                                    _gen(PORT, txs_of), gap=2)
        assert [b.hash() for b in pblocks] == [b.hash() for b in rblocks]
    return rgen, pgen, rblocks


def _replay_both(n_blocks, txs_of, extra=None, device_occ=False):
    rgen, pgen, rblocks = _chains(n_blocks, txs_of, extra)
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header,
                        window=4)
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, device="cpu", device_occ=device_occ,
                        specialize=False, token_fastpath=False,
                        serial_shortcircuit=False)
    for rb in rblocks:
        ref.replay_block(rb)
        port.replay_block(Block.decode(rb.encode()))
        assert port.root == ref.root == rb.header.root, rb.number
    assert ref.stats.blocks_fallback == 0
    rm, pm = ref._machine, port._machine
    assert (pm.blocks, pm.rounds, pm.host_txs) == \
        (rm.blocks, rm.rounds, rm.host_txs)
    port.close()
    return port


def _erc20_txs(i, n=12):
    """The benchmark's ERC-20 shape: every third recipient is the next
    key (a read-after-write conflict one link deep), the rest a rotating
    pool of fresh holders."""
    out = []
    for j in range(n):
        k = (i * n + j) % len(KEYS)
        to = ADDRS[(k + 1) % len(KEYS)] if j % 3 == 0 \
            else (0x5000 + (i * 7 + j) % 1999).to_bytes(2, "big") * 10
        out.append((k, TOKEN, "transfer", (to, 10 + j), 100_000, 0))
    return out


@pytest.mark.parametrize("device_occ", [False, True])
def test_erc20_chain_matches_reference(reference_env, monkeypatch,
                                       device_occ):
    _occ_env(monkeypatch, device_occ)
    port = _replay_both(3, _erc20_txs, device_occ=device_occ)
    mx = port._machine
    c = mx.counters()
    assert mx.blocks == 3 and mx.rounds > 0
    if device_occ:
        assert c["window_launches"] >= 3 and c["window_steps"] > 0
        assert mx.launches == 0 and mx.windows == 3
    else:
        assert mx.launches >= 3 and mx.steps > 0
        assert c["window_launches"] == 0


def test_deep_swap_conflict_chain_suffix_on_native_session(reference_env):
    """Every swap conflicts with every other: past the device rounds the
    suffix resolves per tx on the native session, keeping the valid
    device prefix."""
    port = _replay_both(2, lambda i: [
        (k, POOL, "swap", 100 + 31 * i + k, 200_000, 0)
        for k in range(8)])
    mx = port._machine
    assert mx.blocks == 2
    assert 0 < mx.host_txs < 2 * 8
    assert mx.native_txs == mx.host_txs


@pytest.mark.parametrize("device_occ", [False, True])
def test_disjoint_balanceof_calls_take_one_round(reference_env, monkeypatch,
                                                 device_occ):
    _occ_env(monkeypatch, device_occ)
    port = _replay_both(2, lambda i: [
        (k, TOKEN, "balanceof", ADDRS[k], 200_000, 0) for k in range(6)],
        device_occ=device_occ)
    assert port._machine.blocks == 2 and port._machine.rounds == 0


@pytest.mark.parametrize("device_occ", [False, True])
def test_machine_block_with_reverts(reference_env, monkeypatch, device_occ):
    _occ_env(monkeypatch, device_occ)
    _replay_both(2, lambda i: [
        (0, TOKEN, "transfer", (b"\x50" * 20, 10), 200_000, 0),
        (1, TOKEN, "transfer", (b"\x51" * 20, 10**30), 200_000, 0),
        (2, TOKEN, "transfer", (b"\x52" * 20, 5), 30_000, 0),    # OOG
    ], device_occ=device_occ)


@pytest.mark.parametrize("device_occ", [False, True])
def test_machine_then_transfer_interleave(reference_env, monkeypatch,
                                          device_occ):
    """Machine blocks interleave with transfer-path blocks (and a
    value transfer inside a machine block); the device tables stay
    coherent across the hand-off."""
    def txs(i):
        if i % 2 == 0:
            return [(k, POOL, "swap", 100 + k, 200_000, 0)
                    for k in range(4)] + [
                (5, bytes([0x43]) * 20, "raw", b"", 21_000, 12345)]
        return [(k, bytes([0x60 + k]) * 20, "raw", b"", 21_000, 999)
                for k in range(4)]
    _occ_env(monkeypatch, device_occ)
    port = _replay_both(4, txs, device_occ=device_occ)
    assert port.stats.blocks_device == 4 and port._machine.blocks == 2


@pytest.mark.parametrize("device_occ", [False, True])
def test_ineligible_block_raises_where_reference_falls_back(
        reference_env, monkeypatch, device_occ):
    """A call into host-only bytecode (SELFBALANCE) runs on the
    reference's host path and on the port's, with the same roots and
    host-path block count.  (Before the host path was ported the port
    refused at exactly that block.)  The port's builder still refuses
    the call: it runs contract calls on the native session only."""
    _occ_env(monkeypatch, device_occ)
    holder = b"\x72" * 20
    extra = {holder: (5, 1, bytes.fromhex("47600055" + "00"))}

    def txs(i):
        if i == 0:
            return [(0, TOKEN, "transfer", (b"\x50" * 20, 10), 200_000, 0)]
        return [(0, holder, "raw", b"", 100_000, 0),
                (1, POOL, "swap", 100, 200_000, 0)]

    rgen, pgen, rblocks = _chains(2, txs, extra, port_builder=False)
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header)
    assert ref.replay(rblocks) == rblocks[-1].header.root
    assert ref.stats.blocks_fallback == 1
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, device="cpu", device_occ=device_occ,
                        token_fastpath=False, serial_shortcircuit=False)
    blocks = [Block.decode(b.encode()) for b in rblocks]
    assert port.replay(blocks) == rblocks[-1].header.root
    assert port.stats.blocks_fallback == ref.stats.blocks_fallback == 1
    assert port.stats.blocks_device == ref.stats.blocks_device
    port.close()
    # the port's builder refuses the same call rather than guess
    from coreth_tpu_torch.chain.chain_makers import InvalidTransfer
    store2 = StateStore()
    with pytest.raises(InvalidTransfer, match="host interpreter"):
        generate_chain(CFG, pgen.to_block(store2), store2, 2,
                       _gen(PORT, txs))


@pytest.mark.parametrize("workload", ["erc20", "swap"])
def test_chain_builder_matches_reference(workload):
    """The port's builder (calls on the native session) produces the
    reference builder's blocks, header hashes included."""
    if workload == "erc20":
        _chains(2, lambda i: _erc20_txs(i, 16))
    else:
        _chains(2, lambda i: [(k, POOL, "swap", 10**6 + i * 131 + k,
                               100_000, 0) for k in range(8)])
