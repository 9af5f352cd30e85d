"""The port's transfer-replay slice on the CPU against the JAX reference.

Chains come from both builders, replay runs through both engines, and
roots are compared window by window with each other and with the
headers.  The port runs with ``device="cpu"``: its kernels' plain
versions.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

from coreth_tpu.chain import Genesis as RGenesis
from coreth_tpu.chain import GenesisAccount as RAccount
from coreth_tpu.chain import generate_chain as r_generate_chain
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.params import TEST_CHAIN_CONFIG as RCFG
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.replay import engine as jengine
from coreth_tpu.state import Database
from coreth_tpu.types import Block as RBlock
from coreth_tpu.types import DynamicFeeTx as RDynamicFeeTx
from coreth_tpu.types import LatestSigner as RSigner
from coreth_tpu.types import sign_tx as r_sign_tx

from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
from coreth_tpu_torch.mpt import NativeSecureTrie
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import DeviceState, ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.replay import engine as tengine
from coreth_tpu_torch.types import Block, DynamicFeeTx, LatestSigner, sign_tx

GWEI = 10**9
KEYS = [0x1000 + i for i in range(8)]
ADDRS = [priv_to_address(k) for k in KEYS]


def _gen(txs_per_block, cross, dyn, sign, cfg, fresh_every=0):
    nonces = [0] * len(KEYS)

    def gen(i, bg):
        for j in range(txs_per_block):
            k = (i * txs_per_block + j) % len(KEYS)
            if fresh_every and j % fresh_every == 0:
                n = i * txs_per_block + j
                to = b"\xf0" + n.to_bytes(4, "big") * 4 + b"\xf0" * 3
            elif cross:
                to = ADDRS[(k + 1) % len(KEYS)]
            else:
                to = bytes([0x40 + k]) * 20
            if cross and j % 5 == 4:
                to = ADDRS[k]                 # sender == recipient
            bg.add_tx(sign(dyn(
                chain_id_=cfg.chain_id, nonce=nonces[k],
                gas_tip_cap_=GWEI, gas_fee_cap_=300 * GWEI, gas=21_000,
                to=to, value=1000 + j), KEYS[k], cfg.chain_id))
            nonces[k] += 1
    return gen


def _alloc(cls):
    return {a: cls(balance=10**24) for a in ADDRS}


def ref_chain(n_blocks, txs, cross=False, fresh_every=0):
    genesis = RGenesis(config=RCFG, gas_limit=8_000_000,
                       alloc=_alloc(RAccount))
    db = Database()
    gblock = genesis.to_block(db)
    blocks, _ = r_generate_chain(
        RCFG, gblock, db, n_blocks,
        _gen(txs, cross, RDynamicFeeTx, r_sign_tx, RCFG, fresh_every),
        gap=2)
    return genesis, blocks


def port_genesis():
    genesis = Genesis(config=CFG, gas_limit=8_000_000,
                      alloc=_alloc(GenesisAccount))
    store = StateStore()
    return genesis, genesis.to_block(store), store


def port_chain(n_blocks, txs, cross=False, fresh_every=0):
    genesis, gblock, store = port_genesis()
    blocks, _ = generate_chain(
        CFG, gblock, store, n_blocks,
        _gen(txs, cross, DynamicFeeTx, sign_tx, CFG, fresh_every), gap=2)
    return gblock, blocks


def to_port(blocks):
    return [Block.decode(b.encode()) for b in blocks]


def to_ref(blocks):
    return [RBlock.decode(b.encode()) for b in blocks]


# ------------------------------------------------------- chain builder

@pytest.mark.parametrize("cross", [False, True])
def test_chain_builder_matches_reference(cross):
    _g, ref_blocks = ref_chain(3, 10, cross=cross)
    _gb, blocks = port_chain(3, 10, cross=cross)
    assert [b.hash() for b in blocks] == [b.hash() for b in ref_blocks]
    assert [b.encode() for b in blocks] == [b.encode() for b in ref_blocks]


def _gen_mixed(dyn, legacy, sign, cfg):
    """Legacy txs with unused gas (refund), zero-value transfers to
    missing accounts (EIP-158 no-op), self-transfers, a genesis account
    with no balance."""
    nonces = [0] * len(KEYS)

    def gen(i, bg):
        for j in range(8):
            k = (i * 8 + j) % len(KEYS)
            to, value = bytes([0x40 + k]) * 20, 1000 + j
            if j == 3:
                to, value = bytes([0x60 + i]) * 20, 0
            elif j == 5:
                to = ADDRS[k]
            elif j == 7:
                to = b"\x55" * 20
            if j == 6:
                inner = legacy(nonce=nonces[k], gas_price=400 * GWEI,
                               gas=30_000, to=to, value=value)
            else:
                inner = dyn(chain_id_=cfg.chain_id, nonce=nonces[k],
                            gas_tip_cap_=GWEI, gas_fee_cap_=300 * GWEI,
                            gas=21_000, to=to, value=value)
            bg.add_tx(sign(inner, KEYS[k], cfg.chain_id))
            nonces[k] += 1
    return gen


def test_chain_builder_matches_reference_on_edge_transfers():
    from coreth_tpu.types import LegacyTx as RLegacyTx
    from coreth_tpu_torch.types import LegacyTx
    alloc = {**_alloc(RAccount), b"\x55" * 20: RAccount(balance=0)}
    genesis = RGenesis(config=RCFG, gas_limit=8_000_000, alloc=alloc)
    db = Database()
    ref_blocks, _ = r_generate_chain(
        RCFG, genesis.to_block(db), db, 4,
        _gen_mixed(RDynamicFeeTx, RLegacyTx, r_sign_tx, RCFG), gap=2)
    palloc = {**_alloc(GenesisAccount),
              b"\x55" * 20: GenesisAccount(balance=0)}
    pgen = Genesis(config=CFG, gas_limit=8_000_000, alloc=palloc)
    store = StateStore()
    blocks, _ = generate_chain(
        CFG, pgen.to_block(store), store, 4,
        _gen_mixed(DynamicFeeTx, LegacyTx, sign_tx, CFG), gap=2)
    assert [b.hash() for b in blocks] == [b.hash() for b in ref_blocks]


def test_written_out_hash_constants():
    from coreth_tpu_torch import rlp
    from coreth_tpu_torch.crypto import keccak256
    from coreth_tpu_torch.types.account import (
        EMPTY_CODE_HASH, EMPTY_ROOT_HASH)
    from coreth_tpu_torch.types.block import EMPTY_UNCLE_HASH
    assert EMPTY_CODE_HASH == keccak256(b"")
    assert EMPTY_ROOT_HASH == keccak256(rlp.encode(b""))
    assert EMPTY_UNCLE_HASH == keccak256(rlp.encode([]))
    assert NativeSecureTrie().hash() == EMPTY_ROOT_HASH


def test_types_decode_reference_wire_blocks():
    _g, ref_blocks = ref_chain(2, 8, cross=True)
    rsigner, signer = RSigner(RCFG.chain_id), LatestSigner(CFG.chain_id)
    for rb, pb in zip(ref_blocks, to_port(ref_blocks)):
        assert pb.hash() == rb.hash()
        assert pb.encode() == rb.encode()
        fresh_ref = RBlock.decode(rb.encode())
        for rtx, ptx in zip(fresh_ref.transactions, pb.transactions):
            assert ptx.hash() == rtx.hash()
            assert signer.sig_hash(ptx) == rsigner.sig_hash(rtx)
            assert signer.sender(ptx) == rsigner.sender(rtx)


# -------------------------------------------------------- replay parity

def _engines(window, capacity=256):
    genesis, _ref_blocks = ref_chain(0, 0)
    db = Database()
    gb = genesis.to_block(db)
    ref = RReplayEngine(RCFG, db, gb.root, parent_header=gb.header,
                        capacity=capacity, batch_pad=64, window=window)
    _pg, pgb, store = port_genesis()
    port = ReplayEngine(CFG, store, parent_header=pgb.header,
                        capacity=capacity, batch_pad=64, window=window,
                        device="cpu")
    return ref, port


def _replay_by_window(ref_blocks, window, capacity=256,
                      plain_ladder=False):
    ref, port = _engines(window, capacity)
    if plain_ladder:
        # force the device recovery leg through the plain ladder
        port.recover_device = True
        port.DEVICE_RECOVER_MIN = 1
    pblocks = to_port(ref_blocks)
    roots = []
    for lo in range(0, len(ref_blocks), window):
        r_root = ref.replay(to_ref(ref_blocks[lo:lo + window]))
        p_root = port.replay(pblocks[lo:lo + window])
        want = ref_blocks[min(lo + window, len(ref_blocks)) - 1].header.root
        assert p_root == r_root == want
        roots.append(p_root)
    assert port.stats.blocks_device == len(ref_blocks)
    assert ref.stats.blocks_fallback == 0
    port.close()
    return port, roots


def test_replay_disjoint_transfers():
    _g, blocks = ref_chain(4, 16)
    port, _roots = _replay_by_window(blocks, 2, plain_ladder=True)
    assert port.stats.txs == 64
    assert port.stats.sigs_device == 64 and port.stats.sigs_host == 0


def test_replay_cross_transfers_sender_is_recipient():
    _g, blocks = ref_chain(3, 8, cross=True)
    port, _roots = _replay_by_window(blocks, 16)
    assert port.stats.sigs_host == 24


def test_replay_windows_multiple_blocks_per_device_call(monkeypatch):
    _g, blocks = ref_chain(6, 8)
    _ref, port = _engines(8)
    calls = []
    orig = port._issue_window_run

    def spy(items):
        calls.append(len(items))
        return orig(items)

    monkeypatch.setattr(port, "_issue_window_run", spy)
    assert port.replay(to_port(blocks)) == blocks[-1].header.root
    assert calls == [6], calls
    port.close()


def test_prepare_window_pads_to_pow2_like_reference():
    _g, blocks = ref_chain(3, 8)
    ref, port = _engines(16)
    pblocks = to_port(blocks)
    ref.warm_senders(blocks)
    port.warm_senders(pblocks)
    r_items = [(b, ref._classify(b)) for b in blocks]
    p_items = [(b, port._classify(b)) for b in pblocks]
    for n in (1, 3):
        r = ref._prepare_window(r_items[:n])
        p = port._prepare_window(p_items[:n])
        assert p[0].shape[0] == (1 if n == 1 else 4)
        # txds, t_idxs, s_idxs, acct_gids, slot_gids: the same layout
        for a, b in zip(p[:5], r[:5]):
            assert np.array_equal(a, b)
    port.close()


def test_replay_table_growth_mid_chain():
    """Fresh recipients outgrow a 64-row table mid-chain."""
    _g, blocks = ref_chain(8, 16, fresh_every=2)
    port, _roots = _replay_by_window(blocks, 2, capacity=64)
    assert port.state.capacity > 64
    assert len(port.state.addrs) > 64


def test_device_state_from_arrays_carries_reference_tables():
    _g, blocks = ref_chain(5, 8, cross=True)
    ref, port = _engines(16)
    pblocks = to_port(blocks)
    ref.replay(to_ref(blocks[:3]))
    port.replay(pblocks[:3])
    st = ref.state
    meta = dict(addrs=st.addrs, row_of=st.row_of, has_code=st.has_code,
                multicoin=st.multicoin, code_hashes=st.code_hashes,
                roots=st.roots, slot_row_of=st.slot_row_of)
    port.state = DeviceState.from_arrays(
        np.asarray(st.balances), np.asarray(st.nonces),
        np.asarray(st.slot_vals), meta, device="cpu")
    # identical window outputs from the carried tables
    ref_rest = to_ref(blocks[3:])
    ref.warm_senders(ref_rest)
    items = [(b, ref._classify(b)) for b in ref_rest]
    txds, t_idxs, s_idxs, acct_gids, slot_gids, *_ = \
        ref._prepare_window(items)
    want = jengine._transfer_window(
        st.balances, st.nonces, st.slot_vals, acct_gids, slot_gids, txds,
        t_idxs, s_idxs)
    got = tengine._transfer_window(
        port.state.balances, port.state.nonces, port.state.slot_vals,
        *(torch.from_numpy(a) for a in (acct_gids, slot_gids, txds,
                                        t_idxs, s_idxs)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # and the port engine replays on from them to the header root
    assert port.replay(pblocks[3:]) == blocks[-1].header.root
    port.close()


def test_contract_block_raises_where_reference_falls_back():
    """The reference runs a contract-creation block on its host path;
    so does the port (its Processor over a StateDB on the engine's
    store), and both land on the header roots with the same device and
    host-path block counts.  (Before the host path was ported the port
    refused at exactly that block.)"""
    from coreth_tpu.chain import Genesis as RG, GenesisAccount as RA
    genesis = RG(config=RCFG, gas_limit=8_000_000,
                 alloc={ADDRS[0]: RA(balance=10**24)})
    db = Database()
    gblock = genesis.to_block(db)
    runtime = bytes.fromhex("60003560005500")
    init = b"\x66" + runtime + bytes.fromhex("60005260076019f3")

    def gen(i, bg):
        to, data, gas = (None, init, 200_000) if i == 1 \
            else (b"\x77" * 20, b"", 21_000)
        bg.add_tx(r_sign_tx(RDynamicFeeTx(
            chain_id_=RCFG.chain_id, nonce=i, gas_tip_cap_=GWEI,
            gas_fee_cap_=300 * GWEI, gas=gas, to=to, value=5 if to else 0,
            data=data), KEYS[0], RCFG.chain_id))

    blocks, _ = r_generate_chain(RCFG, gblock, db, 3, gen, gap=2)
    db2 = Database()
    gb2 = genesis.to_block(db2)
    ref = RReplayEngine(RCFG, db2, gb2.root, parent_header=gb2.header,
                        capacity=256, batch_pad=64)
    assert ref.replay(to_ref(blocks)) == blocks[-1].header.root
    assert ref.stats.blocks_fallback == 1

    pgen = Genesis(config=CFG, gas_limit=8_000_000,
                   alloc={ADDRS[0]: GenesisAccount(balance=10**24)})
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, device="cpu")
    pblocks = to_port(blocks)
    assert port.replay(pblocks) == blocks[-1].header.root
    assert port.store.trie.hash() == blocks[-1].header.root
    assert (port.stats.blocks_device, port.stats.blocks_fallback) == \
        (ref.stats.blocks_device, ref.stats.blocks_fallback) == (2, 1)
    port.close()


def test_device_rejected_block_raises_with_block():
    """A block whose device ok flag is 0 (here: the device table holds
    a nonce the block's sender sequence does not follow) rewinds and
    runs on the host path, which reads the true state: the replay lands
    on the header root, and the host path's refresh repairs the row.
    (Before the host path was ported this raised with .block set.)"""
    _gb, blocks = port_chain(3, 4)
    pblocks = to_port(blocks)
    _g, pgb, store = port_genesis()
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, device="cpu")
    port.replay(pblocks[:2])
    row = port.state.row_of[port.state.index[ADDRS[0]]]
    port.state.nonces[row] += 7
    assert port.replay(pblocks[2:]) == blocks[2].header.root
    assert port.stats.blocks_fallback == 1
    assert port.stats.blocks_device == 2
    from coreth_tpu_torch.types import StateAccount
    want = StateAccount.from_rlp(port.trie.get(ADDRS[0]))
    got = port.state.read_accounts([port.state.index[ADDRS[0]]])[0]
    assert got == (want.balance, want.nonce)
    port.close()
