"""The port's atomic package against the JAX reference's, on the CPU.

Mirrors every test of tests/test_atomic.py on ``coreth_tpu_torch.atomic``
(all but ``test_import_tx_end_to_end``, which needs the reference's
``BlockChain``, ``Miner`` and ``TxPool``, not ported yet) and the atomic
mempool's tests of tests/test_periphery.py:154,184, then holds the two
packages to each other: the same txs' and UTXOs' wire bytes and ids,
the same ExtData payloads, the same ``AtomicTrie`` roots after the same
``update_trie``/``accept_trie`` sequence, the same shared memory after
the same accepts, and the same repository contents.
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

from coreth_tpu import atomic as R
from coreth_tpu.atomic import repository as r_repository
from coreth_tpu.atomic import shared_memory as RSM

from coreth_tpu_torch import atomic as T
from coreth_tpu_torch.atomic import shared_memory as TSM
from coreth_tpu_torch.atomic import (
    AtomicBackend, AtomicTrie, ChainContext, EVMInput, EVMOutput, Memory,
    TransferableInput, TransferableOutput, Tx, UnsignedExportTx,
    UnsignedImportTx, UTXO, X2C_RATE, decode_ext_data, encode_ext_data,
    short_id,
)
from coreth_tpu_torch.atomic.mempool import AtomicMempool, MempoolError
from coreth_tpu_torch.atomic.repository import AtomicTxRepository
from coreth_tpu_torch.atomic.shared_memory import Element, Requests
from coreth_tpu_torch.atomic.tx import AtomicTxError
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address, pubkey
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.state import StateDB, StateStore

KEY = 0xA70A11C
ADDR = priv_to_address(KEY)
CTX = ChainContext()
GWEI = 10**9


def _short_addr(priv: int) -> bytes:
    return short_id(pubkey(priv))


def seed_import_utxo(memory: Memory, amount: int, owner_priv: int):
    """One AVAX UTXO owned by ``owner_priv`` in the C-chain's inbound
    view from the X chain."""
    out = TransferableOutput(asset_id=CTX.avax_asset_id, amount=amount,
                             addrs=[_short_addr(owner_priv)])
    utxo = UTXO(tx_id=b"\x99" * 32, output_index=0, out=out)
    sm_x = memory.new_shared_memory(CTX.x_chain_id)
    req = Requests(put_requests=[Element(utxo.input_id(), utxo.encode(),
                                         out.addrs)])
    sm_x.apply({CTX.chain_id: req})
    return utxo


def make_import_tx(utxo: UTXO, to: bytes, amount: int) -> Tx:
    unsigned = UnsignedImportTx(
        network_id=CTX.network_id, blockchain_id=CTX.chain_id,
        source_chain=CTX.x_chain_id,
        imported_inputs=[TransferableInput(
            tx_id=utxo.tx_id, output_index=utxo.output_index,
            asset_id=utxo.out.asset_id, amount=utxo.out.amount,
            sig_indices=[0])],
        outs=[EVMOutput(address=to, amount=amount,
                        asset_id=CTX.avax_asset_id)])
    tx = Tx(unsigned)
    tx.sign([[KEY]])
    return tx


# ------------------------------------------- tests/test_atomic.py, ported

def test_wire_roundtrip():
    utxo = UTXO(b"\x01" * 32, 3, TransferableOutput(
        asset_id=b"\x02" * 32, amount=777, addrs=[b"\x03" * 20]))
    assert UTXO.decode(utxo.encode()).out.amount == 777
    tx = make_import_tx(utxo, ADDR, 700)
    data = tx.encode()
    tx2 = Tx.decode(data)
    assert tx2.encode() == data
    assert isinstance(tx2.unsigned, UnsignedImportTx)
    assert tx2.unsigned.outs[0].address == ADDR
    assert tx2.id() == tx.id()
    blob = encode_ext_data([tx])
    txs = decode_ext_data(blob)
    assert len(txs) == 1 and txs[0].id() == tx.id()
    assert decode_ext_data(b"") == []


def test_recover_signers_short_id():
    utxo = UTXO(b"\x01" * 32, 0, TransferableOutput(
        asset_id=CTX.avax_asset_id, amount=10, addrs=[_short_addr(KEY)]))
    tx = make_import_tx(utxo, ADDR, 9)
    assert tx.recover_signers() == [[_short_addr(KEY)]]


def test_import_insufficient_burn_rejected():
    memory = Memory()
    utxo = seed_import_utxo(memory, 1_000, KEY)
    tx = make_import_tx(utxo, ADDR, 1_000)  # burns nothing
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    with pytest.raises(AtomicTxError, match="insufficient AVAX burned"):
        backend.semantic_verify(tx, base_fee=25 * GWEI,
                                rules=CFG.rules(1, 1000))


def test_import_foreign_utxo_rejected():
    memory = Memory()
    utxo = seed_import_utxo(memory, 5_000_000_000, 0xDEAD)  # other owner
    tx = make_import_tx(utxo, ADDR, 1_000)  # signed by KEY
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    with pytest.raises(AtomicTxError, match="not owned"):
        backend.semantic_verify(tx, base_fee=None, rules=CFG.rules(1, 1000))


def _export_tx(nonce=0, signer=KEY):
    unsigned = UnsignedExportTx(
        network_id=CTX.network_id, blockchain_id=CTX.chain_id,
        destination_chain=CTX.x_chain_id,
        ins=[EVMInput(address=ADDR, amount=4 * X2C_RATE,
                      asset_id=CTX.avax_asset_id, nonce=nonce)],
        exported_outputs=[TransferableOutput(
            asset_id=CTX.avax_asset_id, amount=3 * X2C_RATE,
            addrs=[_short_addr(KEY)])])
    tx = Tx(unsigned)
    if signer is not None:
        tx.sign([[signer]])
    return tx


def test_export_tx_state_transfer_and_utxo_creation():
    """ExportTx debits the EVM account (nonce-guarded) on a StateDB over
    the port's store, and accept lands a spendable UTXO in the
    destination chain's inbound space."""
    memory = Memory()
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    statedb = StateDB(StateStore())
    statedb.add_balance(ADDR, 10 * X2C_RATE * X2C_RATE)
    tx = _export_tx()
    unsigned = tx.unsigned
    unsigned.evm_state_transfer(CTX, statedb)
    assert statedb.get_balance(ADDR) == 6 * X2C_RATE * X2C_RATE
    assert statedb.get_nonce(ADDR) == 1
    with pytest.raises(AtomicTxError, match="invalid nonce"):
        unsigned.evm_state_transfer(CTX, statedb)
    backend.insert_txs(b"\xB1" * 32, 1, [tx], parent_hash=b"\x00" * 32)
    backend.accept(b"\xB1" * 32)
    sm_x = memory.new_shared_memory(CTX.x_chain_id)
    found = sm_x.indexed(CTX.chain_id, [_short_addr(KEY)])
    assert len(found) == 1
    utxo = UTXO.decode(found[0])
    assert utxo.out.amount == 3 * X2C_RATE
    assert utxo.tx_id == tx.id()


def test_atomic_trie_commit_interval():
    trie = AtomicTrie(commit_interval=4)
    req = {b"\x58" * 32: Requests(remove_requests=[b"\x01" * 32])}
    for h in (1, 2, 3):
        trie.update_trie(h, req)
        committed, _ = trie.accept_trie(h)
        assert not committed
    trie.update_trie(4, req)
    committed, root = trie.accept_trie(4)
    assert committed
    assert trie.last_committed_height == 4
    reopened = AtomicTrie(node_db=trie.node_db, root=root)
    for h in (1, 2, 3, 4):
        assert reopened.get(h) is not None
    assert reopened.get(9) is None


def test_reject_discards_pending_atomic_state():
    memory = Memory()
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    utxo = seed_import_utxo(memory, 5_000_000_000, KEY)
    tx = make_import_tx(utxo, ADDR, 1)
    backend.insert_txs(b"\xB2" * 32, 1, [tx], parent_hash=b"\x00" * 32)
    backend.reject(b"\xB2" * 32)
    sm = memory.new_shared_memory(CTX.chain_id)
    assert sm.get(CTX.x_chain_id, [utxo.input_id()])
    assert backend.trie.get(1) is None


def test_export_unsigned_rejected():
    memory = Memory()
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    rules = CFG.rules(1, 1000)
    tx = _export_tx(signer=None)
    with pytest.raises(AtomicTxError, match="credential count"):
        backend.semantic_verify(tx, base_fee=None, rules=rules)
    tx.sign([[0xDEAD]])  # not the debited address's key
    with pytest.raises(AtomicTxError, match="not signed by its address"):
        backend.semantic_verify(tx, base_fee=None, rules=rules)
    tx.sign([[KEY]])
    backend.semantic_verify(tx, base_fee=None, rules=rules)


def test_import_duplicate_input_rejected():
    memory = Memory()
    utxo = seed_import_utxo(memory, 5_000_000_000, KEY)
    unsigned = UnsignedImportTx(
        network_id=CTX.network_id, blockchain_id=CTX.chain_id,
        source_chain=CTX.x_chain_id,
        imported_inputs=[TransferableInput(
            tx_id=utxo.tx_id, output_index=0,
            asset_id=utxo.out.asset_id, amount=utxo.out.amount,
            sig_indices=[0])] * 2,
        outs=[EVMOutput(address=ADDR, amount=9_000_000_000,
                        asset_id=CTX.avax_asset_id)])
    tx = Tx(unsigned)
    tx.sign([[KEY], [KEY]])
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    with pytest.raises(AtomicTxError, match="duplicate input"):
        backend.semantic_verify(tx, None, CFG.rules(1, 1000))


def test_processing_ancestor_conflict_rejected():
    memory = Memory()
    utxo = seed_import_utxo(memory, 5_000_000_000, KEY)
    tx1 = make_import_tx(utxo, ADDR, 4_000_000_000)
    tx2 = make_import_tx(utxo, ADDR, 3_999_999_999)  # same input
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    genesis_hash = b"\x60" * 32
    b1 = b"\xB1" * 32
    backend.insert_txs(b1, 1, [tx1], parent_hash=genesis_hash)
    with pytest.raises(AtomicTxError, match="processing ancestor"):
        backend.check_ancestor_conflicts(b1, tx2.unsigned.input_utxos())
    backend.check_ancestor_conflicts(genesis_hash,
                                     tx2.unsigned.input_utxos())
    backend.accept(b1)
    backend.check_ancestor_conflicts(b1, tx2.unsigned.input_utxos())
    backend.insert_txs(b"\xB2" * 32, 2, [tx2], parent_hash=b1)
    with pytest.raises(KeyError, match="absent key"):
        backend.accept(b"\xB2" * 32)


def test_shared_memory_double_remove_raises():
    memory = Memory()
    utxo = seed_import_utxo(memory, 1_000, KEY)
    sm = memory.new_shared_memory(CTX.chain_id)
    req = {CTX.x_chain_id: Requests(remove_requests=[utxo.input_id()])}
    sm.apply(req)
    with pytest.raises(KeyError, match="absent key"):
        sm.apply(req)


def test_import_empty_credential_rejected():
    memory = Memory()
    utxo = seed_import_utxo(memory, 5_000_000_000, 0xDEAD)
    tx = make_import_tx(utxo, ADDR, 1_000)
    tx.creds = [[]]
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    with pytest.raises(AtomicTxError, match="signature count"):
        backend.semantic_verify(tx, None, CFG.rules(1, 1000))


# ----------------------------- tests/test_periphery.py:154,184, ported

def _pool_import_tx(utxo_tx_id: bytes, amount: int, burn: int) -> Tx:
    unsigned = UnsignedImportTx(
        network_id=CTX.network_id, blockchain_id=CTX.chain_id,
        source_chain=CTX.x_chain_id,
        imported_inputs=[TransferableInput(
            tx_id=utxo_tx_id, output_index=0,
            asset_id=CTX.avax_asset_id, amount=amount, sig_indices=[0])],
        outs=[EVMOutput(address=ADDR, amount=amount - burn,
                        asset_id=CTX.avax_asset_id)])
    tx = Tx(unsigned)
    tx.sign([[KEY]])
    return tx


def test_atomic_mempool_price_and_conflicts():
    pool = AtomicMempool(CTX)
    cheap = _pool_import_tx(b"\x01" * 32, 10_000_000, burn=1_000)
    rich = _pool_import_tx(b"\x01" * 32, 10_000_000, burn=900_000)
    other = _pool_import_tx(b"\x02" * 32, 10_000_000, burn=50_000)
    pool.add_tx(cheap)
    with pytest.raises(MempoolError):
        pool.add_tx(cheap)
    pool.add_tx(rich)  # the higher-paying conflict evicts the cheaper
    assert not pool.has(cheap.id())
    with pytest.raises(MempoolError):
        pool.add_tx(cheap)
    pool.add_tx(other)
    assert pool.pending_len() == 2
    first = pool.next_tx()
    assert first.id() == rich.id()
    assert pool.pending_len() == 1
    with pytest.raises(MempoolError):
        pool.add_tx(cheap)  # conflicts with an issued tx
    pool.cancel_current_tx(rich.id())
    assert pool.pending_len() == 2
    pool.remove_accepted([rich.id(), other.id()])
    assert len(pool) == 0


def test_atomic_mempool_eviction_cap():
    pool = AtomicMempool(CTX, max_size=2)
    a = _pool_import_tx(b"\x0A" * 32, 10_000_000, burn=10_000)
    b = _pool_import_tx(b"\x0B" * 32, 10_000_000, burn=20_000)
    c = _pool_import_tx(b"\x0C" * 32, 10_000_000, burn=30_000)
    pool.add_tx(a)
    pool.add_tx(b)
    pool.add_tx(c)  # evicts the cheapest (a)
    assert not pool.has(a.id()) and pool.has(c.id())
    weak = _pool_import_tx(b"\x0D" * 32, 10_000_000, burn=1_000)
    with pytest.raises(MempoolError):
        pool.add_tx(weak)


# ------------------------------------------ against the reference package

RCTX = R.ChainContext()


def _txs(ns, ctx):
    """A UTXO, an import of AVAX and a second asset (two inputs) and an
    export, built alike with package ``ns`` (the port's ``atomic`` or
    the reference's)."""
    owner = _short_addr(KEY)
    utxo = ns.UTXO(b"\x21" * 32, 5, ns.TransferableOutput(
        asset_id=b"\x5b" * 32, amount=123_456, locktime=0, threshold=1,
        addrs=[owner, b"\x07" * 20]))
    imp = ns.Tx(ns.UnsignedImportTx(
        network_id=ctx.network_id, blockchain_id=ctx.chain_id,
        source_chain=ctx.x_chain_id,
        imported_inputs=[
            ns.TransferableInput(tx_id=b"\x31" * 32, output_index=0,
                                 asset_id=ctx.avax_asset_id,
                                 amount=60_000_000, sig_indices=[0]),
            ns.TransferableInput(tx_id=utxo.tx_id, output_index=5,
                                 asset_id=b"\x5b" * 32, amount=123_456,
                                 sig_indices=[0])],
        outs=[ns.EVMOutput(address=ADDR, amount=50_000_000,
                           asset_id=ctx.avax_asset_id),
              ns.EVMOutput(address=ADDR, amount=123_456,
                           asset_id=b"\x5b" * 32)]))
    imp.sign([[KEY], [KEY]])
    exp = ns.Tx(ns.UnsignedExportTx(
        network_id=ctx.network_id, blockchain_id=ctx.chain_id,
        destination_chain=ctx.x_chain_id,
        ins=[ns.EVMInput(address=ADDR, amount=4 * X2C_RATE,
                         asset_id=ctx.avax_asset_id, nonce=7)],
        exported_outputs=[ns.TransferableOutput(
            asset_id=ctx.avax_asset_id, amount=3 * X2C_RATE,
            addrs=[owner])]))
    exp.sign([[KEY]])
    return utxo, imp, exp


def test_wire_bytes_and_ids_match_reference():
    utxo, imp, exp = _txs(T, CTX)
    r_utxo, r_imp, r_exp = _txs(R, RCTX)
    assert utxo.encode() == r_utxo.encode()
    assert utxo.input_id() == r_utxo.input_id()
    for tx, rtx in ((imp, r_imp), (exp, r_exp)):
        assert tx.unsigned_bytes() == rtx.unsigned_bytes()
        assert tx.encode() == rtx.encode()
        assert tx.id() == rtx.id()
        assert tx.unsigned.input_utxos() == rtx.unsigned.input_utxos()
        assert Tx.decode(rtx.encode()).encode() == tx.encode()
        assert R.Tx.decode(tx.encode()).encode() == rtx.encode()
        for fixed in (False, True):
            assert tx.unsigned.gas_used(fixed, len(tx.encode())) == \
                rtx.unsigned.gas_used(fixed, len(rtx.encode()))
    assert imp.recover_signers() == r_imp.recover_signers()
    assert exp.recover_eth_signers() == r_exp.recover_eth_signers() \
        == [[ADDR]]
    assert imp.block_fee_contribution(True, CTX.avax_asset_id, 25 * GWEI) \
        == r_imp.block_fee_contribution(True, RCTX.avax_asset_id,
                                        25 * GWEI)
    assert encode_ext_data([imp, exp]) == R.encode_ext_data([r_imp, r_exp])
    assert [t.id() for t in decode_ext_data(
        R.encode_ext_data([r_imp, r_exp]))] == [imp.id(), exp.id()]


def test_short_id_is_ripemd160_of_sha256():
    """``short_id`` rests on hashlib's RIPEMD-160 (OpenSSL): the standard
    vector, and the reference's ids."""
    assert hashlib.new("ripemd160", b"abc").hexdigest() == \
        "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"
    for priv in (1, KEY, 0xDEAD, 2**255 - 19):
        pub = pubkey(priv)
        comp = bytes([2 + (pub[1] & 1)]) + pub[0].to_bytes(32, "big")
        want = hashlib.new("ripemd160",
                           hashlib.sha256(comp).digest()).digest()
        assert short_id(pub) == want == R.short_id(pub)


def _accept_all(ns, sm_mod, ctx):
    """Seed the import's UTXOs, then accept heights 1-10 (the import at
    3, the export at 6) on a backend whose trie commits every 4
    heights.  Returns (memory, backend, roots after each accept)."""
    _utxo, imp, exp = _txs(ns, ctx)
    memory = ns.Memory()
    sm_x = memory.new_shared_memory(ctx.x_chain_id)
    for inp in imp.unsigned.imported_inputs:
        sm_x.apply({ctx.chain_id: sm_mod.Requests(put_requests=[
            sm_mod.Element(inp.input_id(), b"utxo" + inp.tx_id,
                           [b"\x07" * 20])])})
    backend = ns.AtomicBackend(ctx, memory.new_shared_memory(ctx.chain_id),
                               trie=ns.AtomicTrie(commit_interval=4))
    parent, roots = b"\x00" * 32, []
    for h in range(1, 11):
        bh = bytes([h]) * 32
        txs = {3: [imp], 6: [exp]}.get(h)
        if txs:
            backend.insert_txs(bh, h, txs, parent_hash=parent)
        roots.append(backend.accept(bh, h))
        parent = bh
    return memory, backend, roots


def test_atomic_trie_and_shared_memory_match_reference():
    """The same blocks' effects accepted in both packages: equal trie
    roots after every accept, equal committed roots and node stores,
    equal shared memory."""
    memory, backend, roots = _accept_all(T, TSM, CTX)
    r_memory, r_backend, r_roots = _accept_all(R, RSM, RCTX)
    assert roots == r_roots
    assert sorted(backend.trie.committed_roots) == [0, 4, 8]
    assert backend.trie.committed_roots == r_backend.trie.committed_roots
    assert backend.trie.node_db == r_backend.trie.node_db
    assert memory._spaces == r_memory._spaces
    assert memory._trait_idx == r_memory._trait_idx


def test_repository_matches_reference():
    _u, imp, exp = _txs(T, CTX)
    _ru, r_imp, r_exp = _txs(R, RCTX)
    repo = AtomicTxRepository()
    r_repo = r_repository.AtomicTxRepository()
    for h, txs, r_txs in ((3, [imp, exp], [r_imp, r_exp]),
                          (9, [exp], [r_exp])):
        repo.write(h, txs)
        r_repo.write(h, r_txs)
    assert repo.store == r_repo.store
    tx, height = repo.get_by_tx_id(imp.id())
    assert (tx.encode(), height) == (imp.encode(), 3)
    assert [t.id() for t in repo.get_by_height(3)] == [imp.id(), exp.id()]
    assert repo.get_by_height(4) == [] and repo.get_by_tx_id(b"\x00") is None
