"""The 8-block Avalanche-semantics segment of tests/test_mixed_segment.py,
built with the port alone (no JAX, nothing of the reference), for the
CPU parity tests (tests/test_torch_mixed.py) and the card tests
(tests/test_torch_cuda.py).

Blocks 0 and 4 carry an atomic ImportTx (AVAX for the fee burn plus a
second asset, credited as multicoin balance), blocks 1 and 5 one
``nativeAssetCall`` each, the rest two transfers from keys that never
import, under ``TEST_APRICOT_PHASE5_CONFIG``.
"""

from coreth_tpu_torch.atomic import (
    AtomicBackend, ChainContext, EVMOutput, Memory, TransferableInput,
    TransferableOutput, Tx, UnsignedImportTx, UTXO, make_callbacks,
)
from coreth_tpu_torch.atomic.shared_memory import Element, Requests
from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
from coreth_tpu_torch.consensus.engine import DummyEngine
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.evm.precompiles import NATIVE_ASSET_CALL_ADDR
from coreth_tpu_torch.params import TEST_APRICOT_PHASE5_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import DynamicFeeTx, sign_tx
from coreth_tpu_torch.workloads.mixed import _short_addr

GWEI = 10**9
KEYS = [0x6000 + i for i in range(4)]
ADDRS = [priv_to_address(k) for k in KEYS]
CTX = ChainContext()
ASSET = b"\x5a" * 32
ASSET_RECIPIENT = b"\x44" * 20
IMPORTS = ((0, KEYS[0]), (4, KEYS[1]))


def genesis() -> Genesis:
    return Genesis(config=CFG, gas_limit=8_000_000,
                   alloc={a: GenesisAccount(balance=10**21) for a in ADDRS})


def seed_memory():
    """A hub holding an (AVAX, asset) UTXO pair for each import block:
    (memory, [(block, key, avax utxo, asset utxo)])."""
    memory = Memory()
    sm_x = memory.new_shared_memory(CTX.x_chain_id)
    imports = []
    for bi, key in IMPORTS:
        pair = []
        for asset, amount, tag in ((CTX.avax_asset_id, 50_000_000, 0x20),
                                   (ASSET, 777_000, 0x40)):
            out = TransferableOutput(asset_id=asset, amount=amount,
                                     addrs=[_short_addr(key)])
            utxo = UTXO(tx_id=bytes([tag + bi]) * 32, output_index=0,
                        out=out)
            sm_x.apply({CTX.chain_id: Requests(put_requests=[
                Element(utxo.input_id(), utxo.encode(), out.addrs)])})
            pair.append(utxo)
        imports.append((bi, key, *pair))
    return memory, imports


def _import_tx(avax_u, asset_u, key: int) -> Tx:
    unsigned = UnsignedImportTx(
        network_id=CTX.network_id, blockchain_id=CTX.chain_id,
        source_chain=CTX.x_chain_id,
        imported_inputs=[
            TransferableInput(tx_id=u.tx_id, output_index=u.output_index,
                              asset_id=u.out.asset_id, amount=u.out.amount,
                              sig_indices=[0])
            for u in (avax_u, asset_u)],
        outs=[EVMOutput(address=priv_to_address(key), amount=40_000_000,
                        asset_id=CTX.avax_asset_id),
              EVMOutput(address=priv_to_address(key), amount=777_000,
                        asset_id=ASSET)])
    tx = Tx(unsigned)
    tx.sign([[key], [key]])
    return tx


def build_segment(n_blocks: int = 8):
    """The segment, built by the port's builder on its ``engine=`` path
    with the atomic callbacks: (genesis, blocks)."""
    memory, imports = seed_memory()
    gen_ = genesis()
    store = StateStore()
    gblock = gen_.to_block(store)
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    pending = []
    engine = DummyEngine(cb=make_callbacks(
        backend, CFG, pending_atomic_txs=lambda: pending))
    nonces = [0] * len(KEYS)

    def tx_(k, to, data=b"", gas=21_000, value=0):
        t = sign_tx(DynamicFeeTx(
            chain_id_=CFG.chain_id, nonce=nonces[k], gas_tip_cap_=GWEI,
            gas_fee_cap_=300 * GWEI, gas=gas, to=to, value=value,
            data=data), KEYS[k], CFG.chain_id)
        nonces[k] += 1
        return t

    def gen(i, bg):
        pending[:] = [_import_tx(avax_u, asset_u, key)
                      for bi, key, avax_u, asset_u in imports if bi == i]
        if i in (1, 5):
            data = ASSET_RECIPIENT + ASSET + (1000 + i).to_bytes(32, "big")
            bg.add_tx(tx_(0 if i == 1 else 1, NATIVE_ASSET_CALL_ADDR,
                          data=data, gas=200_000))
        else:
            for k in (2, 3):
                bg.add_tx(tx_(k, bytes([0x30 + k]) * 20, value=1234 + i))

    blocks, _ = generate_chain(CFG, gblock, store, n_blocks, gen, gap=2,
                               engine=engine)
    return gen_, blocks


def replay_engine(device, window: int = 4, **kw):
    """The port's engine over a fresh store of the segment's genesis,
    its host path finalized by callbacks over a freshly seeded hub
    (``kw``: more ``ReplayEngine`` keywords): (engine, store, backend)."""
    memory, _ = seed_memory()
    store = StateStore(backend=kw.get("trie", "native"),
                       check=kw.get("trie_check", False))
    gblock = genesis().to_block(store)
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    cb = make_callbacks(backend, CFG, pending_atomic_txs=lambda: [])
    eng = ReplayEngine(CFG, store, parent_header=gblock.header,
                       engine=DummyEngine(cb=cb), window=window,
                       capacity=256, batch_pad=64, device=device, **kw)
    return eng, store, backend
