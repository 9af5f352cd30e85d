"""Mixed Avalanche-semantics segment — the BASELINE config[4] fixture.

Port of reference ``workloads/mixed.py``: the same chain, byte for
byte, built by the port's builder on its ``engine=`` path, and the
replay engine wired to the same callbacks.  The reference's
``host_chain`` (a Python ``BlockChain`` over the segment) waits for the
port of ``chain/blockchain.py``.

A historical-segment-shaped chain under the AP5 rule set: periodic
atomic ExtData blocks (ImportTx carrying AVAX for the fee burn plus a
non-AVAX asset for multicoin credits), nativeAssetCall multicoin
transfers (reference core/vm/contracts_stateful_native_asset.go:75),
and plain transfer spam in between.  Deterministic: the shared-memory
hub can be reseeded identically for every replay (UTXO seeds derive
from block indices).
"""

from __future__ import annotations

from typing import List, Tuple

from coreth_tpu_torch.atomic import (
    AtomicBackend, ChainContext, EVMOutput, Memory, TransferableInput,
    TransferableOutput, Tx, UnsignedImportTx, UTXO, make_callbacks,
    short_id,
)
from coreth_tpu_torch.atomic.shared_memory import Element, Requests
from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
from coreth_tpu_torch.consensus.engine import DummyEngine
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address, pubkey
from coreth_tpu_torch.evm.precompiles import NATIVE_ASSET_CALL_ADDR
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import DynamicFeeTx, sign_tx

GWEI = 10**9
CTX = ChainContext()
ASSET = b"\x5b" * 32
ASSET_RECIPIENT = b"\x45" * 20
IMPORT_EVERY = 8            # block i % 8 == 0 -> atomic ExtData block
NAC_EVERY = 8               # block i % 8 == 1 -> nativeAssetCall block


def _short_addr(priv: int) -> bytes:
    return short_id(pubkey(priv))


def _seed(memory: Memory, asset_id: bytes, amount: int, owner: int,
          tx_id: bytes) -> UTXO:
    out = TransferableOutput(asset_id=asset_id, amount=amount,
                            addrs=[_short_addr(owner)])
    utxo = UTXO(tx_id=tx_id, output_index=0, out=out)
    sm_x = memory.new_shared_memory(CTX.x_chain_id)
    sm_x.apply({CTX.chain_id: Requests(put_requests=[
        Element(utxo.input_id(), utxo.encode(), out.addrs)])})
    return utxo


def seed_memory(n_blocks: int, import_key: int) -> Tuple[Memory, list]:
    """Fresh hub with one (AVAX, asset) UTXO pair per import block."""
    memory = Memory()
    utxos = []
    for i in range(0, n_blocks, IMPORT_EVERY):
        avax_u = _seed(memory, CTX.avax_asset_id, 60_000_000,
                       import_key, b"\x21" + i.to_bytes(4, "big") * 7
                       + b"\x21" * 3)
        asset_u = _seed(memory, ASSET, 1_000_000, import_key,
                        b"\x42" + i.to_bytes(4, "big") * 7 + b"\x42" * 3)
        utxos.append((i, avax_u, asset_u))
    return memory, utxos


def _import_tx(avax_u: UTXO, asset_u: UTXO, to: bytes,
               key: int) -> Tx:
    unsigned = UnsignedImportTx(
        network_id=CTX.network_id, blockchain_id=CTX.chain_id,
        source_chain=CTX.x_chain_id,
        imported_inputs=[
            TransferableInput(tx_id=avax_u.tx_id,
                              output_index=avax_u.output_index,
                              asset_id=CTX.avax_asset_id,
                              amount=avax_u.out.amount,
                              sig_indices=[0]),
            TransferableInput(tx_id=asset_u.tx_id,
                              output_index=asset_u.output_index,
                              asset_id=ASSET,
                              amount=asset_u.out.amount,
                              sig_indices=[0])],
        outs=[EVMOutput(address=to, amount=50_000_000,
                        asset_id=CTX.avax_asset_id),
              EVMOutput(address=to, amount=1_000_000,
                        asset_id=ASSET)])
    tx = Tx(unsigned)
    tx.sign([[key], [key]])
    return tx


def build_mixed_chain(config, n_blocks: int, txs_per_block: int,
                      keys: List[int]):
    """Returns (genesis, blocks).  keys[0] is the importer (becomes a
    multicoin account -> its blocks ride the host path); transfer spam
    comes from keys[1:]."""
    addrs = [priv_to_address(k) for k in keys]
    alloc = {a: GenesisAccount(balance=10**24) for a in addrs}
    genesis = Genesis(config=config, gas_limit=8_000_000, alloc=alloc)
    store = StateStore()
    memory, utxos = seed_memory(n_blocks, keys[0])
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    pending: list = []
    cb = make_callbacks(backend, config,
                        pending_atomic_txs=lambda: pending)
    engine = DummyEngine(cb=cb)
    engine.set_config(config)
    gblock = genesis.to_block(store)
    nonces = [0] * len(keys)

    def tx_(k, to, data=b"", gas=21_000, value=0):
        t = sign_tx(DynamicFeeTx(
            chain_id_=config.chain_id, nonce=nonces[k],
            gas_tip_cap_=GWEI, gas_fee_cap_=2000 * GWEI, gas=gas,
            to=to, value=value, data=data), keys[k], config.chain_id)
        nonces[k] += 1
        return t

    def gen(i, bg):
        pending.clear()
        for bi, avax_u, asset_u in utxos:
            if bi == i:
                pending.append(_import_tx(avax_u, asset_u, addrs[0],
                                          keys[0]))
        if i % NAC_EVERY == 1 and i > 1:
            data = (ASSET_RECIPIENT + ASSET
                    + (100 + i).to_bytes(32, "big"))
            bg.add_tx(tx_(0, NATIVE_ASSET_CALL_ADDR, data=data,
                          gas=200_000))
        else:
            for j in range(txs_per_block):
                k = 1 + (i * txs_per_block + j) % (len(keys) - 1)
                to = b"\xe1" + (i * 1000 + j).to_bytes(4, "big") * 4 \
                    + b"\xe1" * 3
                bg.add_tx(tx_(k, to, value=1000 + j))

    blocks, _ = generate_chain(config, gblock, store, n_blocks, gen,
                               gap=10, engine=engine)
    return genesis, blocks


def replay_engine(genesis, n_blocks: int, import_key: int, device=None,
                  **kw):
    """ReplayEngine wired with atomic callbacks over a freshly reseeded
    shared-memory hub, on ``device`` (default ``"cuda"``, which raises
    without a card; ``"cpu"`` runs the kernels' plain versions).
    Returns (engine, genesis block, backend)."""
    from coreth_tpu_torch.replay import ReplayEngine
    memory, _ = seed_memory(n_blocks, import_key)
    store = StateStore()
    gblock = genesis.to_block(store)
    backend = AtomicBackend(CTX, memory.new_shared_memory(CTX.chain_id))
    cb = make_callbacks(backend, genesis.config,
                        pending_atomic_txs=lambda: [])
    return ReplayEngine(genesis.config, store,
                        parent_header=gblock.header, device=device,
                        engine=DummyEngine(cb=cb), **kw), gblock, backend
