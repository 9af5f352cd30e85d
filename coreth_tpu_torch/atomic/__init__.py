"""Atomic (cross-chain UTXO <-> EVM) transactions.

Port of reference ``atomic/``: the replay engine's host path applies
an ExtData block's atomic txs through ``make_callbacks``.

Twin of reference plugin/evm/{tx,import_tx,export_tx,atomic_trie,
atomic_backend}.go + the avalanchego SharedMemory seam: ImportTx
consumes shared-memory UTXOs and credits EVM balances, ExportTx debits
EVM accounts (nonce-checked) and creates UTXOs for the destination
chain; accepted blocks' atomic operations are indexed by height in the
AtomicTrie and applied to SharedMemory on Accept.
"""

from coreth_tpu_torch.atomic.tx import (
    EVMInput, EVMOutput, Tx, TransferableInput, TransferableOutput,
    UnsignedExportTx, UnsignedImportTx, UTXO, calculate_dynamic_fee,
    decode_ext_data, encode_ext_data, short_id, X2C_RATE,
)
from coreth_tpu_torch.atomic.shared_memory import Memory, SharedMemory
from coreth_tpu_torch.atomic.trie import AtomicTrie
from coreth_tpu_torch.atomic.backend import (
    AtomicBackend, ChainContext, make_callbacks,
)

__all__ = [
    "AtomicBackend", "AtomicTrie", "EVMInput", "EVMOutput", "Memory",
    "SharedMemory", "TransferableInput", "TransferableOutput", "Tx",
    "UnsignedExportTx", "UnsignedImportTx", "UTXO",
    "calculate_dynamic_fee", "make_callbacks", "X2C_RATE",
    "ChainContext", "decode_ext_data", "encode_ext_data", "short_id",
]
