"""Atomic backend: verified-but-unaccepted atomic state + accept-time
shared-memory application.

Port of reference ``atomic/backend.py`` without its durable markers
(the committed-root metadata and the shared-memory apply cursor, which
only the reference's VM restart reads).

Twin of reference plugin/evm/atomic_backend.go (:28 AtomicBackend,
:420 InsertTxs, :252 ApplyToSharedMemory) and atomic_state.go: every
verified block's atomic operations are tracked per block hash; Accept
writes them into the height-indexed AtomicTrie and applies them to
SharedMemory; Reject discards them.

make_callbacks() wires the ConsensusCallbacks the dummy engine invokes
during block processing (vm.go:986 onExtraStateChange): decode ExtData,
semantic-verify, EVMStateTransfer each atomic tx, and return the block
fee contribution + atomic gas used.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from coreth_tpu_torch.atomic.shared_memory import (
    Element, Requests, SharedMemory,
)
from coreth_tpu_torch.atomic.trie import AtomicTrie
from coreth_tpu_torch.atomic.tx import (
    AtomicTxError, Tx, UnsignedImportTx, UTXO, decode_ext_data,
    encode_ext_data,
)
from coreth_tpu_torch.consensus.engine import ConsensusCallbacks


@dataclass
class ChainContext:
    """snow.Context twin: identity of this chain + the AVAX asset."""
    network_id: int = 1
    chain_id: bytes = b"\x11" * 32          # this blockchain's id
    avax_asset_id: bytes = b"\x41" * 32
    x_chain_id: bytes = b"\x58" * 32


def tx_requests(tx: Tx) -> Dict[bytes, Requests]:
    """One tx's shared-memory effect keyed by peer chain."""
    chain, puts, removes = tx.unsigned.atomic_ops(tx.id())
    req = Requests()
    req.remove_requests = list(removes)
    req.put_requests = [Element(k, v, traits) for k, v, traits in puts]
    return {chain: req}


def merge_requests(base: Dict[bytes, Requests],
                   extra: Dict[bytes, Requests]) -> None:
    for chain, req in extra.items():
        dst = base.setdefault(chain, Requests())
        dst.remove_requests.extend(req.remove_requests)
        dst.put_requests.extend(req.put_requests)


@dataclass
class _PendingBlock:
    """One verified-but-undecided block's atomic effect."""
    height: int
    requests: Dict[bytes, Requests]
    parent_hash: bytes
    inputs: frozenset


class AtomicBackend:
    def __init__(self, ctx: ChainContext, shared_memory: SharedMemory,
                 trie: Optional[AtomicTrie] = None):
        self.ctx = ctx
        self.shared_memory = shared_memory
        self.trie = trie or AtomicTrie()
        # blockHash -> effect of verified, undecided blocks
        self._pending: Dict[bytes, _PendingBlock] = {}

    # -------------------------------------------------------------- verify
    def semantic_verify(self, tx: Tx, base_fee: Optional[int],
                        rules) -> None:
        """SemanticVerify (import_tx.go:250 / export_tx.go:240 shape):
        structural checks, fee burn, unique inputs, and signature
        ownership — UTXO owners for imports, ETH-address signers for
        export EVM inputs."""
        tx.unsigned.verify(self.ctx)
        inputs = tx.unsigned.input_utxos()
        if len(set(inputs)) != len(inputs):
            raise AtomicTxError("duplicate input")
        if rules.is_apricot_phase3 and base_fee is not None:
            fixed_fee = rules.is_apricot_phase5
            tx.block_fee_contribution(fixed_fee, self.ctx.avax_asset_id,
                                      base_fee)
        if isinstance(tx.unsigned, UnsignedImportTx):
            signers = tx.recover_signers()
            if len(signers) != len(tx.unsigned.imported_inputs):
                raise AtomicTxError("credential count mismatch")
            keys = [i.input_id() for i in tx.unsigned.imported_inputs]
            try:
                utxo_bytes = self.shared_memory.get(
                    tx.unsigned.source_chain, keys)
            except KeyError as e:
                raise AtomicTxError(
                    f"missing UTXO {e.args[0]}") from None
            for inp, raw, sigs in zip(tx.unsigned.imported_inputs,
                                      utxo_bytes, signers):
                utxo = UTXO.decode(raw)
                if utxo.out.asset_id != inp.asset_id:
                    raise AtomicTxError("asset mismatch")
                if utxo.out.amount != inp.amount:
                    raise AtomicTxError("amount mismatch")
                # secp256k1fx VerifyTransfer: spendable only when the
                # locktime has no hold and exactly threshold sigs sign
                if utxo.out.locktime != 0:
                    raise AtomicTxError("UTXO is locktimed")
                if len(inp.sig_indices) != utxo.out.threshold:
                    raise AtomicTxError(
                        "signature indices != UTXO threshold")
                if len(sigs) != len(inp.sig_indices):
                    raise AtomicTxError("signature count mismatch")
                for sig_idx, addr in zip(inp.sig_indices, sigs):
                    if sig_idx >= len(utxo.out.addrs) \
                            or utxo.out.addrs[sig_idx] != addr:
                        raise AtomicTxError("utxo not owned by signer")
        else:
            # export: one credential per EVM input, whose recovered
            # pubkey's ETH address must equal the debited address
            # (export_tx.go SemanticVerify PublicKeyToEthAddress check)
            eth_signers = tx.recover_eth_signers()
            ins = tx.unsigned.ins
            if len(eth_signers) != len(ins):
                raise AtomicTxError("credential count mismatch")
            for inp, addrs in zip(ins, eth_signers):
                if len(addrs) != 1 or addrs[0] != inp.address:
                    raise AtomicTxError(
                        "export input not signed by its address")

    # ------------------------------------------------------------- conflicts
    def check_ancestor_conflicts(self, parent_hash: bytes,
                                 inputs) -> None:
        """Reject inputs already consumed by a verified-but-unaccepted
        ancestor (vm.go:1482 conflicts() walks processing ancestors).
        Without this, two consecutive processing blocks could each
        import the same UTXO: semantic_verify reads SharedMemory, which
        reflects only *accepted* state, so both would verify — and both
        Accepts would credit the EVM balance twice."""
        inputs = frozenset(inputs)
        if not inputs:
            return
        cursor = parent_hash
        while cursor in self._pending:
            anc = self._pending[cursor]
            clash = inputs & anc.inputs
            if clash:
                raise AtomicTxError(
                    "input conflicts with processing ancestor: "
                    + next(iter(clash)).hex())
            cursor = anc.parent_hash

    # ------------------------------------------------------------- lifecycle
    def insert_txs(self, block_hash: bytes, height: int,
                   txs: List[Tx], parent_hash: bytes) -> None:
        """Track a verified block's atomic effect (backend :420)."""
        requests: Dict[bytes, Requests] = {}
        inputs = set()
        for tx in txs:
            merge_requests(requests, tx_requests(tx))
            inputs.update(tx.unsigned.input_utxos())
        self._pending[block_hash] = _PendingBlock(
            height, requests, parent_hash, frozenset(inputs))

    def accept(self, block_hash: bytes, height: int = None) -> bytes:
        """Accept: index in the atomic trie + apply to shared memory
        (block.go:177 Accept -> atomicState.Accept).  Runs the trie
        commit policy for EVERY accepted height — commit boundaries
        must advance even through blocks with no atomic ops
        (atomic_trie.go AcceptTrie is called per accept)."""
        pend = self._pending.get(block_hash)
        if pend is None:
            if height is not None:
                self.trie.accept_trie(height)
            return self.trie.root()
        # validate the shared-memory effect BEFORE mutating anything so
        # a double-spend caught by the backstop leaves trie + pending
        # map + shared memory all consistent
        self.shared_memory.validate_removes(pend.requests)
        del self._pending[block_hash]
        self.trie.update_trie(pend.height, pend.requests)
        self.trie.accept_trie(pend.height)
        self.shared_memory.apply(pend.requests)
        return self.trie.root()

    def reject(self, block_hash: bytes) -> None:
        self._pending.pop(block_hash, None)


def make_callbacks(backend: AtomicBackend, config,
                   pending_atomic_txs=None) -> ConsensusCallbacks:
    """ConsensusCallbacks wired to the atomic backend:

    - onExtraStateChange (vm.go:986): during block processing, decode
      ExtData, semantic-verify and apply EVMStateTransfer for each
      atomic tx, returning (block fee contribution wei, atomic gas)
    - onFinalizeAndAssemble (vm.go:979): at build time, pull atomic txs
      from `pending_atomic_txs()` (the mempool seam), apply them to the
      assembly state, and pack them as the block's ExtData
    """
    ctx = backend.ctx

    def _apply_txs(txs, base_fee, number, time, statedb, parent_hash):
        rules = config.rules(number, time)
        contribution = 0
        gas_used = 0
        seen_inputs = set()  # vm.verifyTxs: no UTXO spent twice per block
        for tx in txs:
            for inp in tx.unsigned.input_utxos():
                if inp in seen_inputs:
                    raise AtomicTxError("conflicting atomic inputs")
                seen_inputs.add(inp)
            backend.semantic_verify(tx, base_fee, rules)
        # and none spent by a verified-but-unaccepted ancestor either
        backend.check_ancestor_conflicts(parent_hash, seen_inputs)
        for tx in txs:
            if rules.is_apricot_phase4:
                c, g = tx.block_fee_contribution(
                    rules.is_apricot_phase5, ctx.avax_asset_id, base_fee)
                contribution += c
                gas_used += g
            tx.unsigned.evm_state_transfer(ctx, statedb)
        if rules.is_apricot_phase4:
            return contribution, gas_used
        return None, None

    def on_extra_state_change(block, statedb):
        txs = decode_ext_data(block.ext_data())
        if not txs:
            return None, None
        contribution, gas_used = _apply_txs(
            txs, block.base_fee, block.number, block.time, statedb,
            block.parent_hash)
        backend.insert_txs(block.hash(), block.number, txs,
                           parent_hash=block.parent_hash)
        return contribution, gas_used

    def on_finalize_and_assemble(header, statedb, txs):
        atxs = pending_atomic_txs() if pending_atomic_txs else []
        if not atxs:
            return b"", None, None
        contribution, gas_used = _apply_txs(
            atxs, header.base_fee, header.number, header.time, statedb,
            header.parent_hash)
        return encode_ext_data(atxs), contribution, gas_used

    return ConsensusCallbacks(
        on_extra_state_change=on_extra_state_change,
        on_finalize_and_assemble=on_finalize_and_assemble)
