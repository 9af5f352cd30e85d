"""The dummy consensus engine, cut to what replay and the builder need.

Twin of reference consensus/dummy/consensus.go: the atomic-tx callbacks
(:40 ConsensusCallbacks), block-fee verification (:289), Finalize (:358,
the host execution path's end of block) and FinalizeAndAssemble (:414).
The plugin VM wires the callbacks in (``atomic.make_callbacks``):
Finalize applies a block's ExtData txs to the StateDB before the fee
check, and FinalizeAndAssemble packs the pending ones into the block it
builds.  With no callback a block's ``ext_data_gas_used`` must be 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from coreth_tpu_torch.consensus.dynamic_fees import block_gas_cost
from coreth_tpu_torch.mpt.native_trie import derive_hasher
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.types import Block, Header, create_bloom, derive_sha
from coreth_tpu_torch.types.block import calc_ext_data_hash

UINT64_MAX = (1 << 64) - 1


class ConsensusError(Exception):
    pass


@dataclass
class ConsensusCallbacks:
    """consensus.go:40: atomic-tx hooks wired in by the plugin VM."""
    # (block, statedb) -> (fee contribution, ext_data_gas_used)
    on_extra_state_change: Optional[Callable] = None
    # (header, statedb, txs) -> (extra_data, contribution, ext_gas_used)
    on_finalize_and_assemble: Optional[Callable] = None


class DummyEngine:
    def __init__(self, cb: Optional[ConsensusCallbacks] = None):
        self.cb = cb or ConsensusCallbacks()
        self._config: Optional[ChainConfig] = None

    def set_config(self, config: ChainConfig) -> None:
        """Bind the chain config ``finalize`` uses when none is passed
        (the reference reaches it through the chain reader)."""
        self._config = config

    @staticmethod
    def _block_gas_cost(config: ChainConfig, parent: Header,
                        timestamp: int) -> int:
        return block_gas_cost(config, parent, timestamp)

    def finalize(self, block: Block, parent: Header, statedb, receipts,
                 config: Optional[ChainConfig] = None) -> None:
        """Finalize (consensus.go:358): the ExtData callback applies the
        block's atomic txs to ``statedb`` first; from Apricot Phase 4 on
        the header's ext_data_gas_used must be the callback's (0 without
        one), its block_gas_cost the required one, and the block fee,
        the atomic txs' contribution included, must cover it."""
        config = config or self._config
        if config is None:
            raise ValueError("finalize needs the chain config")
        contribution = ext_data_gas_used = None
        if self.cb.on_extra_state_change is not None:
            contribution, ext_data_gas_used = self.cb.on_extra_state_change(
                block, statedb)
        if config.is_apricot_phase4(block.time):
            if ext_data_gas_used is None:
                ext_data_gas_used = 0
            if (block.header.ext_data_gas_used is None
                    or block.header.ext_data_gas_used != ext_data_gas_used):
                raise ConsensusError(
                    f"invalid extDataGasUsed: have "
                    f"{block.header.ext_data_gas_used}, "
                    f"want {ext_data_gas_used}")
            expected_cost = self._block_gas_cost(config, parent, block.time)
            if (block.header.block_gas_cost is None
                    or block.header.block_gas_cost != expected_cost):
                raise ConsensusError("invalid blockGasCost")
            self.verify_block_fee(block.base_fee,
                                  block.header.block_gas_cost,
                                  block.transactions, receipts, contribution)

    def verify_block_fee(self, base_fee: Optional[int],
                         required_block_gas_cost: Optional[int],
                         txs, receipts,
                         extra_contribution: Optional[int] = None) -> None:
        """verifyBlockFee (consensus.go:289)."""
        if base_fee is None or base_fee <= 0:
            raise ConsensusError(f"invalid base fee {base_fee}")
        if (required_block_gas_cost is None
                or required_block_gas_cost > UINT64_MAX):
            raise ConsensusError("invalid block gas cost")
        total_block_fee = 0
        if extra_contribution is not None:
            if extra_contribution < 0:
                raise ConsensusError("negative extra contribution")
            total_block_fee += extra_contribution
        for tx, receipt in zip(txs, receipts):
            premium = tx.effective_gas_tip(base_fee)
            if premium < 0:
                raise ConsensusError("negative effective tip")
            total_block_fee += premium * receipt.gas_used
        block_gas = total_block_fee // base_fee
        if block_gas < required_block_gas_cost:
            raise ConsensusError(
                f"insufficient gas ({block_gas}) to cover block cost "
                f"({required_block_gas_cost}) at base fee ({base_fee})")

    def finalize_and_assemble(self, config: ChainConfig, header: Header,
                              parent: Header, state, txs,
                              receipts) -> Block:
        """FinalizeAndAssemble (consensus.go:414): the assemble callback
        applies the pending atomic txs to ``state`` and returns the
        block's ExtData; then the AP4 fee fields, the post-state root
        (``state.intermediate_root``, taken after the atomic txs), the
        tx/receipt roots, the bloom and the ExtData hash."""
        extra_data = b""
        contribution = ext_data_gas_used = None
        if self.cb.on_finalize_and_assemble is not None:
            extra_data, contribution, ext_data_gas_used = \
                self.cb.on_finalize_and_assemble(header, state, txs)
        if config.is_apricot_phase4(header.time):
            header.ext_data_gas_used = ext_data_gas_used or 0
            header.block_gas_cost = block_gas_cost(config, parent,
                                                   header.time)
            self.verify_block_fee(header.base_fee, header.block_gas_cost,
                                  txs, receipts, contribution)
        header.root = state.intermediate_root(
            config.is_eip158(header.number))
        header.tx_hash = derive_sha(txs, derive_hasher())
        header.receipt_hash = derive_sha(receipts, derive_hasher())
        header.bloom = create_bloom(receipts)
        if config.is_apricot_phase1(header.time):
            header.ext_data_hash = calc_ext_data_hash(extra_data)
        return Block(header, list(txs), [], version=0,
                     extdata=extra_data if extra_data else None)
