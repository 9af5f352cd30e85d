"""The dummy consensus engine, cut to what replay needs.

Twin of reference consensus/dummy/consensus.go: block-fee verification
(:289), Finalize (:358, the host execution path's end of block) and the
header fields FinalizeAndAssemble (:414) fills.  Atomic ExtData
callbacks are not part of the port yet: blocks carry no extdata, so
Finalize holds ``ext_data_gas_used`` to 0, as the reference does when no
callback is wired in.
"""

from __future__ import annotations

from typing import Optional

from coreth_tpu_torch.consensus.dynamic_fees import block_gas_cost
from coreth_tpu_torch.mpt.native_trie import derive_hasher
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.types import Block, Header, create_bloom, derive_sha
from coreth_tpu_torch.types.block import calc_ext_data_hash

UINT64_MAX = (1 << 64) - 1


class ConsensusError(Exception):
    pass


class DummyEngine:
    @staticmethod
    def _block_gas_cost(config: ChainConfig, parent: Header,
                        timestamp: int) -> int:
        return block_gas_cost(config, parent, timestamp)

    def finalize(self, block: Block, parent: Header, statedb, receipts,
                 config: Optional[ChainConfig] = None) -> None:
        """Finalize (consensus.go:358) without the atomic-tx callback:
        from Apricot Phase 4 on the header's ext_data_gas_used must be
        0, its block_gas_cost the required one, and the block fee must
        cover it."""
        if config is None:
            raise ValueError("finalize needs the chain config")
        if config.is_apricot_phase4(block.time):
            if (block.header.ext_data_gas_used is None
                    or block.header.ext_data_gas_used != 0):
                raise ConsensusError(
                    f"invalid extDataGasUsed: have "
                    f"{block.header.ext_data_gas_used}, want 0")
            expected_cost = self._block_gas_cost(config, parent, block.time)
            if (block.header.block_gas_cost is None
                    or block.header.block_gas_cost != expected_cost):
                raise ConsensusError("invalid blockGasCost")
            self.verify_block_fee(block.base_fee,
                                  block.header.block_gas_cost,
                                  block.transactions, receipts)

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
                              parent: Header, root: bytes, txs,
                              receipts) -> Block:
        """FinalizeAndAssemble (consensus.go:414) for a block with no
        extdata: AP4 fee fields, the post-state ``root`` the caller
        computed, the tx/receipt roots and the bloom."""
        if config.is_apricot_phase4(header.time):
            header.ext_data_gas_used = 0
            header.block_gas_cost = block_gas_cost(config, parent,
                                                   header.time)
            self.verify_block_fee(header.base_fee, header.block_gas_cost,
                                  txs, receipts)
        header.root = root
        header.tx_hash = derive_sha(txs, derive_hasher())
        header.receipt_hash = derive_sha(receipts, derive_hasher())
        header.bloom = create_bloom(receipts)
        if config.is_apricot_phase1(header.time):
            header.ext_data_hash = calc_ext_data_hash(b"")
        return Block(header, list(txs), [], version=0)
