"""Block processor.

Twin of reference core/state_processor.go: Process (:71) iterates txs
sequentially, applies precompile (de)activations (ApplyUpgrades :222),
finalizes via the consensus engine (atomic-tx ExtData hook).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from coreth_tpu_torch.evm import EVM, BlockContext, TxContext, Config
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.processor.message import Message, tx_to_message
from coreth_tpu_torch.processor.state_transition import (
    GasPool, apply_message,
)
from coreth_tpu_torch.types import (
    Block, Receipt, Transaction, LatestSigner, create_bloom,
)
from coreth_tpu_torch.types.receipt import (
    RECEIPT_STATUS_FAILED, RECEIPT_STATUS_SUCCESSFUL,
)


def new_block_context(header, get_hash=None,
                      predicate_results=None) -> BlockContext:
    """NewEVMBlockContext (core/evm.go)."""
    return BlockContext(
        coinbase=header.coinbase,
        gas_limit=header.gas_limit,
        number=header.number,
        time=header.time,
        difficulty=header.difficulty,
        base_fee=header.base_fee,
        get_hash=get_hash or (lambda n: b"\x00" * 32),
        predicate_results=predicate_results,
    )


def apply_transaction(msg: Message, gp: GasPool, statedb, block_number: int,
                      block_hash: bytes, tx: Transaction, used_gas: List[int],
                      evm: EVM) -> Receipt:
    """applyTransaction (state_processor.go:116)."""
    evm.reset(TxContext(origin=msg.from_, gas_price=msg.gas_price), statedb)
    result = apply_message(evm, msg, gp)  # ConsensusError propagates
    # post-Byzantium (always on Avalanche): per-tx Finalise, no root
    statedb.finalise(True)
    used_gas[0] += result.used_gas
    receipt = Receipt(
        tx_type=tx.tx_type,
        status=(RECEIPT_STATUS_FAILED if result.failed
                else RECEIPT_STATUS_SUCCESSFUL),
        cumulative_gas_used=used_gas[0],
        tx_hash=tx.hash(),
        gas_used=result.used_gas,
        effective_gas_price=msg.gas_price,
        block_hash=block_hash,
        block_number=block_number,
    )
    if msg.to is None:
        receipt.contract_address = evm.create_address(msg.from_, tx.nonce)
    receipt.logs = statedb.tx_logs()
    for log in receipt.logs:
        log.block_hash = block_hash
        log.block_number = block_number
    return receipt


class Processor:
    """StateProcessor (state_processor.go:60)."""

    def __init__(self, config: ChainConfig, engine=None,
                 get_hash: Optional[Callable[[int], bytes]] = None):
        self.config = config
        self.engine = engine
        self.get_hash = get_hash

    def process(self, block: Block, parent_header, statedb,
                vm_config: Optional[Config] = None,
                get_hash: Optional[Callable[[int], bytes]] = None
                ) -> Tuple[List[Receipt], list, int]:
        """Process (state_processor.go:71) -> (receipts, logs, used_gas).

        Raises ConsensusError (or engine errors) on an invalid block.
        """
        header = block.header
        block_hash = block.hash()
        gp = GasPool(block.gas_limit)
        used_gas = [0]
        receipts: List[Receipt] = []
        all_logs: list = []
        apply_upgrades(self.config, parent_header.time if parent_header
                       else None, block, statedb)
        # post-Durango the header Extra carries the block's predicate
        # results after the fee window (core/evm.go:60 ParseResults);
        # execution-time getVerifiedWarpMessage reads them
        predicate_results = None
        if self.config.is_durango(header.time):
            from coreth_tpu_torch.predicate import (
                PredicateResults, results_bytes_from_extra,
            )
            raw = results_bytes_from_extra(header.extra)
            if raw is not None:
                predicate_results = PredicateResults.decode(raw)
        ctx = new_block_context(header, get_hash or self.get_hash,
                                predicate_results=predicate_results)
        evm = EVM(ctx, TxContext(), statedb, self.config, vm_config)
        signer = LatestSigner(self.config.chain_id)
        for i, tx in enumerate(block.transactions):
            msg = tx_to_message(tx, signer, header.base_fee)
            statedb.set_tx_context(tx.hash(), i)
            receipt = apply_transaction(msg, gp, statedb, header.number,
                                        block_hash, tx, used_gas, evm)
            receipt.transaction_index = i
            receipts.append(receipt)
            all_logs.extend(receipt.logs)
        if self.engine is not None:
            self.engine.finalize(block, parent_header, statedb, receipts,
                                 config=self.config)
        return receipts, all_logs, used_gas[0]


def apply_upgrades(config: ChainConfig, parent_timestamp, block,
                   statedb) -> None:
    """ApplyUpgrades (state_processor.go:222): activate/deactivate
    stateful precompile modules whose activation boundary falls in
    (parent, block].  The module registry lands with the precompile
    framework; the deterministic-iteration contract is preserved here.
    """
    from coreth_tpu_torch.precompile.modules import registered_modules
    for module in registered_modules():
        # only modules whose activation boundary falls in
        # (parent, block] get their upgrade state written — inactive
        # registrations must not mutate state (state_processor.go:222)
        at = config.precompile_activation_time(module)
        if at is None:
            continue
        newly = block.time >= at and (parent_timestamp is None
                                      or parent_timestamp < at)
        if newly:
            module.apply_upgrade(config, parent_timestamp, block, statedb)
