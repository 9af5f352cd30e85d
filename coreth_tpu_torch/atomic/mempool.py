"""Atomic-transaction mempool.

Port of reference ``atomic/mempool.py``.

Twin of reference plugin/evm/mempool.go (:57 Mempool, :173 AddTx, :223
checkConflictTx, :387 NextTx) + tx_heap.go: pending atomic txs ordered
by gas price (burned AVAX per gas), per-UTXO conflict tracking (a
higher-paying conflict evicts the lower), and the issued/pending
lifecycle the block builder drives.
"""

from __future__ import annotations

import heapq
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from coreth_tpu_torch.atomic.tx import Tx

DEFAULT_MEMPOOL_SIZE = 4096


class MempoolError(Exception):
    pass


class AtomicMempool:
    def __init__(self, ctx, max_size: int = DEFAULT_MEMPOOL_SIZE,
                 verify=None):
        """verify(tx) raises to reject (the backend.semantic_verify
        seam; None accepts everything — tests)."""
        self.ctx = ctx
        self.max_size = max_size
        self.verify = verify
        self._txs: Dict[bytes, Tx] = {}
        self._price: Dict[bytes, Fraction] = {}
        self._heap: List[Tuple[Fraction, bytes]] = []  # (-price, id)
        self._utxo_spenders: Dict[bytes, bytes] = {}  # input -> tx id
        self._issued: Set[bytes] = set()

    # -------------------------------------------------------------- sizing
    def pending_len(self) -> int:
        return len(self._txs) - len(self._issued)

    def __len__(self) -> int:
        return len(self._txs)

    def has(self, tx_id: bytes) -> bool:
        return tx_id in self._txs

    def get(self, tx_id: bytes) -> Optional[Tx]:
        return self._txs.get(tx_id)

    # ----------------------------------------------------------------- add
    def _gas_price(self, tx: Tx) -> Fraction:
        """Burned AVAX per gas as an EXACT rational (integer
        arithmetic): float division here could order two txs whose
        true fee ratios differ below 2^-53 relative precision
        inconsistently across hosts — the fee-ordering determinism gap
        ROADMAP flagged.  Fraction keeps comparisons exact while
        staying heap- and negate-compatible."""
        gas = tx.unsigned.gas_used(True, len(tx.encode()))
        burned = tx.unsigned.burned(self.ctx.avax_asset_id)
        return Fraction(burned, max(gas, 1))

    def add_tx(self, tx: Tx) -> None:
        """AddTx (:173): verify, resolve UTXO conflicts by price, cap
        the pool by evicting the cheapest."""
        tx_id = tx.id()
        if tx_id in self._txs:
            raise MempoolError("tx already known")
        if self.verify is not None:
            self.verify(tx)
        price = self._gas_price(tx)
        # conflict check (:223): any input already claimed?
        conflicts = []
        for inp in tx.unsigned.input_utxos():
            owner = self._utxo_spenders.get(inp)
            if owner is not None and owner != tx_id:
                conflicts.append(owner)
        for owner in sorted(set(conflicts)):
            if owner in self._issued:
                raise MempoolError("conflicts with an issued tx")
            if self._price[owner] >= price:
                raise MempoolError("conflicting tx with higher fee known")
        for owner in sorted(set(conflicts)):
            self._remove(owner)
        if len(self._txs) >= self.max_size:
            self._evict_cheapest(floor=price)
        self._txs[tx_id] = tx
        self._price[tx_id] = price
        heapq.heappush(self._heap, (-price, tx_id))
        for inp in tx.unsigned.input_utxos():
            self._utxo_spenders[inp] = tx_id

    def _evict_cheapest(self, floor: Fraction) -> None:
        victim = None
        worst = floor
        for tx_id, p in self._price.items():
            if tx_id in self._issued:
                continue
            if p < worst:
                worst = p
                victim = tx_id
        if victim is None:
            raise MempoolError("mempool full of better-paying txs")
        self._remove(victim)

    def _remove(self, tx_id: bytes) -> None:
        tx = self._txs.pop(tx_id, None)
        self._price.pop(tx_id, None)
        self._issued.discard(tx_id)
        if tx is not None:
            for inp in tx.unsigned.input_utxos():
                if self._utxo_spenders.get(inp) == tx_id:
                    del self._utxo_spenders[inp]

    # ------------------------------------------------------------ building
    def next_tx(self) -> Optional[Tx]:
        """Highest-price pending tx, marked issued (NextTx :387)."""
        while self._heap:
            _negp, tx_id = self._heap[0]
            if tx_id not in self._txs or tx_id in self._issued:
                heapq.heappop(self._heap)
                continue
            self._issued.add(tx_id)
            return self._txs[tx_id]
        return None

    def discard_current_tx(self, tx_id: bytes) -> None:
        """The issued tx failed verification at build time: drop it."""
        self._remove(tx_id)

    def cancel_current_tx(self, tx_id: bytes) -> None:
        """Issued but the block was not built: back to pending."""
        if tx_id in self._txs:
            self._issued.discard(tx_id)
            heapq.heappush(self._heap,
                           (-self._price[tx_id], tx_id))

    def remove_accepted(self, tx_ids: List[bytes]) -> None:
        """Accepted block included these txs (IssuedTxs cleanup)."""
        for tx_id in tx_ids:
            self._remove(tx_id)

    def remove_conflicts(self, inputs) -> int:
        """Drop every resident tx spending any of `inputs` — an
        accepted foreign block consumed those UTXOs, so local spenders
        can never be valid again (reference mempool RemoveTx on
        accepted-block conflicts).  Returns the count removed."""
        victims = set()
        for inp in inputs:
            owner = self._utxo_spenders.get(inp)
            if owner is not None:
                victims.add(owner)
        for tx_id in victims:
            self._remove(tx_id)
        return len(victims)
