"""Accepted-atomic-tx repository, indexed by tx id and by height.

Port of reference ``atomic/repository.py``.

Twin of reference plugin/evm/atomic_tx_repository.go: every accepted
block's atomic txs are written under both indexes so the avax.* API
(getAtomicTx / getAtomicTxStatus) and the atomic-trie machinery can
resolve them.  Backed by a dict (bytes -> bytes).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from coreth_tpu_torch.atomic.tx import Tx
from coreth_tpu_torch.wire import Packer, Unpacker

_TX_PREFIX = b"atx"       # txID -> height(8) ++ tx bytes
_HEIGHT_PREFIX = b"ath"   # height(8) -> packed list of tx bytes


class AtomicTxRepository:
    def __init__(self, store: Optional[dict] = None):
        self.store = store if store is not None else {}

    # ---------------------------------------------------------------- write
    def write(self, height: int, txs: List[Tx]) -> None:
        """Index one accepted height's atomic txs
        (atomic_tx_repository.go Write)."""
        if not txs:
            return
        p = Packer()
        p.u32(len(txs))
        for tx in txs:
            raw = tx.encode()
            p.var_bytes(raw)
            self._put(_TX_PREFIX + tx.id(),
                      height.to_bytes(8, "big") + raw)
        self._put(_HEIGHT_PREFIX + height.to_bytes(8, "big"), p.bytes())

    def _put(self, key: bytes, value: bytes) -> None:
        self.store[key] = value

    def _get(self, key: bytes) -> Optional[bytes]:
        return self.store.get(key)

    # ----------------------------------------------------------------- read
    def get_by_tx_id(self, tx_id: bytes) -> Optional[Tuple[Tx, int]]:
        """(tx, accepted height) or None (GetByTxID)."""
        raw = self._get(_TX_PREFIX + tx_id)
        if raw is None:
            return None
        return Tx.decode(raw[8:]), int.from_bytes(raw[:8], "big")

    def get_by_height(self, height: int) -> List[Tx]:
        """Atomic txs accepted at [height] (GetByHeight)."""
        raw = self._get(_HEIGHT_PREFIX + height.to_bytes(8, "big"))
        if raw is None:
            return []
        u = Unpacker(raw)
        return [Tx.decode(u.var_bytes()) for _ in range(u.u32())]
