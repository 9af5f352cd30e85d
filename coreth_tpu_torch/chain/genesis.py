"""Genesis specification -> genesis block + initial state.

A cut of reference core/genesis.go (ToBlock :246) to funded accounts
and contracts: balances, nonces, runtime code and storage go straight
into a ``StateStore`` (account trie, storage tries, code store).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.state import StateStore, normalize_state_key
from coreth_tpu_torch.types import Block, Header, StateAccount


@dataclass
class GenesisAccount:
    balance: int = 0
    code: bytes = b""
    nonce: int = 0
    # 32-byte slot key -> 32-byte value
    storage: Dict[bytes, bytes] = field(default_factory=dict)


@dataclass
class Genesis:
    config: ChainConfig = field(default_factory=ChainConfig)
    alloc: Dict[bytes, GenesisAccount] = field(default_factory=dict)
    nonce: int = 0
    timestamp: int = 0
    extra_data: bytes = b""
    gas_limit: int = 0
    difficulty: int = 0
    coinbase: bytes = b"\x00" * 20
    base_fee: Optional[int] = None
    number: int = 0
    gas_used: int = 0
    parent_hash: bytes = b"\x00" * 32

    def to_block(self, state: Optional[StateStore] = None) -> Block:
        """ToBlock: writes the genesis state into ``state`` (a fresh
        store when None) and returns the genesis block.  Every alloc
        entry is written, empty ones included (genesis commits without
        EIP-158 deletion)."""
        store = state if state is not None else StateStore()
        trie = store.trie
        for addr, account in self.alloc.items():
            acct = StateAccount(nonce=account.nonce, balance=account.balance)
            if account.code or account.storage:
                acct.code_hash = store.put_code(account.code)
                for key, value in account.storage.items():
                    store.set_storage(addr, normalize_state_key(key),
                                      int.from_bytes(value, "big"))
                acct.root = store.storage_trie(addr).hash()
            trie.update(addr, acct.rlp())
        gas_limit = self.gas_limit or P.GENESIS_GAS_LIMIT
        base_fee = self.base_fee
        if self.config.is_apricot_phase3(0) and base_fee is None:
            base_fee = P.APRICOT_PHASE3_INITIAL_BASE_FEE
        header = Header(
            parent_hash=self.parent_hash,
            coinbase=self.coinbase,
            root=trie.hash(),
            number=self.number,
            gas_limit=gas_limit,
            gas_used=self.gas_used,
            time=self.timestamp,
            extra=self.extra_data,
            difficulty=self.difficulty,
            nonce=self.nonce.to_bytes(8, "big"),
            base_fee=base_fee,
        )
        return Block(header)
