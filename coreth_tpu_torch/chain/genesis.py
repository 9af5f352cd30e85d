"""Genesis specification -> genesis block + initial state.

A cut of reference core/genesis.go (ToBlock :246) to funded accounts:
the genesis state goes straight into a ``NativeSecureTrie``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from coreth_tpu_torch.mpt import NativeSecureTrie
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.types import Block, Header, StateAccount


@dataclass
class GenesisAccount:
    balance: int = 0
    nonce: int = 0


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

    def to_block(self, trie: Optional[NativeSecureTrie] = None) -> Block:
        """ToBlock: writes the genesis state into ``trie`` (a fresh one
        when None) and returns the genesis block.  Every alloc entry is
        written, empty ones included (genesis commits without EIP-158
        deletion)."""
        trie = trie if trie is not None else NativeSecureTrie()
        for addr, account in self.alloc.items():
            trie.update(addr, StateAccount(nonce=account.nonce,
                                           balance=account.balance).rlp())
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
