"""StateAccount — the consensus account representation stored in the trie.

Twin of reference core/types/state_account.go:39-45.  The coreth-specific
``is_multi_coin`` flag is part of the RLP encoding and therefore part of
the state root — omitting it would diverge from every coreth state root.
"""

from __future__ import annotations

from dataclasses import dataclass

from coreth_tpu_torch import rlp

# keccak256 of empty input — the code hash of an account with no code.
# Written out, not computed: hashing at import would build the native
# library as a side effect of importing the types.
EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
# Root hash of an empty Merkle-Patricia trie = keccak256(rlp(b"")).
EMPTY_ROOT_HASH = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")


@dataclass
class StateAccount:
    nonce: int = 0
    balance: int = 0
    root: bytes = EMPTY_ROOT_HASH
    code_hash: bytes = EMPTY_CODE_HASH
    is_multi_coin: bool = False

    def rlp(self) -> bytes:
        return rlp.encode([
            rlp.encode_uint(self.nonce),
            rlp.encode_uint(self.balance),
            self.root,
            self.code_hash,
            rlp.encode_uint(1 if self.is_multi_coin else 0),
        ])

    @classmethod
    def from_rlp(cls, data: bytes) -> "StateAccount":
        items = rlp.decode(data)
        if not isinstance(items, list) or len(items) != 5:
            raise ValueError("malformed account RLP")
        return cls(
            nonce=rlp.decode_uint(items[0]),
            balance=rlp.decode_uint(items[1]),
            root=items[2],
            code_hash=items[3],
            is_multi_coin=bool(rlp.decode_uint(items[4])),
        )

    def copy(self) -> "StateAccount":
        return StateAccount(self.nonce, self.balance, self.root,
                            self.code_hash, self.is_multi_coin)
