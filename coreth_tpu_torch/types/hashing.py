"""derive_sha — tx/receipt/withdrawal root derivation.

Twin of reference core/types/hashing.go:97 DeriveSha: item i is inserted
at key rlp(i) with its consensus encoding as the value; the root of the
resulting trie is the header's TxHash / ReceiptHash.
"""

from __future__ import annotations

from typing import Sequence

from coreth_tpu_torch import rlp


def _encode_item(item) -> bytes:
    return (item.encode_consensus() if hasattr(item, "encode_consensus")
            else item.encode())


def derive_sha(items: Sequence, trie) -> bytes:
    """Root over items exposing ``.encode()`` or ``.encode_consensus()``.

    ``trie`` is an empty trie-hasher exposing ``update``/``hash`` —
    the explicit-hasher shape of reference DeriveSha(list, hasher)
    (core/types/hashing.go:97), which keeps ``types`` below ``mpt``.
    Callers pass ``mpt.native_trie.derive_hasher()``.

    Inserts in ascending RLP-key order — rlp(1..0x7f) sort below
    rlp(0) = 0x80 which sorts below rlp(0x80...) — the same iteration
    order as reference core/types/hashing.go:87-110."""
    n = len(items)
    for i in range(1, min(n, 0x80)):
        trie.update(rlp.encode(rlp.encode_uint(i)), _encode_item(items[i]))
    if n > 0:
        trie.update(rlp.encode(rlp.encode_uint(0)), _encode_item(items[0]))
    for i in range(0x80, n):
        trie.update(rlp.encode(rlp.encode_uint(i)), _encode_item(items[i]))
    return trie.hash()
