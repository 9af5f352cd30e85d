"""Per-block predicate results (Durango).

Port of reference ``predicate.py``, cut to what the ``Processor`` reads:
the results bytes carried after the fee window of a post-Durango
header's Extra, and their decoding into the per-tx bitsets of FAILED
predicates (reference predicate/predicate_results.go:44-84; the codec's
layout: big-endian u32 counts and lengths, 20-byte addresses).  The
port registers no predicater, so every block's results are empty.
"""

from __future__ import annotations

import struct
from typing import Dict

from coreth_tpu_torch.params import protocol as P


def results_bytes_from_extra(extra: bytes):
    """Extract the predicate-results bytes carried after the 80-byte
    dynamic-fee window in a post-Durango header Extra
    (predicate.GetPredicateResultBytes)."""
    if len(extra) <= P.DYNAMIC_FEE_EXTRA_DATA_SIZE:
        return None
    return extra[P.DYNAMIC_FEE_EXTRA_DATA_SIZE:]


class PredicateResults:
    """txIndex -> per-predicate failure bitset (results.go)."""

    def __init__(self):
        self.results: Dict[int, Dict[bytes, bytes]] = {}

    def set_result(self, tx_index: int, address: bytes,
                   bitset: bytes) -> None:
        self.results.setdefault(tx_index, {})[address] = bitset

    def get_result(self, tx_index: int, address: bytes) -> bytes:
        return self.results.get(tx_index, {}).get(address, b"")

    @classmethod
    def decode(cls, data: bytes) -> "PredicateResults":
        off = 0

        def take(n: int) -> bytes:
            nonlocal off
            if off + n > len(data):
                raise ValueError("short buffer")
            off += n
            return data[off - n:off]

        def u32() -> int:
            return struct.unpack(">I", take(4))[0]

        out = cls()
        for _ in range(u32()):
            tx_index = u32()
            for _ in range(u32()):
                addr = take(20)
                out.set_result(tx_index, addr, take(u32()))
        return out
