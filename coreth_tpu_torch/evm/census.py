"""Shared opcode census for bytecode eligibility decisions.

Port of reference ``evm/census.py``, cut to the census itself: ONE
walker (PUSH-data-skipping, the core/vm/analysis.go codeBitmap walk)
feeds both the device classifier (``evm/device/tables.scan_code``) and
the native host session's eligibility check
(``evm/hostexec/eligibility``), so the two see the same opcode set for
a given bytecode.
"""

from __future__ import annotations

from typing import Dict, Iterator


def iter_ops(code: bytes) -> Iterator[int]:
    """Yield executed-position opcodes, skipping PUSH immediates."""
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        yield op
        i += op - 0x5F + 1 if 0x60 <= op <= 0x7F else 1


_CENSUS_CACHE: Dict[bytes, Dict[int, int]] = {}


def opcode_census(code: bytes) -> Dict[int, int]:
    """Opcode -> occurrence count over the executed positions of
    `code` (memoized by the bytecode itself)."""
    cached = _CENSUS_CACHE.get(code)
    if cached is not None:
        return cached
    counts: Dict[int, int] = {}
    for op in iter_ops(code):
        counts[op] = counts.get(op, 0) + 1
    _CENSUS_CACHE[code] = counts
    return counts
