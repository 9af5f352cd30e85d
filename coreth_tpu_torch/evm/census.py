"""Shared opcode census for bytecode eligibility decisions.

Port of reference ``evm/census.py``, cut to the census, the
specialiser's pre-filter and the static storage footprint: ONE walker
(PUSH-data-skipping, the core/vm/analysis.go codeBitmap walk) feeds the
device classifier (``evm/device/tables.scan_code``), the native host
session's eligibility check (``evm/hostexec/eligibility``) and the
specialiser's ``trace_precheck`` (``evm/device/specialize``), so all
three see the same opcode set for a given bytecode.
``static_storage_keys`` gives the fused OCC window's premap the
PUSH-constant slots of a contract (the swap pool's reserves).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple


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


def trace_precheck(code: bytes, allowed) -> Tuple[bool, str]:
    """Cheap static pre-filter for the per-contract specialiser
    (evm/device/specialize.py): is every EXECUTED-position opcode of
    `code` inside the specialiser's traced subset?  A rejection here
    skips the (more expensive) symbolic walk entirely; a pass only
    means the walk is worth attempting — the walk itself still rejects
    unresolvable jump structure, symbolic memory offsets, and budget
    blow-ups."""
    for op in sorted(opcode_census(code)):
        if op not in allowed:
            return False, f"untraced opcode 0x{op:02x}"
    return True, ""


_STATIC_KEYS_CACHE: Dict[bytes, Optional[Tuple[Tuple[bytes, ...],
                                               Tuple[bytes, ...]]]] = {}


def static_storage_keys(
        code: bytes) -> Optional[Tuple[Tuple[bytes, ...],
                                       Tuple[bytes, ...]]]:
    """(read_keys, write_keys) when EVERY SLOAD/SSTORE in `code` takes
    a PUSH-constant key, else None (a computed key — e.g. the keccak
    mapping slots of the token — makes the sets statically unknowable).

    Conservative by construction: keys are the *potential* footprint
    (branches may skip ops), and any non-constant key disables the
    answer entirely.  Memoized by the bytecode itself."""
    if code in _STATIC_KEYS_CACHE:
        return _STATIC_KEYS_CACHE[code]
    reads = []
    writes = []
    prev_push: Optional[bytes] = None
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        if 0x60 <= op <= 0x7F:
            size = op - 0x5F
            prev_push = bytes(code[i + 1:i + 1 + size]).rjust(32, b"\x00")
            i += size + 1
            continue
        if op == 0x5F:  # PUSH0
            prev_push = b"\x00" * 32
            i += 1
            continue
        if op in (0x54, 0x55):
            if prev_push is None:
                _STATIC_KEYS_CACHE[code] = None
                return None
            (reads if op == 0x54 else writes).append(prev_push)
        prev_push = None
        i += 1
    out = (tuple(reads), tuple(writes))
    _STATIC_KEYS_CACHE[code] = out
    return out
