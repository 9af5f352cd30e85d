"""Bytecode analysis from the reference interpreter.

Port of reference ``evm/interpreter.py``, cut to ``analyze_jumpdests``:
the port executes contract code on the device step machine and on the
native host session, never on a Python interpreter.
"""

from __future__ import annotations


def analyze_jumpdests(code: bytes) -> set:
    """Positions of JUMPDEST bytes not inside PUSH data
    (reference core/vm/analysis.go codeBitmap)."""
    dests = set()
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        if op == 0x5B:
            dests.add(i)
            i += 1
        elif 0x60 <= op <= 0x7F:
            i += op - 0x5F + 1
        else:
            i += 1
    return dests
