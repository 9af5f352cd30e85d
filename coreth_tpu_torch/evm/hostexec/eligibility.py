"""Native-backend opcode coverage and per-fork dispatch tables.

Port of reference ``evm/hostexec/eligibility.py`` (copied): the
compiled interpreter (native/evm.cc run_frame) executes a fixed opcode
set; everything else a fork DEFINES makes the native call return HOST.
Built on the same census walker as the device classifier
(``evm/census.py``), so the two backends read bytecode the same way.
"""

from __future__ import annotations

from typing import Dict, Tuple

from coreth_tpu_torch.evm import forks
from coreth_tpu_torch.evm.census import opcode_census
from coreth_tpu_torch.evm.device.tables import FORKS, op_tables

# Opcodes compiled into native/evm.cc's run_frame that every supported
# fork defines (in lockstep with build_replay_optable there).
NATIVE_BASE = frozenset(
    list(range(0x00, 0x0C))        # STOP..SIGNEXTEND
    + list(range(0x10, 0x1E))      # LT..SAR
    + [0x20]                       # KECCAK256
    + [0x30, 0x32, 0x33, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A]
    + [0x3D, 0x3E]                 # RETURNDATASIZE RETURNDATACOPY
    + [0x41, 0x42, 0x43, 0x44, 0x45, 0x46]  # COINBASE..CHAINID
    + list(range(0x50, 0x5C))      # POP..JUMPDEST
    + list(range(0x60, 0xA5))      # PUSHn DUPn SWAPn LOGn
    + [0xF1, 0xF3, 0xFA, 0xFD, 0xFE]  # CALL RETURN STATICCALL REVERT INVALID
)

# Fork-introduced opcodes the compiled engine implements; the lattice
# decides which are live per fork.
NATIVE_GATED = frozenset({0x48, 0x5F})         # BASEFEE PUSH0

_FORK_EXTRA = {f: forks.extra_for(f, NATIVE_GATED)
               for f in forks.SUPPORTED}

REFUND_FORKS = forks.REFUND_FORKS
COINBASE_WARM_FORKS = forks.COINBASE_WARM_FORKS


def native_opcodes(fork: str) -> frozenset:
    return NATIVE_BASE | _FORK_EXTRA.get(fork, frozenset())


_OPTABLE_CACHE: Dict[str, bytes] = {}


def native_optable(fork: str) -> bytes:
    """256-entry dispatch classification for the C++ session
    (0 undefined -> INVALID, 1 native, 2 defined but host-only)."""
    cached = _OPTABLE_CACHE.get(fork)
    if cached is not None:
        return cached
    if fork not in FORKS:
        raise ValueError(f"unsupported native fork {fork!r}")
    defined = op_tables(fork).supported  # nonzero == defined per fork
    native = native_opcodes(fork)
    table = bytearray(256)
    for op in range(256):
        if defined[op] == 0:
            table[op] = 0
        elif op in native:
            table[op] = 1
        else:
            table[op] = 2
    out = bytes(table)
    _OPTABLE_CACHE[fork] = out
    return out


def native_eligible(code: bytes, fork: str,
                    code_cap: int = 24576) -> Tuple[bool, str]:
    """Static scan: can the native engine attempt this bytecode under
    `fork`?  (bool, reason).  Undefined opcodes stay eligible (INVALID
    at runtime); defined-but-uncompiled ones would HOST-escape."""
    if fork not in FORKS:
        return False, f"unsupported fork {fork!r}"
    if len(code) > code_cap:
        return False, "code too large"
    table = native_optable(fork)
    for op in sorted(opcode_census(code)):
        if table[op] == 2:
            return False, f"host-only opcode 0x{op:02x}"
    return True, ""
