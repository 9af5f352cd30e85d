"""Host-side opcode tables and code eligibility scanning.

Port of reference ``evm/device/tables.py`` (copied).  The step
machine's dispatch tables are DERIVED from the jump tables
(``evm/jump_table.py``) so constant gas and stack arity cannot diverge
from the host side.  ``scan_code`` decides device eligibility per
runtime bytecode and extracts the static feature set of the heavy op
families the batch's code can reach.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np

from coreth_tpu_torch.evm import forks
from coreth_tpu_torch.evm import jump_table as JT
from coreth_tpu_torch.evm.census import opcode_census
from coreth_tpu_torch.evm.interpreter import analyze_jumpdests
from coreth_tpu_torch.params import protocol as P

# Fork keys the device machine supports: EIP-2929 warm/cold present
# (AP2+); AP2 keeps refunds disabled, AP3+ re-enables the reduced
# EIP-3529 schedule.  Ordering and per-fork opcode gating come from the
# lattice module (evm/forks.py).
FORKS = forks.SUPPORTED

_TABLE_FOR_FORK = {
    "ap2": JT.new_ap2_table,
    "ap3": JT.new_ap3_table,
    "durango": JT.new_durango_table,
    "cancun": JT.new_cancun_table,
}

# Opcodes the device executes.  Everything else that is defined in the
# fork's jump table routes the tx to the host path (supported == 2).
_ALWAYS = set()
_ALWAYS |= {0x00, 0x01, 0x03}                      # STOP ADD SUB
_ALWAYS |= set(range(0x10, 0x1B))                  # LT..BYTE
_ALWAYS |= {0x33, 0x34, 0x35, 0x36, 0x38, 0x3A}    # CALLER..GASPRICE
_ALWAYS |= {0x30, 0x32}                            # ADDRESS ORIGIN
_ALWAYS |= {0x41, 0x42, 0x43, 0x44, 0x45, 0x46}    # COINBASE..CHAINID
_ALWAYS |= {0x50, 0x51, 0x52, 0x53, 0x56, 0x57,
            0x58, 0x59, 0x5A, 0x5B}                # POP..JUMPDEST
_ALWAYS |= set(range(0x60, 0xA0))                  # PUSH1-32 DUP SWAP
_ALWAYS |= set(range(0xA0, 0xA5))                  # LOG0-4
_ALWAYS |= {0xF3, 0xFD, 0xFE}                      # RETURN REVERT INVALID

# feature-gated heavy families: opcode -> feature name
FEATURE_OPS: Dict[int, str] = {
    0x02: "mul", 0x04: "div", 0x05: "div", 0x06: "div", 0x07: "div",
    0x08: "addmod", 0x09: "mulmod", 0x0A: "exp", 0x0B: "shift",
    0x1B: "shift", 0x1C: "shift", 0x1D: "shift", 0x1A: "shift",
    0x20: "keccak",
    0x37: "copy", 0x39: "copy", 0x5E: "copy",
    0x54: "storage", 0x55: "storage",
    0x5C: "tstorage", 0x5D: "tstorage",
    0xA0: "log", 0xA1: "log", 0xA2: "log", 0xA3: "log", 0xA4: "log",
}

# Fork-introduced opcodes the device machine implements beyond the
# always/feature pools (BASEFEE, PUSH0; TLOAD/TSTORE/MCOPY already sit
# in FEATURE_OPS).  forks.gate drops whatever a fork does not define
# yet, so no per-fork subtraction lists can drift.
DEVICE_GATED = frozenset({0x48, 0x5F})


def device_opcodes(fork: str) -> set:
    return set(forks.gate(fork,
                          set(_ALWAYS) | set(FEATURE_OPS) | DEVICE_GATED))


@dataclass(frozen=True)
class OpTables:
    """Numpy (256,) tables fed to the device as constants."""
    const_gas: np.ndarray
    nin: np.ndarray
    nout: np.ndarray
    supported: np.ndarray  # 0 undefined, 1 device, 2 host-only


_TABLES_CACHE: Dict[str, OpTables] = {}


def op_tables(fork: str) -> OpTables:
    cached = _TABLES_CACHE.get(fork)
    if cached is not None:
        return cached
    table = _TABLE_FOR_FORK[fork]()
    dev = device_opcodes(fork)
    const_gas = np.zeros(256, dtype=np.int32)
    nin = np.zeros(256, dtype=np.int32)
    nout = np.zeros(256, dtype=np.int32)
    supported = np.zeros(256, dtype=np.int32)
    for op in range(256):
        entry = table[op]
        if entry is None:
            continue
        const_gas[op] = entry.constant_gas
        nin[op] = entry.min_stack
        pushes = entry.min_stack + int(P.STACK_LIMIT) - entry.max_stack
        nout[op] = pushes
        supported[op] = 1 if op in dev else 2
    out = OpTables(const_gas, nin, nout, supported)
    _TABLES_CACHE[fork] = out
    return out


@dataclass(frozen=True)
class CodeInfo:
    """Result of scanning one runtime bytecode for device eligibility."""
    eligible: bool
    features: FrozenSet[str]
    jumpdests: Tuple[int, ...]
    reason: str = ""


_SCAN_CACHE: Dict[Tuple[bytes, str], CodeInfo] = {}


def scan_code(code: bytes, fork: str,
              code_cap: int = 24576) -> CodeInfo:
    """Static scan: is this bytecode entirely device-executable under
    `fork`, and which heavy op families does it use?

    Walks the code exactly like the jumpdest analysis (PUSH data is
    skipped, reference core/vm/analysis.go) so data bytes never
    disqualify code.  Undefined opcodes do NOT disqualify: reaching one
    is a plain INVALID-style error the machine handles.  Memoized by
    the bytecode itself: the runner consults this per lane.
    """
    key = (code, fork)
    cached = _SCAN_CACHE.get(key)
    if cached is not None:
        return cached
    if len(code) > code_cap:
        info = CodeInfo(False, frozenset(), (), "code too large")
        _SCAN_CACHE[key] = info
        return info
    supported = op_tables(fork).supported  # 0 = undefined per fork
    feats = set()
    info = None
    for op in sorted(opcode_census(code)):
        if supported[op] == 0:
            continue  # undefined: INVALID at runtime, device handles
        if supported[op] == 2:
            info = CodeInfo(False, frozenset(), (),
                            f"host-only opcode 0x{op:02x}")
            break
        feat = FEATURE_OPS.get(op)
        if feat is not None:
            feats.add(feat)
    if info is None:
        dests = tuple(sorted(analyze_jumpdests(code)))
        info = CodeInfo(True, frozenset(feats), dests)
    _SCAN_CACHE[key] = info
    return info


def fork_key(rules) -> Optional[str]:
    """Map a Rules object to the device fork key (None = unsupported:
    pre-AP2 has no EIP-2929 and live refunds the machine does not
    model)."""
    if rules.is_cancun:
        return "cancun"
    if rules.is_durango:
        return "durango"
    if rules.is_apricot_phase3:
        return "ap3"
    if rules.is_apricot_phase2:
        return "ap2"
    return None
