"""Per-fork jump tables, cut to the fields the device tables read.

Port of reference ``evm/jump_table.py`` (core/vm/jump_table.go): the
tables are composed fork over fork as the reference does, but each
entry keeps only its constant gas and stack bounds — the interpreter's
op functions and dynamic-gas callbacks stay behind (the port has no
Python interpreter).  ``None`` marks an opcode the fork does not define.
"""

from __future__ import annotations

from typing import List, Optional

from coreth_tpu_torch.params import protocol as P

QUICK, FASTEST, FAST, MID, SLOW, EXT = 2, 3, 5, 8, 10, 20


class Operation:
    __slots__ = ("constant_gas", "min_stack", "max_stack")

    def __init__(self, constant_gas: int = 0, pops: int = 0,
                 pushes: int = 0):
        self.constant_gas = constant_gas
        self.min_stack = pops
        self.max_stack = int(P.STACK_LIMIT) + pops - pushes


Table = List[Optional[Operation]]


def _ap1_table() -> Table:
    """Frontier through AP1 composed, at AP1's constant gas."""
    t: Table = [None] * 256
    for op, gas, pops, pushes in (
            (0x00, 0, 0, 0), (0x01, FASTEST, 2, 1), (0x02, FAST, 2, 1),
            (0x03, FASTEST, 2, 1), (0x04, FAST, 2, 1), (0x05, FAST, 2, 1),
            (0x06, FAST, 2, 1), (0x07, FAST, 2, 1), (0x08, MID, 3, 1),
            (0x09, MID, 3, 1), (0x0A, 0, 2, 1), (0x0B, FAST, 2, 1),
            (0x10, FASTEST, 2, 1), (0x11, FASTEST, 2, 1),
            (0x12, FASTEST, 2, 1), (0x13, FASTEST, 2, 1),
            (0x14, FASTEST, 2, 1), (0x15, FASTEST, 1, 1),
            (0x16, FASTEST, 2, 1), (0x17, FASTEST, 2, 1),
            (0x18, FASTEST, 2, 1), (0x19, FASTEST, 1, 1),
            (0x1A, FASTEST, 2, 1),
            (0x1B, FASTEST, 2, 1), (0x1C, FASTEST, 2, 1),   # Constantinople
            (0x1D, FASTEST, 2, 1),
            (0x20, P.KECCAK256_GAS, 2, 1),
            (0x30, QUICK, 0, 1), (0x31, 700, 1, 1), (0x32, QUICK, 0, 1),
            (0x33, QUICK, 0, 1), (0x34, QUICK, 0, 1),
            (0x35, FASTEST, 1, 1), (0x36, QUICK, 0, 1),
            (0x37, FASTEST, 3, 0), (0x38, QUICK, 0, 1),
            (0x39, FASTEST, 3, 0), (0x3A, QUICK, 0, 1),
            (0x3B, 700, 1, 1), (0x3C, 700, 4, 0),
            (0x3D, QUICK, 0, 1), (0x3E, FASTEST, 3, 0),     # Byzantium
            (0x3F, 700, 1, 1),                              # EIP-1884
            (0x40, EXT, 1, 1), (0x41, QUICK, 0, 1), (0x42, QUICK, 0, 1),
            (0x43, QUICK, 0, 1), (0x44, QUICK, 0, 1), (0x45, QUICK, 0, 1),
            (0x46, QUICK, 0, 1), (0x47, FAST, 0, 1),        # Istanbul
            (0x50, QUICK, 1, 0), (0x51, FASTEST, 1, 1),
            (0x52, FASTEST, 2, 0), (0x53, FASTEST, 2, 0),
            (0x54, 800, 1, 1), (0x55, 0, 2, 0), (0x56, MID, 1, 0),
            (0x57, SLOW, 2, 0), (0x58, QUICK, 0, 1), (0x59, QUICK, 0, 1),
            (0x5A, QUICK, 0, 1), (0x5B, P.JUMPDEST_GAS, 0, 0),
            (0xF0, P.CREATE_GAS, 3, 1), (0xF1, 700, 7, 1),
            (0xF2, 700, 7, 1), (0xF3, 0, 2, 0), (0xF4, 700, 6, 1),
            (0xF5, P.CREATE2_GAS, 4, 1), (0xFA, 700, 6, 1),
            (0xFD, 0, 2, 0), (0xFE, 0, 0, 0), (0xFF, 0, 1, 0),
            (0xCD, 700, 2, 1)):                             # BALANCEMC
        t[op] = Operation(gas, pops, pushes)
    for i in range(32):
        t[0x60 + i] = Operation(FASTEST, 0, 1)
    for i in range(16):
        t[0x80 + i] = Operation(FASTEST, i + 1, i + 2)
        t[0x90 + i] = Operation(FASTEST, i + 2, i + 2)
    for i in range(5):
        t[0xA0 + i] = Operation(0, i + 2, 0)
    return t


def new_ap2_table() -> Table:
    """AP2 (jump_table.go:112): EIP-2929 + multicoin opcodes disabled."""
    t = _ap1_table()
    t[0xCD] = None
    t[0x54].constant_gas = 0
    for op in (0x31, 0x3B, 0x3C, 0x3F, 0xF1, 0xF2, 0xF4, 0xFA):
        t[op].constant_gas = P.WARM_STORAGE_READ_COST_EIP2929
    t[0xFF].constant_gas = P.SELFDESTRUCT_GAS_EIP150
    return t


def new_ap3_table() -> Table:
    """AP3 (jump_table.go:103): BASEFEE (EIP-3198)."""
    t = new_ap2_table()
    t[0x48] = Operation(QUICK, 0, 1)
    return t


def new_durango_table() -> Table:
    """Durango (jump_table.go:94): PUSH0 (EIP-3855)."""
    t = new_ap3_table()
    t[0x5F] = Operation(QUICK, 0, 1)
    return t


def new_cancun_table() -> Table:
    """Cancun: BLOBHASH/BLOBBASEFEE, TLOAD/TSTORE (EIP-1153), MCOPY
    (EIP-5656)."""
    t = new_durango_table()
    t[0x49] = Operation(FASTEST, 1, 1)
    t[0x4A] = Operation(QUICK, 0, 1)
    t[0x5C] = Operation(P.WARM_STORAGE_READ_COST_EIP2929, 1, 1)
    t[0x5D] = Operation(P.WARM_STORAGE_READ_COST_EIP2929, 2, 0)
    t[0x5E] = Operation(FASTEST, 3, 0)
    return t
