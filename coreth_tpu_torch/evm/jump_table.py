"""Per-fork jump tables.

Twin of reference core/vm/jump_table.go: a 256-entry table of Operation
records, composed fork-over-fork exactly as the reference does
(frontier -> homestead -> tangerine -> spurious -> byzantium ->
constantinople -> istanbul -> AP1 -> AP2 -> AP3 -> durango,
jump_table.go:94-142 + interpreter.go:74-97 selection).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from coreth_tpu_torch.evm import gas as G
from coreth_tpu_torch.evm import interpreter as I
from coreth_tpu_torch.params import protocol as P

# gas tiers (jump_table.go GasQuickStep..)
QUICK, FASTEST, FAST, MID, SLOW, EXT = 2, 3, 5, 8, 10, 20


class Operation:
    __slots__ = ("execute", "constant_gas", "min_stack", "max_stack",
                 "dynamic_gas", "memory_size", "writes")

    def __init__(self, execute, constant_gas=0, pops=0, pushes=0,
                 dynamic_gas=None, memory_size=None, writes=False):
        self.execute = execute
        self.constant_gas = constant_gas
        self.min_stack = pops
        self.max_stack = int(P.STACK_LIMIT) + pops - pushes
        self.dynamic_gas = dynamic_gas
        self.memory_size = memory_size
        self.writes = writes


def _ceil(off: int, ln: int) -> int:
    return off + ln if ln else 0


def mem_two_args(stack) -> int:  # offset, size at top
    return _ceil(stack[-1], stack[-2])


def mem_mstore(stack) -> int:
    return _ceil(stack[-1], 32)


def mem_mstore8(stack) -> int:
    return _ceil(stack[-1], 1)


def mem_copy3(stack) -> int:  # memOff, dataOff, size
    return _ceil(stack[-1], stack[-3])


def mem_extcodecopy(stack) -> int:
    return _ceil(stack[-2], stack[-4])


def mem_create(stack) -> int:  # value, offset, size
    return _ceil(stack[-2], stack[-3])


def mem_mcopy(stack) -> int:  # dst, src, length
    return max(_ceil(stack[-1], stack[-3]), _ceil(stack[-2], stack[-3]))


def mem_call(stack) -> int:  # gas,to,value,inOff,inSize,outOff,outSize
    return max(_ceil(stack[-4], stack[-5]), _ceil(stack[-6], stack[-7]))


def mem_call_noval(stack) -> int:  # gas,to,inOff,inSize,outOff,outSize
    return max(_ceil(stack[-3], stack[-4]), _ceil(stack[-5], stack[-6]))


def new_frontier_table() -> List[Optional[Operation]]:
    t: List[Optional[Operation]] = [None] * 256
    t[0x00] = Operation(I.op_stop, 0, 0, 0)
    t[0x01] = Operation(I.op_add, FASTEST, 2, 1)
    t[0x02] = Operation(I.op_mul, FAST, 2, 1)
    t[0x03] = Operation(I.op_sub, FASTEST, 2, 1)
    t[0x04] = Operation(I.op_div, FAST, 2, 1)
    t[0x05] = Operation(I.op_sdiv, FAST, 2, 1)
    t[0x06] = Operation(I.op_mod, FAST, 2, 1)
    t[0x07] = Operation(I.op_smod, FAST, 2, 1)
    t[0x08] = Operation(I.op_addmod, MID, 3, 1)
    t[0x09] = Operation(I.op_mulmod, MID, 3, 1)
    t[0x0A] = Operation(I.op_exp, 0, 2, 1, dynamic_gas=G.gas_exp_frontier)
    t[0x0B] = Operation(I.op_signextend, FAST, 2, 1)
    t[0x10] = Operation(I.op_lt, FASTEST, 2, 1)
    t[0x11] = Operation(I.op_gt, FASTEST, 2, 1)
    t[0x12] = Operation(I.op_slt, FASTEST, 2, 1)
    t[0x13] = Operation(I.op_sgt, FASTEST, 2, 1)
    t[0x14] = Operation(I.op_eq, FASTEST, 2, 1)
    t[0x15] = Operation(I.op_iszero, FASTEST, 1, 1)
    t[0x16] = Operation(I.op_and, FASTEST, 2, 1)
    t[0x17] = Operation(I.op_or, FASTEST, 2, 1)
    t[0x18] = Operation(I.op_xor, FASTEST, 2, 1)
    t[0x19] = Operation(I.op_not, FASTEST, 1, 1)
    t[0x1A] = Operation(I.op_byte, FASTEST, 2, 1)
    t[0x20] = Operation(I.op_keccak256, P.KECCAK256_GAS, 2, 1,
                        dynamic_gas=G.gas_keccak256,
                        memory_size=mem_two_args)
    t[0x30] = Operation(I.op_address, QUICK, 0, 1)
    t[0x31] = Operation(I.op_balance, P.BALANCE_GAS_FRONTIER, 1, 1)
    t[0x32] = Operation(I.op_origin, QUICK, 0, 1)
    t[0x33] = Operation(I.op_caller, QUICK, 0, 1)
    t[0x34] = Operation(I.op_callvalue, QUICK, 0, 1)
    t[0x35] = Operation(I.op_calldataload, FASTEST, 1, 1)
    t[0x36] = Operation(I.op_calldatasize, QUICK, 0, 1)
    t[0x37] = Operation(I.op_calldatacopy, FASTEST, 3, 0,
                        dynamic_gas=G.gas_copy, memory_size=mem_copy3)
    t[0x38] = Operation(I.op_codesize, QUICK, 0, 1)
    t[0x39] = Operation(I.op_codecopy, FASTEST, 3, 0,
                        dynamic_gas=G.gas_copy, memory_size=mem_copy3)
    t[0x3A] = Operation(I.op_gasprice, QUICK, 0, 1)
    t[0x3B] = Operation(I.op_extcodesize, P.EXTCODE_SIZE_GAS_FRONTIER, 1, 1)
    t[0x3C] = Operation(I.op_extcodecopy, P.EXTCODE_COPY_BASE_FRONTIER, 4, 0,
                        dynamic_gas=G.gas_ext_copy,
                        memory_size=mem_extcodecopy)
    t[0x40] = Operation(I.op_blockhash, EXT, 1, 1)
    t[0x41] = Operation(I.op_coinbase, QUICK, 0, 1)
    t[0x42] = Operation(I.op_timestamp, QUICK, 0, 1)
    t[0x43] = Operation(I.op_number, QUICK, 0, 1)
    t[0x44] = Operation(I.op_difficulty, QUICK, 0, 1)
    t[0x45] = Operation(I.op_gaslimit, QUICK, 0, 1)
    t[0x50] = Operation(I.op_pop, QUICK, 1, 0)
    t[0x51] = Operation(I.op_mload, FASTEST, 1, 1,
                        dynamic_gas=G.gas_mem_only, memory_size=mem_mstore)
    t[0x52] = Operation(I.op_mstore, FASTEST, 2, 0,
                        dynamic_gas=G.gas_mem_only, memory_size=mem_mstore)
    t[0x53] = Operation(I.op_mstore8, FASTEST, 2, 0,
                        dynamic_gas=G.gas_mem_only, memory_size=mem_mstore8)
    t[0x54] = Operation(I.op_sload, P.SLOAD_GAS_FRONTIER, 1, 1)
    t[0x55] = Operation(I.op_sstore, 0, 2, 0,
                        dynamic_gas=G.gas_sstore_legacy, writes=True)
    t[0x56] = Operation(I.op_jump, MID, 1, 0)
    t[0x57] = Operation(I.op_jumpi, SLOW, 2, 0)
    t[0x58] = Operation(I.op_pc, QUICK, 0, 1)
    t[0x59] = Operation(I.op_msize, QUICK, 0, 1)
    t[0x5A] = Operation(I.op_gas, QUICK, 0, 1)
    t[0x5B] = Operation(I.op_jumpdest, P.JUMPDEST_GAS, 0, 0)
    for i in range(32):
        t[0x60 + i] = Operation(I.make_push(i + 1), FASTEST, 0, 1)
    for i in range(16):
        t[0x80 + i] = Operation(I.make_dup(i + 1), FASTEST, i + 1, i + 2)
        t[0x90 + i] = Operation(I.make_swap(i + 1), FASTEST, i + 2, i + 2)
    for i in range(5):
        t[0xA0 + i] = Operation(I.make_log(i), 0, i + 2, 0,
                                dynamic_gas=G.make_gas_log(i),
                                memory_size=mem_two_args, writes=True)
    t[0xF0] = Operation(I.op_create, P.CREATE_GAS, 3, 1,
                        dynamic_gas=G.gas_create, memory_size=mem_create,
                        writes=True)
    t[0xF1] = Operation(I.op_call, P.CALL_GAS_FRONTIER, 7, 1,
                        dynamic_gas=G.make_gas_call("call", False),
                        memory_size=mem_call)
    t[0xF2] = Operation(I.op_callcode, P.CALL_GAS_FRONTIER, 7, 1,
                        dynamic_gas=G.make_gas_call("callcode", False),
                        memory_size=mem_call)
    t[0xF3] = Operation(I.op_return, 0, 2, 0,
                        dynamic_gas=G.gas_mem_only, memory_size=mem_two_args)
    t[0xFE] = Operation(I.op_invalid, 0, 0, 0)
    t[0xFF] = Operation(I.op_selfdestruct, 0, 1, 0, writes=True,
                        dynamic_gas=_gas_selfdestruct_frontier)
    return t


def _gas_selfdestruct_frontier(evm, frame, stack, memory_size):
    if not evm.statedb.has_suicided(frame.address):
        evm.statedb.add_refund(P.SELFDESTRUCT_REFUND_GAS)
    return 0


def new_homestead_table():
    t = new_frontier_table()
    t[0xF4] = Operation(I.op_delegatecall, P.CALL_GAS_FRONTIER, 6, 1,
                        dynamic_gas=G.make_gas_call("delegatecall", False),
                        memory_size=mem_call_noval)
    return t


def new_tangerine_table():
    t = new_homestead_table()
    t[0x31].constant_gas = P.BALANCE_GAS_EIP150
    t[0x3B].constant_gas = P.EXTCODE_SIZE_GAS_EIP150
    t[0x3C].constant_gas = P.EXTCODE_COPY_BASE_EIP150
    t[0x54].constant_gas = P.SLOAD_GAS_EIP150
    t[0xF1].constant_gas = P.CALL_GAS_EIP150
    t[0xF1].dynamic_gas = G.make_gas_call("call", True)
    t[0xF2].constant_gas = P.CALL_GAS_EIP150
    t[0xF2].dynamic_gas = G.make_gas_call("callcode", True)
    t[0xF4].constant_gas = P.CALL_GAS_EIP150
    t[0xF4].dynamic_gas = G.make_gas_call("delegatecall", True)
    t[0xFF].dynamic_gas = G.gas_selfdestruct_eip150
    return t


def new_spurious_table():
    t = new_tangerine_table()
    t[0x0A].dynamic_gas = G.gas_exp_eip158
    return t


def new_byzantium_table():
    t = new_spurious_table()
    t[0xFA] = Operation(I.op_staticcall, P.CALL_GAS_EIP150, 6, 1,
                        dynamic_gas=G.make_gas_call("staticcall", True),
                        memory_size=mem_call_noval)
    t[0x3D] = Operation(I.op_returndatasize, QUICK, 0, 1)
    t[0x3E] = Operation(I.op_returndatacopy, FASTEST, 3, 0,
                        dynamic_gas=G.gas_copy, memory_size=mem_copy3)
    t[0xFD] = Operation(I.op_revert, 0, 2, 0,
                        dynamic_gas=G.gas_mem_only, memory_size=mem_two_args)
    return t


def new_constantinople_table():
    t = new_byzantium_table()
    t[0x1B] = Operation(I.op_shl, FASTEST, 2, 1)
    t[0x1C] = Operation(I.op_shr, FASTEST, 2, 1)
    t[0x1D] = Operation(I.op_sar, FASTEST, 2, 1)
    t[0x3F] = Operation(I.op_extcodehash, P.EXTCODE_HASH_GAS_CONSTANTINOPLE,
                        1, 1)
    t[0xF5] = Operation(I.op_create2, P.CREATE2_GAS, 4, 1,
                        dynamic_gas=G.gas_create2, memory_size=mem_create,
                        writes=True)
    return t


def new_istanbul_table():
    t = new_constantinople_table()
    t[0x46] = Operation(I.op_chainid, QUICK, 0, 1)     # EIP-1344
    t[0x47] = Operation(I.op_selfbalance, FAST, 0, 1)  # EIP-1884
    t[0x31].constant_gas = P.BALANCE_GAS_EIP1884
    t[0x3F].constant_gas = P.EXTCODE_HASH_GAS_EIP1884
    t[0x54].constant_gas = P.SLOAD_GAS_EIP2200
    t[0x55].dynamic_gas = G.gas_sstore_eip2200        # EIP-2200
    return t


def new_ap1_table():
    """AP1 (eips.go:167): refund-free SSTORE/SELFDESTRUCT."""
    t = new_istanbul_table()
    t[0x55].dynamic_gas = G.gas_sstore_ap1
    t[0xFF].dynamic_gas = G.gas_selfdestruct_ap1
    # BALANCEMC/CALLEX remain live until AP2; multicoin reads only
    t[0xCD] = Operation(I.op_balancemc, P.BALANCE_GAS_EIP1884, 2, 1)
    return t


def new_ap2_table():
    """AP2 (jump_table.go:112): EIP-2929 + multicoin opcodes disabled."""
    t = new_ap1_table()
    t[0xCD] = None  # BALANCEMC disabled
    t[0xCF] = None  # CALLEX disabled
    # enable2929 (eips.go:95-164)
    t[0x54].constant_gas = 0
    t[0x54].dynamic_gas = G.gas_sload_eip2929
    t[0x55].dynamic_gas = G.make_gas_sstore_eip2929(
        P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP3529, with_refunds=False)
    t[0x3F].constant_gas = P.WARM_STORAGE_READ_COST_EIP2929
    t[0x3F].dynamic_gas = G.gas_account_access_eip2929
    t[0x31].constant_gas = P.WARM_STORAGE_READ_COST_EIP2929
    t[0x31].dynamic_gas = G.gas_account_access_eip2929
    t[0x3B].constant_gas = P.WARM_STORAGE_READ_COST_EIP2929
    t[0x3B].dynamic_gas = G.gas_account_access_eip2929
    t[0x3C].constant_gas = P.WARM_STORAGE_READ_COST_EIP2929
    t[0x3C].dynamic_gas = G.gas_extcodecopy_eip2929
    for op, variant in ((0xF1, "call"), (0xF2, "callcode"),
                        (0xF4, "delegatecall"), (0xFA, "staticcall")):
        t[op].constant_gas = P.WARM_STORAGE_READ_COST_EIP2929
        t[op].dynamic_gas = G.make_gas_call_eip2929(variant)
    t[0xFF].constant_gas = P.SELFDESTRUCT_GAS_EIP150
    t[0xFF].dynamic_gas = G.gas_selfdestruct_eip2929
    return t


def new_ap3_table():
    """AP3 (jump_table.go:103): BASEFEE opcode; EIP-3529-reduced refunds
    return via the SSTORE gas function."""
    t = new_ap2_table()
    t[0x48] = Operation(I.op_basefee, QUICK, 0, 1)  # EIP-3198
    t[0x55].dynamic_gas = G.make_gas_sstore_eip2929(
        P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP3529, with_refunds=True)
    return t


def new_durango_table():
    """Durango (jump_table.go:94): PUSH0 (EIP-3855) + initcode metering
    (EIP-3860)."""
    t = new_ap3_table()
    t[0x5F] = Operation(I.op_push0, QUICK, 0, 1)
    t[0xF0].dynamic_gas = G.gas_create_eip3860
    t[0xF5].dynamic_gas = G.gas_create2_eip3860
    return t


def new_cancun_table():
    """Cancun (jump_table.go newCancunInstructionSet): transient
    storage (EIP-1153, flat 100 gas, no refunds), MCOPY (EIP-5656),
    BLOBHASH/BLOBBASEFEE (EIP-4844/7516 — degenerate constants on a
    chain with no blob market), and EIP-6780 SELFDESTRUCT semantics
    (enforced in op_selfdestruct via rules.is_cancun)."""
    t = new_durango_table()
    t[0x49] = Operation(I.op_blobhash, FASTEST, 1, 1)
    t[0x4A] = Operation(I.op_blobbasefee, QUICK, 0, 1)
    t[0x5C] = Operation(I.op_tload,
                        P.WARM_STORAGE_READ_COST_EIP2929, 1, 1)
    t[0x5D] = Operation(I.op_tstore,
                        P.WARM_STORAGE_READ_COST_EIP2929, 2, 0,
                        writes=True)
    t[0x5E] = Operation(I.op_mcopy, FASTEST, 3, 0,
                        dynamic_gas=G.gas_copy, memory_size=mem_mcopy)
    return t


_CACHE = {}


def for_rules(rules) -> List[Optional[Operation]]:
    """Select the table for a rule set (interpreter.go:74-97)."""
    if rules.is_cancun:
        key = "cancun"
    elif rules.is_durango:
        key = "durango"
    elif rules.is_apricot_phase3:
        key = "ap3"
    elif rules.is_apricot_phase2:
        key = "ap2"
    elif rules.is_apricot_phase1:
        key = "ap1"
    elif rules.is_istanbul:
        key = "istanbul"
    elif rules.is_constantinople:
        key = "constantinople"
    elif rules.is_byzantium:
        key = "byzantium"
    elif rules.is_eip158:
        key = "spurious"
    elif rules.is_eip150:
        key = "tangerine"
    elif rules.is_homestead:
        key = "homestead"
    else:
        key = "frontier"
    if key not in _CACHE:
        _CACHE[key] = {
            "frontier": new_frontier_table,
            "homestead": new_homestead_table,
            "tangerine": new_tangerine_table,
            "spurious": new_spurious_table,
            "byzantium": new_byzantium_table,
            "constantinople": new_constantinople_table,
            "istanbul": new_istanbul_table,
            "ap1": new_ap1_table,
            "ap2": new_ap2_table,
            "ap3": new_ap3_table,
            "durango": new_durango_table,
            "cancun": new_cancun_table,
        }[key]()
    return _CACHE[key]


# Opcode mnemonics (core/vm/opcodes.go String()) — used by tracers.
OP_NAMES = {
    0x00: "STOP", 0x01: "ADD", 0x02: "MUL", 0x03: "SUB", 0x04: "DIV",
    0x05: "SDIV", 0x06: "MOD", 0x07: "SMOD", 0x08: "ADDMOD",
    0x09: "MULMOD", 0x0a: "EXP", 0x0b: "SIGNEXTEND",
    0x10: "LT", 0x11: "GT", 0x12: "SLT", 0x13: "SGT", 0x14: "EQ",
    0x15: "ISZERO", 0x16: "AND", 0x17: "OR", 0x18: "XOR", 0x19: "NOT",
    0x1a: "BYTE", 0x1b: "SHL", 0x1c: "SHR", 0x1d: "SAR",
    0x20: "KECCAK256",
    0x30: "ADDRESS", 0x31: "BALANCE", 0x32: "ORIGIN", 0x33: "CALLER",
    0x34: "CALLVALUE", 0x35: "CALLDATALOAD", 0x36: "CALLDATASIZE",
    0x37: "CALLDATACOPY", 0x38: "CODESIZE", 0x39: "CODECOPY",
    0x3a: "GASPRICE", 0x3b: "EXTCODESIZE", 0x3c: "EXTCODECOPY",
    0x3d: "RETURNDATASIZE", 0x3e: "RETURNDATACOPY", 0x3f: "EXTCODEHASH",
    0x40: "BLOCKHASH", 0x41: "COINBASE", 0x42: "TIMESTAMP", 0x43: "NUMBER",
    0x44: "DIFFICULTY", 0x45: "GASLIMIT", 0x46: "CHAINID",
    0x47: "SELFBALANCE", 0x48: "BASEFEE",
    0x50: "POP", 0x51: "MLOAD", 0x52: "MSTORE", 0x53: "MSTORE8",
    0x54: "SLOAD", 0x55: "SSTORE", 0x56: "JUMP", 0x57: "JUMPI",
    0x58: "PC", 0x59: "MSIZE", 0x5a: "GAS", 0x5b: "JUMPDEST",
    0x5c: "TLOAD", 0x5d: "TSTORE", 0x5e: "MCOPY", 0x5f: "PUSH0",
    0xf0: "CREATE", 0xf1: "CALL", 0xf2: "CALLCODE", 0xf3: "RETURN",
    0xf4: "DELEGATECALL", 0xf5: "CREATE2", 0xfa: "STATICCALL",
    0xfd: "REVERT", 0xfe: "INVALID", 0xff: "SELFDESTRUCT",
}
for _i in range(32):
    OP_NAMES[0x60 + _i] = f"PUSH{_i + 1}"
for _i in range(16):
    OP_NAMES[0x80 + _i] = f"DUP{_i + 1}"
    OP_NAMES[0x90 + _i] = f"SWAP{_i + 1}"
for _i in range(5):
    OP_NAMES[0xa0 + _i] = f"LOG{_i}"
