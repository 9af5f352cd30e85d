"""Dynamic gas functions.

Twin of reference core/vm/gas_table.go + operations_acl.go + gas.go.
Each function receives (evm, frame, stack, memory_size) where
``memory_size`` is the post-expansion byte size demanded by the op; it
returns the dynamic gas (memory expansion included).  Stack peeks use
``stack[-1]`` = top.
"""

from __future__ import annotations

from coreth_tpu_torch.evm import vmerrs
from coreth_tpu_torch.params import protocol as P

UINT64_MAX = (1 << 64) - 1
HASH_ZERO = b"\x00" * 32

# call-gas temp storage: dynamic gas computes the child gas (64/63 rule)
# and the execute step needs it; geth stashes it on evm.callGasTemp
# (gas_table.go:430) — we do the same on the EVM object.


def memory_gas_cost(mem_len: int, new_size: int) -> int:
    """Quadratic memory expansion cost (gas_table.go:29 memoryGasCost)."""
    if new_size == 0:
        return 0
    if new_size > 0x1FFFFFFFE0:
        raise vmerrs.ErrGasUintOverflow()
    new_words = (new_size + 31) // 32
    new_cost = new_words * P.MEMORY_GAS + new_words * new_words // P.QUAD_COEFF_DIV
    old_words = mem_len // 32
    old_cost = old_words * P.MEMORY_GAS + old_words * old_words // P.QUAD_COEFF_DIV
    return new_cost - old_cost if new_cost > old_cost else 0


def _mem_gas(frame, memory_size: int) -> int:
    return memory_gas_cost(len(frame.memory), memory_size)


def copy_gas(word_gas: int):
    """memory expansion + per-word copy cost; length at stack[-3]."""
    def fn(evm, frame, stack, memory_size, length_pos=2):
        gas = _mem_gas(frame, memory_size)
        words = (stack[-1 - length_pos] + 31) // 32
        return gas + words * word_gas
    return fn


gas_copy = copy_gas(P.COPY_GAS)


def gas_ext_copy(evm, frame, stack, memory_size):
    # EXTCODECOPY: length at stack position 4
    gas = _mem_gas(frame, memory_size)
    words = (stack[-4] + 31) // 32
    return gas + words * P.COPY_GAS


def gas_keccak256(evm, frame, stack, memory_size):
    gas = _mem_gas(frame, memory_size)
    words = (stack[-2] + 31) // 32
    return gas + words * P.KECCAK256_WORD_GAS


def gas_mem_only(evm, frame, stack, memory_size):
    return _mem_gas(frame, memory_size)


def make_gas_log(n: int):
    def fn(evm, frame, stack, memory_size):
        size = stack[-2]
        if size > UINT64_MAX:
            raise vmerrs.ErrGasUintOverflow()
        gas = _mem_gas(frame, memory_size)
        return gas + P.LOG_GAS + n * P.LOG_TOPIC_GAS + size * P.LOG_DATA_GAS
    return fn


def gas_exp_frontier(evm, frame, stack, memory_size):
    # base ExpGas + per-exponent-byte (gas_table.go gasExpFrontier)
    exponent = stack[-2]
    nbytes = (exponent.bit_length() + 7) // 8
    return P.EXP_GAS + nbytes * P.EXP_BYTE_FRONTIER


def gas_exp_eip158(evm, frame, stack, memory_size):
    exponent = stack[-2]
    nbytes = (exponent.bit_length() + 7) // 8
    return P.EXP_GAS + nbytes * P.EXP_BYTE_EIP158


def gas_create(evm, frame, stack, memory_size):
    return _mem_gas(frame, memory_size)


def gas_create2(evm, frame, stack, memory_size):
    gas = _mem_gas(frame, memory_size)
    words = (stack[-3] + 31) // 32
    return gas + words * P.KECCAK256_WORD_GAS


def gas_create_eip3860(evm, frame, stack, memory_size):
    gas = _mem_gas(frame, memory_size)
    words = (stack[-3] + 31) // 32
    return gas + words * P.INIT_CODE_WORD_GAS


def gas_create2_eip3860(evm, frame, stack, memory_size):
    gas = _mem_gas(frame, memory_size)
    words = (stack[-3] + 31) // 32
    return gas + words * (P.INIT_CODE_WORD_GAS + P.KECCAK256_WORD_GAS)


# ---------------------------------------------------------------- SSTORE

def gas_sstore_legacy(evm, frame, stack, memory_size):
    """Pre-Istanbul SSTORE (gas_table.go:97 legacy rules)."""
    key = stack[-1].to_bytes(32, "big")
    value = stack[-2]
    current = evm.statedb.get_state(frame.address, key)
    cur_zero = current == HASH_ZERO
    if cur_zero and value != 0:
        return P.SSTORE_SET_GAS
    if not cur_zero and value == 0:
        evm.statedb.add_refund(P.SSTORE_REFUND_GAS)
        return P.SSTORE_CLEAR_GAS
    return P.SSTORE_RESET_GAS


def gas_sstore_eip2200(evm, frame, stack, memory_size):
    """Istanbul net-metered SSTORE (gas_table.go:175)."""
    if frame.gas <= P.SSTORE_SENTRY_GAS_EIP2200:
        raise vmerrs.ErrOutOfGas("not enough gas for reentrancy sentry")
    key = stack[-1].to_bytes(32, "big")
    value = stack[-2].to_bytes(32, "big")
    current = evm.statedb.get_state(frame.address, key)
    if current == value:
        return P.SLOAD_GAS_EIP2200
    original = evm.statedb.get_committed_state(frame.address, key)
    if original == current:
        if original == HASH_ZERO:
            return P.SSTORE_SET_GAS_EIP2200
        if value == HASH_ZERO:
            evm.statedb.add_refund(P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP2200)
        return P.SSTORE_RESET_GAS_EIP2200
    if original != HASH_ZERO:
        if current == HASH_ZERO:
            evm.statedb.sub_refund(P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP2200)
        elif value == HASH_ZERO:
            evm.statedb.add_refund(P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP2200)
    if original == value:
        if original == HASH_ZERO:
            evm.statedb.add_refund(
                P.SSTORE_SET_GAS_EIP2200 - P.SLOAD_GAS_EIP2200)
        else:
            evm.statedb.add_refund(
                P.SSTORE_RESET_GAS_EIP2200 - P.SLOAD_GAS_EIP2200)
    return P.SLOAD_GAS_EIP2200


def gas_sstore_ap1(evm, frame, stack, memory_size):
    """ApricotPhase1: EIP-2200 cost structure with all refunds removed
    (gas_table.go:243 gasSStoreAP1)."""
    if frame.gas <= P.SSTORE_SENTRY_GAS_EIP2200:
        raise vmerrs.ErrOutOfGas("not enough gas for reentrancy sentry")
    key = stack[-1].to_bytes(32, "big")
    value = stack[-2].to_bytes(32, "big")
    current = evm.statedb.get_state(frame.address, key)
    if current == value:
        return P.SLOAD_GAS_EIP2200
    original = evm.statedb.get_committed_state_ap1(frame.address, key)
    if original == current:
        if original == HASH_ZERO:
            return P.SSTORE_SET_GAS_EIP2200
        return P.SSTORE_RESET_GAS_EIP2200
    return P.SLOAD_GAS_EIP2200


def make_gas_sstore_eip2929(clears_refund: int, with_refunds: bool):
    """Berlin/AP2 SSTORE (operations_acl.go:58 makeGasSStoreFunc).

    coreth quirk: AP2 keeps refunds *disabled* (AP1 behavior) while using
    2929 warm/cold pricing; refunds come back reduced (EIP-3529) at AP3 —
    reference operations_acl.go:58 is parameterized the same way.
    """
    def fn(evm, frame, stack, memory_size):
        if frame.gas <= P.SSTORE_SENTRY_GAS_EIP2200:
            raise vmerrs.ErrOutOfGas("not enough gas for reentrancy sentry")
        key = stack[-1].to_bytes(32, "big")
        value = stack[-2].to_bytes(32, "big")
        cost = 0
        _, slot_warm = evm.statedb.slot_in_access_list(frame.address, key)
        if not slot_warm:
            cost = P.COLD_SLOAD_COST_EIP2929
            evm.statedb.add_slot_to_access_list(frame.address, key)
        current = evm.statedb.get_state(frame.address, key)
        if current == value:
            return cost + P.WARM_STORAGE_READ_COST_EIP2929
        original = evm.statedb.get_committed_state_ap1(frame.address, key)
        if original == current:
            if original == HASH_ZERO:
                return cost + P.SSTORE_SET_GAS_EIP2200
            if with_refunds and value == HASH_ZERO:
                evm.statedb.add_refund(clears_refund)
            return cost + (P.SSTORE_RESET_GAS_EIP2200
                           - P.COLD_SLOAD_COST_EIP2929)
        if with_refunds:
            if original != HASH_ZERO:
                if current == HASH_ZERO:
                    evm.statedb.sub_refund(clears_refund)
                elif value == HASH_ZERO:
                    evm.statedb.add_refund(clears_refund)
            if original == value:
                if original == HASH_ZERO:
                    evm.statedb.add_refund(
                        P.SSTORE_SET_GAS_EIP2200
                        - P.WARM_STORAGE_READ_COST_EIP2929)
                else:
                    evm.statedb.add_refund(
                        P.SSTORE_RESET_GAS_EIP2200
                        - P.COLD_SLOAD_COST_EIP2929
                        - P.WARM_STORAGE_READ_COST_EIP2929)
        return cost + P.WARM_STORAGE_READ_COST_EIP2929
    return fn


# ------------------------------------------------------------ EIP-2929 reads

def gas_sload_eip2929(evm, frame, stack, memory_size):
    key = stack[-1].to_bytes(32, "big")
    _, warm = evm.statedb.slot_in_access_list(frame.address, key)
    if warm:
        return P.WARM_STORAGE_READ_COST_EIP2929
    evm.statedb.add_slot_to_access_list(frame.address, key)
    return P.COLD_SLOAD_COST_EIP2929


def _cold_account_surcharge(evm, addr: bytes) -> int:
    """(cold - warm) when cold; the warm 100 is the op's constant gas
    (operations_acl.go gasEip2929AccountCheck)."""
    if evm.statedb.address_in_access_list(addr):
        return 0
    evm.statedb.add_address_to_access_list(addr)
    return (P.COLD_ACCOUNT_ACCESS_COST_EIP2929
            - P.WARM_STORAGE_READ_COST_EIP2929)


def gas_account_access_eip2929(evm, frame, stack, memory_size):
    """BALANCE / EXTCODESIZE / EXTCODEHASH under EIP-2929."""
    addr = (stack[-1] & ((1 << 160) - 1)).to_bytes(20, "big")
    return _cold_account_surcharge(evm, addr)


def gas_extcodecopy_eip2929(evm, frame, stack, memory_size):
    addr = (stack[-1] & ((1 << 160) - 1)).to_bytes(20, "big")
    return gas_ext_copy(evm, frame, stack, memory_size) \
        + _cold_account_surcharge(evm, addr)


# ------------------------------------------------------------------ calls

def _call_child_gas(available: int, base_cost: int, requested: int,
                    use_all_rule: bool) -> int:
    """EIP-150 63/64 forwarding (gas.go callGas)."""
    if use_all_rule:
        avail = available - base_cost
        cap = avail - avail // 64
        return min(requested, cap)
    return requested


def make_gas_call(variant: str, eip150: bool):
    """CALL/CALLCODE/DELEGATECALL/STATICCALL dynamic gas (gas_table.go).

    variant: 'call' | 'callcode' | 'delegatecall' | 'staticcall'.
    """
    def fn(evm, frame, stack, memory_size):
        gas = _mem_gas(frame, memory_size)
        value = stack[-3] if variant in ("call", "callcode") else 0
        addr = (stack[-2] & ((1 << 160) - 1)).to_bytes(20, "big")
        extra = 0
        if variant == "call":
            if value != 0:
                extra += P.CALL_VALUE_TRANSFER_GAS
                if evm.is_homestead_rules_new_account(addr):
                    extra += P.CALL_NEW_ACCOUNT_GAS
        elif variant == "callcode":
            if value != 0:
                extra += P.CALL_VALUE_TRANSFER_GAS
        gas += extra
        requested = stack[-1]
        child = _call_child_gas(frame.gas, gas, requested, eip150)
        evm.call_gas_temp = child
        if child > UINT64_MAX - gas:
            raise vmerrs.ErrGasUintOverflow()
        return gas + child
    return fn


def make_gas_call_eip2929(variant: str):
    """Berlin call gas: cold account surcharge folded into dynamic gas
    (operations_acl.go:160 makeCallVariantGasCallEIP2929)."""
    inner = make_gas_call(variant, eip150=True)

    def fn(evm, frame, stack, memory_size):
        addr = (stack[-2] & ((1 << 160) - 1)).to_bytes(20, "big")
        warm = evm.statedb.address_in_access_list(addr)
        cold_cost = 0
        if not warm:
            evm.statedb.add_address_to_access_list(addr)
            cold_cost = (P.COLD_ACCOUNT_ACCESS_COST_EIP2929
                         - P.WARM_STORAGE_READ_COST_EIP2929)
            if frame.gas < cold_cost:
                raise vmerrs.ErrOutOfGas()
            # charge the cold surcharge before the 63/64 computation
            frame.gas -= cold_cost
        try:
            gas = inner(evm, frame, stack, memory_size)
        finally:
            frame.gas += cold_cost
        return gas + cold_cost
    return fn


# ------------------------------------------------------------- selfdestruct

def gas_selfdestruct_eip150(evm, frame, stack, memory_size):
    """Tangerine..Istanbul SELFDESTRUCT (gas_table.go:556), refund via
    interpreter; EIP-158: new-account charge only when value moved."""
    gas = P.SELFDESTRUCT_GAS_EIP150
    addr = (stack[-1] & ((1 << 160) - 1)).to_bytes(20, "big")
    if evm.rules.is_eip158:
        if (evm.statedb.empty(addr)
                and evm.statedb.get_balance(frame.address) != 0):
            gas += P.CREATE_BY_SELFDESTRUCT_GAS
    elif not evm.statedb.exist(addr):
        gas += P.CREATE_BY_SELFDESTRUCT_GAS
    if not evm.statedb.has_suicided(frame.address):
        evm.statedb.add_refund(P.SELFDESTRUCT_REFUND_GAS)
    return gas


def gas_selfdestruct_ap1(evm, frame, stack, memory_size):
    """AP1: same charges, no refund (eips.go enableAP1)."""
    gas = P.SELFDESTRUCT_GAS_EIP150
    addr = (stack[-1] & ((1 << 160) - 1)).to_bytes(20, "big")
    if (evm.statedb.empty(addr)
            and evm.statedb.get_balance(frame.address) != 0):
        gas += P.CREATE_BY_SELFDESTRUCT_GAS
    return gas


def gas_selfdestruct_eip2929(evm, frame, stack, memory_size):
    """AP2+: 2929 cold-account surcharge, no refund
    (operations_acl.go:214 gasSelfdestructEIP2929 w/ refundsEnabled=false)."""
    gas = 0
    addr = (stack[-1] & ((1 << 160) - 1)).to_bytes(20, "big")
    if not evm.statedb.address_in_access_list(addr):
        evm.statedb.add_address_to_access_list(addr)
        gas = P.COLD_ACCOUNT_ACCESS_COST_EIP2929
    if (evm.statedb.empty(addr)
            and evm.statedb.get_balance(frame.address) != 0):
        gas += P.CREATE_BY_SELFDESTRUCT_GAS
    return gas
