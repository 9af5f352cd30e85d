"""Avalanche dynamic fee algorithm.

Twin of reference consensus/dummy/dynamic_fees.go: a rolling 10-second
window of gas consumption encoded as 10 big-endian u64s in the header's
Extra field drives the base fee up/down around a target
(CalcBaseFee :40, calcBlockGasCost :288).
All arithmetic replicates the reference's integer-division order exactly.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P

UINT64_MAX = (1 << 64) - 1
WINDOW_LEN = P.ROLLUP_WINDOW  # 10 u64 slots
AP3_BLOCK_GAS_FEE = 1_000_000  # dynamic_fees.go:27


def _unpack_window(data: bytes) -> list:
    return list(struct.unpack(f">{WINDOW_LEN}Q", data[:WINDOW_LEN * 8]))


def _pack_window(window: list) -> bytes:
    return struct.pack(f">{WINDOW_LEN}Q",
                       *[min(w, UINT64_MAX) for w in window])


def _roll_window(window: list, roll: int) -> list:
    if roll >= WINDOW_LEN:
        return [0] * WINDOW_LEN
    return window[roll:] + [0] * roll


def _sum_window(window: list) -> int:
    return min(sum(window), UINT64_MAX)


def calc_base_fee(config: ChainConfig, parent, timestamp: int
                  ) -> Tuple[bytes, int]:
    """(new fee-window bytes for child Extra, child base fee).

    CalcBaseFee (dynamic_fees.go:40); only call when the child is AP3+.
    """
    is_ap3 = config.is_apricot_phase3(parent.time)
    is_ap4 = config.is_apricot_phase4(parent.time)
    is_ap5 = config.is_apricot_phase5(parent.time)
    if not is_ap3 or parent.number == 0:
        return (b"\x00" * P.DYNAMIC_FEE_EXTRA_DATA_SIZE,
                P.APRICOT_PHASE3_INITIAL_BASE_FEE)
    if len(parent.extra) < P.DYNAMIC_FEE_EXTRA_DATA_SIZE:
        raise ValueError(
            f"parent extra too short: {len(parent.extra)}")
    if timestamp < parent.time:
        raise ValueError("child timestamp before parent")
    roll = timestamp - parent.time
    window = _roll_window(_unpack_window(parent.extra), roll)

    base_fee = parent.base_fee
    if is_ap5:
        denominator = P.APRICOT_PHASE5_BASE_FEE_CHANGE_DENOMINATOR
        gas_target = P.APRICOT_PHASE5_TARGET_GAS
    else:
        denominator = P.APRICOT_PHASE4_BASE_FEE_CHANGE_DENOMINATOR
        gas_target = P.APRICOT_PHASE3_TARGET_GAS

    if roll < WINDOW_LEN:
        block_gas_cost = 0
        parent_extra_gas = 0
        if is_ap5:
            parent_extra_gas = parent.ext_data_gas_used or 0
        elif is_ap4:
            block_gas_cost = calc_block_gas_cost(
                P.AP4_TARGET_BLOCK_RATE,
                P.AP4_MIN_BLOCK_GAS_COST,
                P.AP4_MAX_BLOCK_GAS_COST,
                P.AP4_BLOCK_GAS_COST_STEP,
                parent.block_gas_cost,
                parent.time, timestamp)
            parent_extra_gas = parent.ext_data_gas_used or 0
        else:
            block_gas_cost = AP3_BLOCK_GAS_FEE
        added_gas = min(parent.gas_used + parent_extra_gas, UINT64_MAX)
        if not is_ap5:
            added_gas = min(added_gas + block_gas_cost, UINT64_MAX)
        slot = WINDOW_LEN - 1 - roll
        window[slot] = min(window[slot] + added_gas, UINT64_MAX)

    total_gas = _sum_window(window)
    if total_gas == gas_target:
        return _pack_window(window), base_fee

    if total_gas > gas_target:
        delta = max(base_fee * (total_gas - gas_target)
                    // gas_target // denominator, 1)
        base_fee += delta
    else:
        delta = max(base_fee * (gas_target - total_gas)
                    // gas_target // denominator, 1)
        if roll > WINDOW_LEN:
            delta *= roll // WINDOW_LEN
        base_fee -= delta

    if is_ap5:
        base_fee = max(base_fee, P.APRICOT_PHASE4_MIN_BASE_FEE)
    elif is_ap4:
        base_fee = min(max(base_fee, P.APRICOT_PHASE4_MIN_BASE_FEE),
                       P.APRICOT_PHASE4_MAX_BASE_FEE)
    else:
        base_fee = min(max(base_fee, P.APRICOT_PHASE3_MIN_BASE_FEE),
                       P.APRICOT_PHASE3_MAX_BASE_FEE)
    return _pack_window(window), base_fee


def calc_block_gas_cost(target_block_rate: int, min_cost: int, max_cost: int,
                        step: int, parent_cost: Optional[int],
                        parent_time: int, current_time: int) -> int:
    """calcBlockGasCost (dynamic_fees.go:288)."""
    if parent_cost is None:
        return min_cost
    elapsed = current_time - parent_time if parent_time <= current_time else 0
    if elapsed < target_block_rate:
        cost = parent_cost + step * (target_block_rate - elapsed)
    else:
        cost = parent_cost - step * (elapsed - target_block_rate)
    return min(max(cost, min_cost), max_cost)


def block_gas_cost(config: ChainConfig, parent, timestamp: int) -> int:
    """The required BlockGasCost for a child of [parent] at [timestamp]
    (dummy/consensus.go BlockGasCost wrapper)."""
    step = (P.AP5_BLOCK_GAS_COST_STEP
            if config.is_apricot_phase5(timestamp)
            else P.AP4_BLOCK_GAS_COST_STEP)
    return calc_block_gas_cost(
        P.AP4_TARGET_BLOCK_RATE, P.AP4_MIN_BLOCK_GAS_COST,
        P.AP4_MAX_BLOCK_GAS_COST, step, parent.block_gas_cost,
        parent.time, timestamp)

