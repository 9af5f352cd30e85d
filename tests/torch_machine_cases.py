"""Programs for the step machine (K5) parity tests — JAX-free, shared by
tests/test_torch_machine.py (the port's plain version against the JAX
reference on the CPU) and tests/test_torch_cuda.py (the CUDA kernel
against the plain version on the card).

Each case is a list of lanes that run in ONE batch; a lane is a dict
of code, calldata, gas, value, the contract address and its committed
storage (which the runner's resolver serves on a miss).  The programs
follow the reference's device-EVM differential suite
(tests/test_device_evm.py): arithmetic, signed ops, modexp, jumps, bad
jumps, stack underflow, undefined and INVALID opcodes, revert/return,
the OOG boundary, memory, copies, context ops, the SSTORE ladders, the
blind-SSTORE miss rerun, logs, keccak, ERC-20 transfers and the
capacity escapes.
"""

from __future__ import annotations

from typing import Dict, List

from coreth_tpu_torch.workloads.erc20 import (
    TOKEN_RUNTIME, balance_slot, transfer_calldata,
)

SENDER = b"\x11" * 20
CONTRACT = b"\xcc" * 20
COINBASE = bytes.fromhex("0100000000000000000000000000000000000000")
NUMBER, TIME = 5, 3_000
GAS_PRICE = 30 * 10**9
GAS_LIMIT = 8_000_000
BASE_FEE = 25 * 10**9
CHAIN_ID = 43112   # TEST_CHAIN_CONFIG


def push(v: int) -> str:
    raw = v.to_bytes((max(v.bit_length(), 1) + 7) // 8, "big")
    return f"{0x5F + len(raw):02x}" + raw.hex()


def sstore_seq(exprs) -> bytes:
    out = ""
    for code, slot in exprs:
        out += code + push(slot) + "55"
    return bytes.fromhex(out + "00")


def lane(code, calldata=b"", gas=500_000, storage=None, value=0,
         address=CONTRACT) -> dict:
    if isinstance(code, str):
        code = bytes.fromhex(code)
    return dict(code=code, calldata=calldata, gas=gas, value=value,
                address=address, storage=dict(storage or {}))


def _k(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _addr(i: int) -> bytes:
    return bytes([0xC0 + i]) * 20


_SSTORE_5 = push(5) + push(0) + "55" + "00"      # 3 + 3 + 22100 to run

CASES: Dict[str, List[dict]] = {
    "arith": [lane(sstore_seq([
        (push(3) + push(4) + "01", 1), (push(3) + push(10) + "03", 2),
        (push(7) + push(6) + "02", 3), (push(3) + push(17) + "04", 4),
        (push(0) + push(17) + "04", 5), (push(5) + push(17) + "06", 6),
    ]))],
    "signed": [lane(sstore_seq([
        (push(3) + push(2**256 - 6) + "05", 1),
        (push(5) + push(2**256 - 17) + "07", 2),
        (push(2**255) + push(2**256 - 1) + "05", 3),
        (push(2**256 - 1) + push(2**255) + "05", 4),  # -2^255 / -1
        (push(0) + push(2**256 - 6) + "0b", 5),
    ]))],
    "modexp": [lane(sstore_seq([
        (push(7) + push(5) + push(100) + "08", 1),
        (push(7) + push(5) + push(100) + "09", 2),
        (push(5) + push(3) + "0a", 3), (push(0) + push(3) + "0a", 4),
        (push(200) + push(2**128 - 1) + "0a", 5),
        (push(0) + push(5) + push(9) + "08", 6),       # addmod by 0
    ]))],
    "bitwise": [lane(sstore_seq([
        (push(2) + push(1) + "10", 1), (push(1) + push(2) + "11", 2),
        (push(1) + push(2**256 - 1) + "12", 3),
        (push(2**256 - 1) + push(1) + "13", 4),
        (push(5) + push(5) + "14", 5), (push(0) + "15", 6),
        (push(0b1100) + push(0b1010) + "16", 7),
        (push(0b1100) + push(0b1010) + "17", 8),
        (push(0b1100) + push(0b1010) + "18", 9), (push(1) + "19", 10),
        (push(2**200) + push(3) + "1a", 11), (push(7) + push(2) + "1b", 12),
        (push(2**100) + push(4) + "1c", 13),
        (push(2**256 - 64) + push(3) + "1d", 14),
        (push(2**256 - 64) + push(300) + "1d", 15),
    ]))],
    "jumps": [
        lane("600a6000" "5b" "810190" "60019003" "9081" "600457"
             "600155" "00"),                              # sum loop
        lane(push(9) + "56" + "00"),                      # bad jump
        lane(push(1) + push(0) + "57" + push(1) + push(2) + "55" + "00"),
    ],
    "errors": [
        lane("01" + "00"),                                # underflow
        lane("21" + "00"),                                # undefined
        lane(push(1) + "fe"),                             # INVALID
        lane("5f" + "00"),                                # PUSH0 durango
    ],
    "revert_return": [lane(push(0) + push(0) + "fd"),
                      lane(push(0) + push(0) + "f3"),
                      lane(push(7) + push(0) + "52" + push(32) + push(0)
                           + "fd")],
    "oog_boundary": [lane(_SSTORE_5, gas=g)
                     for g in (22106, 22105, 22006, 2306, 2305)],
    "memory": [lane(sstore_seq([
        (push(0xDEADBEEF) + push(0) + "52" + push(0) + "51", 1),
        (push(0xAB) + push(33) + "53" + push(32) + "51", 2),
        ("59", 3), (push(0) + "51", 4),
    ])), lane(push(1) + push(2**40) + "52" + "00")],      # address OOG
    "copies": [lane(sstore_seq([
        (push(32) + push(8) + push(0) + "37" + push(0) + "51", 1),
        (push(10) + push(0) + push(64) + "39" + push(64) + "51", 2),
        (push(4) + "35", 3), ("36", 4), ("38", 5),
        (push(100) + "35", 6),
    ]), calldata=bytes(range(64)))],
    "context": [lane(sstore_seq([
        ("33", 1), ("32", 2), ("30", 3), ("34", 4), ("3a", 5),
        ("41", 6), ("42", 7), ("43", 8), ("44", 9), ("45", 10),
        ("46", 11), ("48", 12), ("58", 13), ("5a", 14),
    ]), value=12345)],
    "sstore_ladders": [
        lane(sstore_seq([(push(7) + "54" + push(7) + "54" + "01", 1),
                         (push(0), 7)]), storage={_k(7): 99},
             address=_addr(0)),
        lane(sstore_seq([(push(1), 5)]), address=_addr(1)),
        lane(sstore_seq([(push(2), 3)]), storage={_k(3): 9},
             address=_addr(2)),
        lane(sstore_seq([(push(9), 3)]), storage={_k(3): 9},
             address=_addr(3)),
        lane(sstore_seq([(push(0), 3)]), storage={_k(3): 9},
             address=_addr(4)),
        lane(sstore_seq([(push(5), 1), (push(0), 1)]), storage={_k(1): 7},
             address=_addr(5)),
        lane(sstore_seq([(push(0), 1), (push(7), 1)]), storage={_k(1): 7},
             address=_addr(6)),
        lane(sstore_seq([(push(5), 1), (push(7), 1)]), storage={_k(1): 7},
             address=_addr(7)),
    ],
    "blind_sstore_rerun": [
        lane(push(9) + push(3) + "55" + "00", gas=g, storage={_k(3): 7},
             address=_addr(i))
        for i, g in enumerate((10_000, 5_006, 5_005, 23_000, 2_300))],
    "logs": [lane(
        push(0xFEED) + push(0) + "52"
        + push(32) + push(0) + "a0"
        + push(1) + push(32) + push(0) + "a1"
        + push(2) + push(1) + push(8) + push(8) + "a2"
        + push(3) + push(2) + push(1) + push(0) + push(0) + "a3"
        + push(4) + push(3) + push(2) + push(1) + push(40) + push(3)
        + "a4" + "00")],
    "keccak": [lane(sstore_seq([
        (push(0xABCD) + push(0) + "52" + push(32) + push(0) + "20", 1),
        (push(0) + push(0) + "20", 2), (push(68) + push(0) + "20", 3),
        (push(200) + push(5) + "20", 4),
    ]))],
    "erc20": [
        lane(TOKEN_RUNTIME, transfer_calldata(b"\x22" * 20, 1234),
             gas=200_000, storage={balance_slot(SENDER): 10**18}),
        lane(TOKEN_RUNTIME, transfer_calldata(b"\x22" * 20, 1234),
             gas=200_000, storage={balance_slot(SENDER): 10},
             address=_addr(1)),                           # insufficient
        lane(TOKEN_RUNTIME, transfer_calldata(b"\x23" * 20, 5),
             gas=30_000, storage={balance_slot(SENDER): 10**18},
             address=_addr(2)),                           # out of gas
        lane(TOKEN_RUNTIME, bytes.fromhex("70a08231") + b"\x00" * 12
             + SENDER, gas=100_000, storage={balance_slot(SENDER): 77},
             address=_addr(3)),                           # balanceOf
    ],
    "erc20_lockstep": [
        lane(TOKEN_RUNTIME, transfer_calldata(bytes([0x30 + i]) * 20,
                                              100 + i),
             gas=200_000, storage={balance_slot(SENDER): 10**18})
        for i in range(8)],
    "host_escapes": [
        lane(push(1) + push(100_000) + "52" + "00"),       # memory cap
        lane(push(300) + push(0) + "20" + "00"),           # keccak cap
        lane(push(1) * 65 + "00"),                         # stack cap
        lane("".join(push(1) + push(k) + "55" for k in range(17))
             + "00", address=_addr(4)),                   # cache full
        lane((push(0) + push(0) + "a0") * 9 + "00"),       # log pool
        lane(push(600) + push(0) + push(0) + "37" + "00"),  # copy cap
    ],
}

# Cancun-only opcodes (TLOAD/TSTORE/MCOPY) run under their own fork.
CANCUN_CASES: Dict[str, List[dict]] = {
    "transient_mcopy": [
        lane(sstore_seq([
            (push(7) + push(1) + "5d" + push(1) + "5c", 1),
            (push(2) + "5c", 2),
            (push(0x1122334455) + push(0) + "52"
             + push(32) + push(0) + push(3) + "5e" + push(3) + "51", 3),
            (push(0x99) + push(40) + "52"
             + push(32) + push(40) + push(30) + "5e" + push(30) + "51", 4),
        ])),
        lane("".join(push(1) + push(k) + "5d" for k in range(9)) + "00"),
    ],
}


def resolver_for(lanes):
    """Committed storage of the case's contracts, keyed by the
    normalized (multicoin-partition) slot key the machine reports."""
    table = {}
    for ln in lanes:
        for k, v in ln["storage"].items():
            table[(ln["address"], bytes([k[0] & 0xFE]) + k[1:])] = v

    def resolve(addr: bytes, key: bytes) -> int:
        return table.get((addr, key), 0)
    return resolve


def specs(lanes, TxSpec) -> list:
    """The lanes as TxSpecs of either package (blind: empty caches)."""
    return [TxSpec(code=ln["code"], calldata=ln["calldata"],
                   gas=ln["gas"], value=ln["value"], caller=SENDER,
                   address=ln["address"], origin=SENDER,
                   gas_price=GAS_PRICE) for ln in lanes]


def env(BlockEnv):
    return BlockEnv(coinbase=COINBASE, timestamp=TIME, number=NUMBER,
                    gas_limit=GAS_LIMIT, chain_id=CHAIN_ID,
                    base_fee=BASE_FEE)
