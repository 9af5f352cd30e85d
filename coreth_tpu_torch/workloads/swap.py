"""Shared-slot swap workload (the Uniswap-V2/ring analog of reference
core/bench_test.go:64-75).

Port of reference ``workloads/swap.py`` (copied).
A hand-assembled constant-product pool: reserves in storage slots 0/1,
``swap(amountIn)`` reads both, computes ``out = amountIn * r1 /
(r0 + amountIn)`` (MUL + DIV on the device ALU), writes both back, and
emits one log.  Every swap conflicts with every other through the two
shared slots, so a block of swaps is a fully serial OCC chain — the
adversarial case for the optimistic scheduler — while remaining
entirely device-eligible bytecode.
"""

from __future__ import annotations

from coreth_tpu_torch.crypto import keccak256_py
from coreth_tpu_torch.workloads import erc20

SWAP_SELECTOR = bytes.fromhex("11223344")
SWAP_TOPIC = keccak256_py(b"Swap(address)")

_b1 = erc20._b1
# extend the shared assembler's opcode table (a copy, not a mutation)
_OPS = dict(erc20._OPS)
_OPS.update({"MUL": 0x02, "DIV": 0x04, "DUP4": 0x83, "DUP5": 0x84,
             "SWAP2": 0x91, "LOG1": 0xA1, "POP": 0x50})


def _assemble(program):
    return erc20._assemble(program, ops=_OPS)


POOL_RUNTIME = _assemble([
    _b1(0x00), "CALLDATALOAD", _b1(0xE0), "SHR",
    "DUP1", ("PUSH", SWAP_SELECTOR), "EQ", ("PUSHL", "swap"), "JUMPI",
    _b1(0x00), _b1(0x00), "REVERT",

    ("LABEL", "swap"),
    _b1(0x04), "CALLDATALOAD",        # [amt]
    _b1(0x00), "SLOAD",               # [amt, r0]
    _b1(0x01), "SLOAD",               # [amt, r0, r1]
    "DUP1", "DUP4", "MUL",            # [amt, r0, r1, amt*r1]
    "DUP3", "DUP5", "ADD",            # [amt, r0, r1, num, r0+amt]
    "SWAP1", "DIV",                   # [amt, r0, r1, out]
    "DUP1", "SWAP2",                  # [amt, r0, out, out, r1]
    "SUB",                            # [amt, r0, out, r1-out]
    _b1(0x01), "SSTORE",              # [amt, r0, out]
    "SWAP1",                          # [amt, out, r0]
    "DUP3", "ADD",                    # [amt, out, r0+amt]
    _b1(0x00), "SSTORE",              # [amt, out]
    _b1(0x00), "MSTORE",              # [amt]         mem[0] = out
    "CALLER", _b1(0x20), _b1(0x00),   # [amt, caller, 32, 0]
    "LOG1",                           # [amt]
    "STOP",
])

POOL_CODE_HASH = keccak256_py(POOL_RUNTIME)


def swap_calldata(amount_in: int) -> bytes:
    return SWAP_SELECTOR + amount_in.to_bytes(32, "big")


def pool_genesis_account(r0: int, r1: int):
    from coreth_tpu_torch.chain import GenesisAccount
    return GenesisAccount(
        balance=0, code=POOL_RUNTIME, nonce=1,
        storage={(0).to_bytes(32, "big"): r0.to_bytes(32, "big"),
                 (1).to_bytes(32, "big"): r1.to_bytes(32, "big")})


def expected_out(r0: int, r1: int, amount_in: int) -> int:
    return (amount_in * r1) // (r0 + amount_in)
