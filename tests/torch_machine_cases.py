"""Programs for the step machine (K5) and fused OCC window (K6) parity
tests — JAX-free, shared by tests/test_torch_machine.py and
tests/test_torch_occ.py (the port's plain versions against the JAX
reference on the CPU) and tests/test_torch_cuda.py (the CUDA kernels
against the plain versions on the card).

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
    BALANCEOF_SELECTOR, TOKEN_RUNTIME, balance_slot, transfer_calldata,
)
from coreth_tpu_torch.workloads.swap import POOL_RUNTIME, swap_calldata

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
         address=CONTRACT, caller=SENDER, premap=()) -> dict:
    """One lane: ``storage`` is its contract's committed storage (raw
    keys); ``premap`` the keys a fused window premaps for it."""
    if isinstance(code, str):
        code = bytes.fromhex(code)
    return dict(code=code, calldata=calldata, gas=gas, value=value,
                address=address, storage=dict(storage or {}),
                caller=caller, premap=tuple(premap))


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


# ------------------------------------------------------ fused OCC windows
TOKEN = b"\x77" * 20
POOL = b"\x74" * 20
ESCAPER_CODE = bytes.fromhex("600061138852" + "00")   # MSTORE at 5000


def _norm(key: bytes) -> bytes:
    return bytes([key[0] & 0xFE]) + key[1:]


def _holder(i: int) -> bytes:
    return (0x4000 + i).to_bytes(2, "big") * 10


def _xfer(src: int, dst: int, amount: int, premap=True, bal=10**9,
          gas=100_000) -> dict:
    """An ERC-20 transfer() lane from holder ``src`` to holder ``dst``,
    each holding ``bal`` tokens, both balance slots premapped."""
    a, b = balance_slot(_holder(src)), balance_slot(_holder(dst))
    return lane(TOKEN_RUNTIME, transfer_calldata(_holder(dst), amount),
                gas=gas, storage={a: bal, b: bal}, address=TOKEN,
                caller=_holder(src),
                premap=(_norm(a), _norm(b)) if premap else ())


def _balance_of(who: int) -> dict:
    k = balance_slot(_holder(who))
    return lane(TOKEN_RUNTIME, BALANCEOF_SELECTOR + b"\x00" * 12
                + _holder(who), gas=100_000, storage={k: 77},
                address=TOKEN, premap=(_norm(k),))


def _swap(amount: int, caller: int) -> dict:
    return lane(POOL_RUNTIME, swap_calldata(amount), gas=200_000,
                storage={_k(0): 10**15, _k(1): 10**15}, address=POOL,
                caller=_holder(caller))


_CTX_OPS = ("42", "43", "45", "41", "46", "48")   # block words


def _context(block: int) -> dict:
    """Stores TIMESTAMP, NUMBER, GASLIMIT, COINBASE, CHAINID and BASEFEE
    into premapped slots 1..6 (each block overwrites them)."""
    return lane(sstore_seq([(op, k + 1) for k, op in enumerate(_CTX_OPS)]),
                premap=[_k(k + 1) for k in range(len(_CTX_OPS))],
                caller=_holder(900 + block))


# Each window case is a list of blocks, each a list of lanes (at most 8).
WINDOW_CASES: Dict[str, List[List[dict]]] = {
    # no lane reads a row another lane writes: the disjoint fast path;
    # balanceOf lanes have an empty write set
    "disjoint": [
        [_xfer(0, 100, 5), _xfer(1, 101, 6), _balance_of(2),
         _xfer(3, 102, 7), _balance_of(4)],
        [_xfer(5, 103, 8), _xfer(6, 104, 9), _xfer(7, 105, 10)],
    ],
    # every lane pays the next lane's sender: the sequential sweep, one
    # more committed lane per round
    "raw_chain": [[_xfer(10 + j, 11 + j, 100 + j) for j in range(6)]],
    # every swap conflicts through the reserve slots (premapped from the
    # pool's PUSH-constant footprint)
    "swap": [[_swap(1000 + 17 * j, 20 + j) for j in range(6)]],
    # a HOST lane (memory past mem_cap) and an unpremapped lane (F_MISS)
    # escape: the block ends after the round that found them, while the
    # other lanes validate around them
    "host_and_miss": [[
        _xfer(30, 31, 5), lane(ESCAPER_CODE, caller=_holder(32)),
        _xfer(33, 34, 6), _xfer(35, 36, 7, premap=False),
        _xfer(31, 37, 8)]],
    # three blocks, each reading the previous block's writes through
    # the table, with per-block words stored by a context lane
    "chained_blocks": [
        [_xfer(40, 41, 50), _context(0), _xfer(44, 45, 3)],
        [_xfer(41, 42, 60), _context(1), _xfer(45, 46, 4)],
        [_xfer(42, 43, 70), _context(2), _xfer(46, 47, 5)],
    ],
    # stack underflow, undefined, INVALID, PUSH0 (defined from Durango
    # on), and blind SSTOREs that OOG on a premapped or missed slot
    "errors": [
        CASES["errors"],
        [lane(push(9) + push(3) + "55" + "00", gas=g, storage={_k(3): 7},
              address=_addr(i), premap=[_k(3)] if i % 2 == 0 else ())
         for i, g in enumerate((10_000, 5_006, 5_005, 23_000, 2_300))],
    ],
}


# Blocks wider than one CTA of the window kernel's group (16 lanes a
# CTA: lanes 0-15 and 16-31 land on different CTAs at batch 32), each
# pinning one case of the sweep that walks in order only the lanes an
# earlier potential writer can touch.
def _blind(slot: int, value: int, premap=(), caller=0, gas=60_000) -> dict:
    """SSTORE ``value`` into ``slot`` of CONTRACT without an SLOAD;
    ``premap`` slots ride in the lane's cache (touched or not)."""
    return lane(push(value) + push(slot) + "55" + "00", gas=gas,
                storage={_k(s): 1000 + s for s in premap},
                caller=_holder(700 + caller),
                premap=[_k(s) for s in premap])


def _fill(n: int, base: int) -> list:
    return [_xfer(base + 2 * j, base + 2 * j + 1, 3 + j) for j in range(n)]


SWEEP_CASES: Dict[str, List[List[dict]]] = {
    # lane 3 (CTA 0) pays holder 301, whom lane 20 (CTA 1) then pays
    # from: the later reader re-runs on the earlier writer's value
    "early_writer_later_reader": [
        _fill(3, 200) + [_xfer(300, 301, 40)] + _fill(16, 220)
        + [_xfer(301, 302, 25)] + _fill(6, 260)],
    # two writers of holder 311's balance in two CTAs, and a third that
    # errs (out of gas): the last valid writer's value is the table's
    "last_valid_writer_wins": [
        _fill(2, 400) + [_xfer(310, 311, 7)] + _fill(15, 420)
        + [_xfer(312, 311, 9)] + _fill(4, 460)
        + [_xfer(313, 311, 11, gas=10_000)] + _fill(3, 480)],
    # lane 1 writes slot 4, lane 2 slot 3; lane 20 writes slot 3 with
    # slot 4 premapped but untouched (it re-runs, seeded with both
    # earlier writes); lane 21 overlaps the writers only in slot 4,
    # which it carries and neither reads nor writes
    "write_only_overlap": [
        [_xfer(500, 501, 1), _blind(4, 9, (4,), 1), _blind(3, 8, (3,), 2)]
        + _fill(17, 520)
        + [_blind(3, 5, (3, 4), 3), _blind(5, 6, (5, 4), 4)]
        + _fill(5, 560)],
    # 32 transfers between distinct holders: every lane independent
    "disjoint_wide": [_fill(32, 600), _fill(20, 680)],
    # lane 4 escapes HOST in the first round, before lane 22, which
    # depends on lane 1's write: the round still validates lane 22
    "escape_before_dependent": [
        [_xfer(800, 801, 5), _xfer(802, 803, 6), _fill(1, 810)[0],
         _xfer(804, 805, 7), lane(ESCAPER_CODE, caller=_holder(806))]
        + _fill(17, 820) + [_xfer(803, 807, 3)] + _fill(5, 870)],
}


# A block of 64 lanes with a 1024-entry storage cache: B*S = 65536
# entries, past what an int16 index holds, so the sweep's index columns
# are int32 (and its area in device memory).  Its writers and dependent
# lanes sit past entry 32767 (lanes 32 on): lane 32 pays holder 971,
# lane 49 pays from 971, lane 63 pays 971 again (the last valid writer).
WIDE_INDEX_BLOCKS = [
    _fill(32, 900) + [_xfer(970, 971, 40)] + _fill(16, 980)
    + [_xfer(971, 972, 25)] + _fill(13, 1020) + [_xfer(973, 971, 9)]]
WIDE_INDEX_SHAPE = dict(batch=64, scache_cap=1024)


# The program set every WINDOW_CASES window shares when it specialises
# (the reference compiles its window program once for all of them):
# each eligible code of the cases, in a fixed order.
BLIND_SSTORE_CODE = bytes.fromhex(push(9) + push(3) + "55" + "00")
SPEC_CODES = (TOKEN_RUNTIME, POOL_RUNTIME, _context(0)["code"],
              bytes.fromhex("0100"), bytes.fromhex("6001fe"),
              bytes.fromhex("5f00"), BLIND_SSTORE_CODE)


def k7_window(fans: bool = True) -> List[List[dict]]:
    """Traced and generic lanes in one window: token transfers, one
    whose amount exceeds the balance (the traced REVERT leaf) and one
    out of gas at the first lumped flush, swaps, lanes of a computed-jump
    contract (trace-ineligible: the interpreter) and, with ``fans``
    (program set ``k7_spec_codes()``), the keccak fan (more
    host-evaluable keccaks than kdig slots, plus a device keccak) and, in
    the last block, the slot fan (a full storage cache: HOST)."""
    from chip_smoke import JUMPER_CODE, KECCAK_FAN_CODE, SLOT_FAN_CODE
    jumper = dict(lane(JUMPER_CODE, (4).to_bytes(32, "big"), gas=50_000,
                       address=_addr(12)), caller=_holder(70))
    fan = [lane(KECCAK_FAN_CODE, (77 + i).to_bytes(32, "big"),
                gas=200_000, address=_addr(13), caller=_holder(71 + i),
                premap=[_k(0), _k(1)]) for i in range(2)]
    slots = lane(SLOT_FAN_CODE, (1000).to_bytes(32, "big"), gas=1_000_000,
                 address=_addr(14), caller=_holder(73))
    blocks = [
        [_xfer(80, 81, 5), _swap(1111, 82), _xfer(83, 84, 10**12),
         jumper, fan[0], _xfer(85, 86, 6), _swap(2222, 87),
         _xfer(88, 89, 7, gas=40)],
        [_xfer(81, 90, 8), fan[1], _swap(3333, 91), dict(jumper),
         _xfer(92, 93, 9), slots],
    ]
    if not fans:
        blocks = [[ln for ln in b if ln["code"] not in (
            KECCAK_FAN_CODE, SLOT_FAN_CODE)] for b in blocks]
    return blocks


def k7_spec_codes() -> tuple:
    from chip_smoke import KECCAK_FAN_CODE, SLOT_FAN_CODE
    return (TOKEN_RUNTIME, POOL_RUNTIME, KECCAK_FAN_CODE, SLOT_FAN_CODE)


def wide_cache_window() -> List[List[dict]]:
    """Two blocks of lanes with 40 premapped slots each (a 64-entry
    storage cache: more entries than a warp has threads), every lane
    incrementing slots 0..19 of its contract; lanes 0 and 1 of a block
    share a contract, so lane 1 re-runs."""
    code = bytes.fromhex("".join(push(k) + "54" + push(1) + "01" + push(k)
                                 + "55" for k in range(20)) + "00")
    keys = [_k(k) for k in range(40)]
    return [[lane(code, gas=2_000_000, address=_addr(8 + (i if i else 1)),
                  storage={_k(k): k for k in range(20)}, premap=keys,
                  caller=_holder(60 + 4 * b + i)) for i in range(4)]
            for b in range(2)]


def window_items(blocks, TxSpec, BlockEnv) -> list:
    """A window case as [(BlockEnv, [TxSpec])], one env per block (its
    words move with the block index); each lane's ``premap`` keys ride
    as its seeded storage view, which the window runner premaps."""
    items = []
    for b, lanes in enumerate(blocks):
        env = BlockEnv(coinbase=bytes([0x01 + b]) + b"\x00" * 19,
                       timestamp=TIME + 10 * b, number=NUMBER + b,
                       gas_limit=GAS_LIMIT - b, chain_id=CHAIN_ID,
                       base_fee=BASE_FEE + b)
        items.append((env, [TxSpec(
            code=ln["code"], calldata=ln["calldata"], gas=ln["gas"],
            value=ln["value"], caller=ln["caller"], address=ln["address"],
            origin=ln["caller"], gas_price=GAS_PRICE,
            storage={k: (0, 0) for k in ln["premap"]}) for ln in lanes]))
    return items


# the one shape every window case packs to (the reference compiles its
# window program once for all of them)
WINDOW_SHAPE = dict(batch=8, code_cap=512, data_cap=128, scache_cap=16)
WINDOW_BLOCKS = 4


def pack_window(name, device="cpu", spec_codes=None,
                batch: int = WINDOW_SHAPE["batch"],
                scache_cap: int = WINDOW_SHAPE["scache_cap"]) -> dict:
    """Window case ``name`` (or a list of blocks) packed by the port's
    ``MachineWindowRunner`` at ``WINDOW_SHAPE`` with ``batch`` lanes and
    ``scache_cap`` cache entries a lane: {p, occ, table, key_tab,
    inputs, spec, ...}.
    Without ``spec_codes`` every lane runs the generic interpreter
    (prog_id -1); with it, the runner specialises, its program set
    seeded with those codes in that order (so every case can share one
    set), and the lanes of any further eligible code join it.  The
    process-wide learned premap recipes are cleared first: a lane the
    case leaves unpremapped must miss, whatever an earlier replay in the
    process learned."""
    from coreth_tpu_torch.evm.device import adapter as A
    A.RECIPES.clear()
    blocks = (WINDOW_CASES.get(name) or SWEEP_CASES[name]
              if isinstance(name, str) else name)
    runner = A.MachineWindowRunner(
        "durango", resolver_for([ln for b in blocks for ln in b]),
        device=device, specialize=spec_codes is not None)
    for code in spec_codes or ():
        runner._spec_id(code)
    runner._hw.update(blocks=WINDOW_BLOCKS, **dict(
        WINDOW_SHAPE, batch=batch, scache_cap=scache_cap))
    return runner.pack(window_items(blocks, A.TxSpec, A.BlockEnv))


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


def batch_lanes(fork: str, B: int, TxSpec) -> list:
    """B TxSpecs cycling through every case of the fork (the durango
    catalog, and cancun's transient cases with it), every other lane with
    up to four slots of its contract's committed storage seeded into its
    cache: one mixed batch for the step machine's batch and layout
    tests."""
    cases = dict(CASES, **(CANCUN_CASES if fork == "cancun" else {}))
    lanes = [ln for name in sorted(cases) for ln in cases[name]]
    txs = specs([lanes[i % len(lanes)] for i in range(B)], TxSpec)
    for i, t in enumerate(txs):
        if i % 2:
            src = lanes[i % len(lanes)]["storage"]
            t.storage = {k: (v, v) for k, v in list(src.items())[:4]}
    return txs


def sha3_lanes() -> list:
    """Lanes that copy 300 calldata bytes into memory and hash ``n`` of
    them (SHA3) from start offsets 0-3 (byte 8 + offset), at lengths
    around the 136-byte block (and 0, 1, 271), then store the digest at
    slot 0; and four that hash the memory's last bytes (mem_cap 4096)."""
    data = bytes((7 * i + 3) & 0xFF for i in range(300))

    def sha3(dest, off, n):
        return lane(push(len(data)) + push(0) + push(dest) + "37"
                    + push(n) + push(off) + "20" + push(0) + "55" + "00",
                    calldata=data, gas=200_000)
    lanes = [sha3(0, 8 + off, n)
             for n in (0, 1, 4, 31, 64, 132, 133, 134, 135, 136, 137, 138,
                       139, 140, 200, 271) for off in range(4)]
    return lanes + [sha3(4096 - 300, off, n) for n, off in (
        (271, 4096 - 271), (136, 4096 - 137), (3, 4093), (0, 4096))]


def env(BlockEnv):
    return BlockEnv(coinbase=COINBASE, timestamp=TIME, number=NUMBER,
                    gas_limit=GAS_LIMIT, chain_id=CHAIN_ID,
                    base_fee=BASE_FEE)


def sharded_window(n: int, sync: bool, seed: int = 0, spec_codes=None,
                   device="cpu", names=None, batch: int = 8) -> dict:
    """A sharded window of K9's layout: shard d runs window case
    ``names[d % len(names)]`` (default ``sorted(WINDOW_CASES)``, packed
    at ``batch`` lanes) on its lanes and its arena (every
    case packs to ``WINDOW_SHAPE``, ``WINDOW_BLOCKS`` blocks and a
    64-row table, and their blocks' inputs agree where they have lanes).  With ``sync`` a
    key-range sync set of 64 rows: each shard's first (up to) three
    table rows its lanes use have copies at spare rows (63 - j) of some
    other shards, seeded with random values, the owner drawn among the
    copies; padding rows name no copy.  Only the using shard's lanes
    touch a key, so a block has at most one writer per key.  Returns
    {p, occ, table, key_tab, inputs, spec, n, sync_rows}."""
    import numpy as np
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    names = names or sorted(WINDOW_CASES)
    pks = [pack_window(names[d % len(names)], spec_codes=spec_codes,
                       batch=batch) for d in range(n)]
    p, occ, spec = pks[0]["p"], pks[0]["occ"], pks[0]["spec"]
    G = occ.table_cap
    # block inputs: those of the longest case (a block where a case has
    # no lane reads none of them)
    longest = max(pks, key=lambda pk: int(pk["inputs"]["active"].any(
        dim=1).sum()))
    inputs = {}
    for k, v in longest["inputs"].items():
        if k in M._OCC_LANE_INPUTS:
            inputs[k] = torch.cat([pk["inputs"][k] for pk in pks], dim=1)
        else:
            for pk in pks:
                live = pk["inputs"]["active"].any(dim=1)
                if k != "chainid_w":
                    assert torch.equal(pk["inputs"][k][live], v[live]), k
            inputs[k] = v
    assert all(pk["spec"] == spec and pk["p"] == p for pk in pks)
    table = torch.cat([pk["table"] for pk in pks])
    key_tab = torch.cat([pk["key_tab"] for pk in pks])
    rows = None
    if sync:
        rng = np.random.default_rng(seed)
        rows = np.full((64, n + 1), G, dtype=np.int32)
        j = 0
        for u in range(n):
            sg = pks[u]["inputs"]["sgid"]
            for r in sg[sg < G].unique().tolist()[:3]:
                rows[j, u] = r
                for s in range(n):
                    if s != u and (j + s) % 3 != 0:
                        rows[j, s] = 63 - j
                        table[s * G + 63 - j] = torch.from_numpy(
                            rng.integers(0, 1 << 16, 16).astype(np.int32))
                rows[j, n] = rng.choice(np.flatnonzero(rows[j, :n] < G))
                j += 1
        rows = torch.from_numpy(rows).to(device)
    return dict(p=p, occ=occ, spec=spec, n=n, sync_rows=rows,
                table=table.to(device), key_tab=key_tab.to(device),
                inputs={k: v.to(device) for k, v in inputs.items()})
