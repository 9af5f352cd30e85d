"""ERC-20 token workload.

Port of reference ``workloads/erc20.py``: a hand-assembled minimal
token contract (transfer + balanceOf over a balances mapping at storage
slot 0, Transfer event, unchecked classic semantics).  Hand assembly
keeps the execution path — and thus the gas schedule — small and
auditable.  Its per-transfer execution gas is measured, not
hand-derived: one ``EVM.call`` per variant
(``measure_transfer_exec_gas``).

Storage layout: balances[addr] at keccak256(pad32(addr) ++ pad32(0)) —
the Solidity mapping rule the reference's state tests rely on.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

from coreth_tpu_torch.crypto import keccak256, keccak256_py

TRANSFER_SELECTOR = bytes.fromhex("a9059cbb")
BALANCEOF_SELECTOR = bytes.fromhex("70a08231")
# keccak256("Transfer(address,address,uint256)")
TRANSFER_TOPIC = keccak256_py(b"Transfer(address,address,uint256)")

_OPS = {
    "STOP": 0x00, "ADD": 0x01, "SUB": 0x03, "LT": 0x10, "GT": 0x11,
    "EQ": 0x14, "SHR": 0x1C, "SHA3": 0x20, "CALLER": 0x33,
    "CALLDATALOAD": 0x35, "MSTORE": 0x52, "SLOAD": 0x54, "SSTORE": 0x55,
    "JUMPI": 0x57, "JUMPDEST": 0x5B, "LOG3": 0xA3, "RETURN": 0xF3,
    "REVERT": 0xFD, "DUP1": 0x80, "DUP2": 0x81, "DUP3": 0x82,
    "SWAP1": 0x90,
}


def _assemble(program: List, ops: Dict[str, int] = None) -> bytes:
    """Two-pass assembler: items are opcode names, ("PUSH", bytes),
    ("PUSHL", label) 2-byte label pushes, or ("LABEL", name).
    `ops` overrides the opcode table (workloads/swap.py extends it)."""
    _ops = ops or _OPS
    # pass 1: layout
    offsets: Dict[str, int] = {}
    pc = 0
    for item in program:
        if isinstance(item, str):
            pc += 1
        elif item[0] == "LABEL":
            offsets[item[1]] = pc
            pc += 1                      # JUMPDEST emitted at the label
        elif item[0] == "PUSH":
            pc += 1 + len(item[1])
        elif item[0] == "PUSHL":
            pc += 3                      # PUSH2 + 2-byte offset
        else:
            raise ValueError(item)
    # pass 2: emit
    out = bytearray()
    for item in program:
        if isinstance(item, str):
            out.append(_ops[item])
        elif item[0] == "LABEL":
            out.append(_OPS["JUMPDEST"])
        elif item[0] == "PUSH":
            data = item[1]
            out.append(0x5F + len(data))     # PUSH1..PUSH32
            out += data
        elif item[0] == "PUSHL":
            out.append(0x61)                 # PUSH2
            out += offsets[item[1]].to_bytes(2, "big")
    return bytes(out)


def _b1(v: int) -> Tuple[str, bytes]:
    return ("PUSH", bytes([v]))


TOKEN_RUNTIME = _assemble([
    # dispatcher: selector = calldataload(0) >> 224
    _b1(0x00), "CALLDATALOAD", _b1(0xE0), "SHR",
    "DUP1", ("PUSH", TRANSFER_SELECTOR), "EQ", ("PUSHL", "transfer"),
    "JUMPI",
    "DUP1", ("PUSH", BALANCEOF_SELECTOR), "EQ", ("PUSHL", "balanceOf"),
    "JUMPI",
    _b1(0x00), _b1(0x00), "REVERT",

    # transfer(address to, uint256 amt)
    ("LABEL", "transfer"),
    _b1(0x24), "CALLDATALOAD",                       # [amt]
    "CALLER", _b1(0x00), "MSTORE",
    _b1(0x00), _b1(0x20), "MSTORE",
    _b1(0x40), _b1(0x00), "SHA3",                    # [amt, fromKey]
    "DUP1", "SLOAD",                                 # [amt, fK, fromBal]
    "DUP3", "DUP2", "LT",                            # fromBal < amt ?
    ("PUSHL", "revert"), "JUMPI",                    # [amt, fK, fromBal]
    "DUP3", "SWAP1", "SUB",                          # [amt, fK, fromBal-amt]
    "SWAP1", "SSTORE",                               # [amt]
    _b1(0x04), "CALLDATALOAD",                       # [amt, to]
    _b1(0x00), "MSTORE",                             # [amt] mem0 = to
    _b1(0x40), _b1(0x00), "SHA3",                    # [amt, toKey]
    "DUP1", "SLOAD",                                 # [amt, toKey, toBal]
    "DUP3", "ADD",                                   # [amt, toKey, toBal+amt]
    "SWAP1", "SSTORE",                               # [amt]
    # emit Transfer(caller, to, amt)
    "DUP1", _b1(0x00), "MSTORE",
    _b1(0x04), "CALLDATALOAD",                       # [amt, to]
    "CALLER",                                        # [amt, to, caller]
    ("PUSH", TRANSFER_TOPIC),                        # [amt, to, from, sig]
    _b1(0x20), _b1(0x00),                            # [.., size, offset]
    "LOG3",                                          # [amt]
    _b1(0x01), _b1(0x00), "MSTORE",
    _b1(0x20), _b1(0x00), "RETURN",

    ("LABEL", "revert"),
    _b1(0x00), _b1(0x00), "REVERT",

    # balanceOf(address)
    ("LABEL", "balanceOf"),
    _b1(0x04), "CALLDATALOAD", _b1(0x00), "MSTORE",
    _b1(0x00), _b1(0x20), "MSTORE",
    _b1(0x40), _b1(0x00), "SHA3", "SLOAD",
    _b1(0x00), "MSTORE",
    _b1(0x20), _b1(0x00), "RETURN",
])

TOKEN_CODE_HASH = keccak256_py(TOKEN_RUNTIME)



@lru_cache(maxsize=1 << 17)
def balance_slot(addr: bytes) -> bytes:
    """Storage slot key of balances[addr] (mapping slot 0).  Memoized:
    the replay classifier derives two slot keys per token tx and the
    sender/recipient population recurs across blocks, so the keccak
    runs once per address instead of once per tx."""
    return keccak256(b"\x00" * 12 + addr + b"\x00" * 32)


def transfer_calldata(to: bytes, amount: int) -> bytes:
    return (TRANSFER_SELECTOR + b"\x00" * 12 + to
            + amount.to_bytes(32, "big"))


def parse_transfer_calldata(data: bytes):
    """(to, amount) if data is a well-formed transfer call, else None."""
    if len(data) != 68 or data[:4] != TRANSFER_SELECTOR:
        return None
    if any(data[4:16]):
        return None
    return data[16:36], int.from_bytes(data[36:68], "big")


def token_genesis_account(balances: Dict[bytes, int]):
    """GenesisAccount for the token with pre-funded balances."""
    from coreth_tpu_torch.chain import GenesisAccount
    storage = {balance_slot(addr): v.to_bytes(32, "big")
               for addr, v in balances.items()}
    return GenesisAccount(balance=0, code=TOKEN_RUNTIME, nonce=1,
                          storage=storage)


_EXEC_GAS_CACHE: Dict[tuple, int] = {}


def measure_transfer_exec_gas(config, number: int, time: int,
                              variant: str = "reset") -> int:
    """Execution gas of one transfer() call under the rules of block
    (number, time), measured by one ``EVM.call`` on a scratch state (the
    native session serves it from Apricot Phase 2 on, the host
    interpreter before).

    Variants (the only gas classes a successful non-self transfer can
    hit from Apricot Phase 1 on, where refunds are off, so zeroing the
    from-slot costs what a partial spend does):
      - "reset": both slots nonzero before, a partial amount (SSTORE
        nonzero -> nonzero on both);
      - "set":   the to-slot zero before (SSTORE zero -> nonzero on the
        credit side);
      - "noop":  amount 0 (both SSTOREs write the current value).

    The slots are seeded and committed first, so SSTORE sees committed
    original values (EIP-2200 prices the reset paths by them).  Cached
    per (chain id, variant, fork flags)."""
    # key on fork-schedule identity, not id(config): gas depends only on
    # the rules
    rules = config.rules(number, time)
    key = (config.chain_id, variant) + tuple(
        getattr(rules, f) for f in sorted(vars(rules))
        if f.startswith("is_"))
    cached = _EXEC_GAS_CACHE.get(key)
    if cached is not None:
        return cached
    from coreth_tpu_torch.evm.evm import EVM, BlockContext, Config, TxContext
    from coreth_tpu_torch.state import StateDB, StateStore

    sender, recip, token = b"\x11" * 20, b"\x22" * 20, b"\x33" * 20
    store = StateStore()
    statedb = StateDB(store)
    statedb.set_code(token, TOKEN_RUNTIME)
    statedb.set_state(token, balance_slot(sender),
                      (10**20).to_bytes(32, "big"))
    if variant != "set":
        statedb.set_state(token, balance_slot(recip),
                          (1).to_bytes(32, "big"))
    statedb.add_balance(sender, 10**18)
    # commit + reopen so SSTORE sees real committed "original" values
    statedb.commit(False)
    statedb = StateDB(store)
    block_ctx = BlockContext(coinbase=b"\x00" * 20, number=number,
                             time=time, gas_limit=8_000_000)
    evm = EVM(block_ctx, TxContext(origin=sender, gas_price=0), statedb,
              config, Config())
    statedb.prepare(rules, sender, block_ctx.coinbase, token,
                    list(rules.active_precompiles), [])
    gas_limit = 200_000
    amount = 0 if variant == "noop" else 1000
    _ret, gas_left, err = evm.call(sender, token,
                                   transfer_calldata(recip, amount),
                                   gas_limit, 0)
    if err is not None:
        raise RuntimeError(f"token gas probe failed: {err}")
    _EXEC_GAS_CACHE[key] = gas_limit - gas_left
    return _EXEC_GAS_CACHE[key]
