"""The EVM interpreter — fetch/decode/execute with exact gas accounting.

Port of reference ``evm/interpreter.py`` (``analyze_jumpdests`` is also
what the device tables and the tracer read).  Twin of reference
core/vm/interpreter.go:121 (Run) + core/vm/instructions.go.  A
``Frame`` is the reference's Contract: code, input, gas, value, and the
storage-context address.  All 256-bit words are Python ints on the host
path (the device path uses 16-bit limb arrays — coreth_tpu_torch.ops).
"""

from __future__ import annotations

from typing import List, Optional

from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.evm import vmerrs
from coreth_tpu_torch.params import protocol as P

U256 = (1 << 256) - 1
U255 = 1 << 255
ADDR_MASK = (1 << 160) - 1
UINT64_MAX = (1 << 64) - 1
HASH_ZERO = b"\x00" * 32


def to_signed(x: int) -> int:
    return x - (1 << 256) if x >= U255 else x


def to_unsigned(x: int) -> int:
    return x & U256


class Frame:
    """Per-call execution frame (reference core/vm/contract.go)."""

    __slots__ = ("caller", "address", "code", "code_hash", "input", "gas",
                 "value", "memory", "jumpdests")

    def __init__(self, caller: bytes, address: bytes, code: bytes,
                 input_: bytes, gas: int, value: int,
                 code_hash: bytes = HASH_ZERO):
        self.caller = caller
        self.address = address
        self.code = code
        self.code_hash = code_hash
        self.input = input_
        self.gas = gas
        self.value = value
        self.memory = bytearray()
        self.jumpdests: Optional[set] = None

    def use_gas(self, amount: int) -> None:
        if self.gas < amount:
            raise vmerrs.ErrOutOfGas()
        self.gas -= amount

    def valid_jumpdest(self, dest: int) -> bool:
        if dest >= len(self.code) or self.code[dest] != 0x5B:
            return False
        if self.jumpdests is None:
            self.jumpdests = analyze_jumpdests(self.code)
        return dest in self.jumpdests


def analyze_jumpdests(code: bytes) -> set:
    """Positions of JUMPDEST bytes not inside PUSH data
    (reference core/vm/analysis.go codeBitmap)."""
    dests = set()
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        if op == 0x5B:
            dests.add(i)
            i += 1
        elif 0x60 <= op <= 0x7F:
            i += op - 0x5F + 1
        else:
            i += 1
    return dests


def mem_extend(memory: bytearray, size: int) -> None:
    if size > len(memory):
        # memory grows in 32-byte words
        new_size = ((size + 31) // 32) * 32
        memory.extend(b"\x00" * (new_size - len(memory)))


def mem_read(memory: bytearray, offset: int, size: int) -> bytes:
    if size == 0:
        return b""
    return bytes(memory[offset:offset + size])


def mem_write(memory: bytearray, offset: int, data: bytes) -> None:
    if data:
        memory[offset:offset + len(data)] = data


def get_data(data: bytes, start: int, size: int) -> bytes:
    """Zero-padded slice (common.GetData)."""
    if size == 0:
        return b""
    start = min(start, len(data))
    end = min(start + size, len(data))
    return data[start:end].ljust(size, b"\x00")


class Halt(Exception):
    """Normal termination carrying return data (STOP/RETURN/SELFDESTRUCT)."""

    def __init__(self, data: bytes = b""):
        self.data = data


class Revert(Exception):
    def __init__(self, data: bytes):
        self.data = data


class Interpreter:
    """Runs one frame to completion against an EVM instance."""

    def __init__(self, evm):
        self.evm = evm
        self.table = evm.jump_table
        self.read_only = False
        self.return_data = b""

    def run(self, frame: Frame, read_only: bool) -> bytes:
        """Execute frame code (interpreter.go:121 Run).

        Returns the output; raises vmerrs on failure; Revert surfaces as
        vmerrs.ErrExecutionReverted with .data attached by the EVM layer.
        """
        evm = self.evm
        evm.depth += 1
        prev_read_only = self.read_only
        if read_only:
            self.read_only = True
        self.return_data = b""
        try:
            if not frame.code:
                return b""
            stack: List[int] = []
            pc = 0
            code = frame.code
            table = self.table
            # debug branch of the hot loop (interpreter.go:186-258):
            # per-op CaptureState/CaptureFault when a tracer is attached
            tracer = evm.config.tracer
            while True:
                if pc >= len(code):
                    raise Halt()
                op = code[pc]
                operation = table[op]
                gas_before = frame.gas
                try:
                    if operation is None:
                        raise vmerrs.ErrInvalidOpCode(f"opcode {op:#x}")
                    if len(stack) < operation.min_stack:
                        raise vmerrs.ErrStackUnderflow(
                            f"op {op:#x} stack {len(stack)}")
                    if len(stack) > operation.max_stack:
                        raise vmerrs.ErrStackOverflow()
                    if self.read_only and operation.writes:
                        raise vmerrs.ErrWriteProtection()
                    if operation.constant_gas:
                        frame.use_gas(operation.constant_gas)
                    memory_size = 0
                    if operation.memory_size is not None:
                        memory_size = operation.memory_size(stack)
                        if memory_size > UINT64_MAX:
                            raise vmerrs.ErrGasUintOverflow()
                    if operation.dynamic_gas is not None:
                        dgas = operation.dynamic_gas(
                            evm, frame, stack, memory_size)
                        frame.use_gas(dgas)
                    if memory_size > 0:
                        mem_extend(frame.memory, memory_size)
                    if tracer is not None:
                        tracer.capture_state(
                            pc, op, gas_before, gas_before - frame.gas,
                            frame, stack, self.return_data, evm.depth)
                    pc = operation.execute(self, frame, stack, pc)
                except (Halt, Revert):
                    raise
                except vmerrs.VMError as e:
                    if tracer is not None:
                        tracer.capture_fault(
                            pc, op, gas_before, gas_before - frame.gas,
                            frame, stack, evm.depth, e)
                    raise
        except Halt as h:
            return h.data
        except Revert as r:
            self.return_data = r.data
            err = vmerrs.ErrExecutionReverted()
            err.data = r.data
            raise err
        finally:
            evm.depth -= 1
            self.read_only = prev_read_only


# ---------------------------------------------------------------------------
# Instruction implementations.  Signature: (interp, frame, stack, pc) -> pc.

def make_arith2(fn):
    def op(interp, frame, stack, pc):
        a = stack.pop()
        b = stack.pop()
        stack.append(fn(a, b))
        return pc + 1
    return op


def make_arith3(fn):
    def op(interp, frame, stack, pc):
        a = stack.pop()
        b = stack.pop()
        c = stack.pop()
        stack.append(fn(a, b, c))
        return pc + 1
    return op


op_add = make_arith2(lambda a, b: (a + b) & U256)
op_mul = make_arith2(lambda a, b: (a * b) & U256)
op_sub = make_arith2(lambda a, b: (a - b) & U256)
op_div = make_arith2(lambda a, b: a // b if b else 0)
op_mod = make_arith2(lambda a, b: a % b if b else 0)


def _sdiv(a, b):
    if b == 0:
        return 0
    sa, sb = to_signed(a), to_signed(b)
    q = abs(sa) // abs(sb)
    if (sa < 0) != (sb < 0):
        q = -q
    return to_unsigned(q)


def _smod(a, b):
    if b == 0:
        return 0
    sa, sb = to_signed(a), to_signed(b)
    r = abs(sa) % abs(sb)
    return to_unsigned(-r if sa < 0 else r)


op_sdiv = make_arith2(_sdiv)
op_smod = make_arith2(_smod)
op_addmod = make_arith3(lambda a, b, n: (a + b) % n if n else 0)
op_mulmod = make_arith3(lambda a, b, n: (a * b) % n if n else 0)
op_exp = make_arith2(lambda a, b: pow(a, b, 1 << 256))


def _signextend(nbytes, x):
    if nbytes >= 31:
        return x
    bit = nbytes * 8 + 7
    mask = (1 << (bit + 1)) - 1
    if x & (1 << bit):
        return x | (U256 ^ mask)
    return x & mask


op_signextend = make_arith2(_signextend)
op_lt = make_arith2(lambda a, b: 1 if a < b else 0)
op_gt = make_arith2(lambda a, b: 1 if a > b else 0)
op_slt = make_arith2(lambda a, b: 1 if to_signed(a) < to_signed(b) else 0)
op_sgt = make_arith2(lambda a, b: 1 if to_signed(a) > to_signed(b) else 0)
op_eq = make_arith2(lambda a, b: 1 if a == b else 0)


def op_iszero(interp, frame, stack, pc):
    stack[-1] = 1 if stack[-1] == 0 else 0
    return pc + 1


op_and = make_arith2(lambda a, b: a & b)
op_or = make_arith2(lambda a, b: a | b)
op_xor = make_arith2(lambda a, b: a ^ b)


def op_not(interp, frame, stack, pc):
    stack[-1] = stack[-1] ^ U256
    return pc + 1


def _byte(i, x):
    if i >= 32:
        return 0
    return (x >> (8 * (31 - i))) & 0xFF


op_byte = make_arith2(_byte)
op_shl = make_arith2(lambda shift, x: (x << shift) & U256 if shift < 256 else 0)
op_shr = make_arith2(lambda shift, x: x >> shift if shift < 256 else 0)


def _sar(shift, x):
    sx = to_signed(x)
    if shift >= 256:
        return to_unsigned(-1 if sx < 0 else 0)
    return to_unsigned(sx >> shift)


op_sar = make_arith2(_sar)


def op_keccak256(interp, frame, stack, pc):
    offset = stack.pop()
    size = stack.pop()
    data = mem_read(frame.memory, offset, size)
    stack.append(int.from_bytes(keccak256(data), "big"))
    return pc + 1


# --- environment -----------------------------------------------------------

def op_address(interp, frame, stack, pc):
    stack.append(int.from_bytes(frame.address, "big"))
    return pc + 1


def op_balance(interp, frame, stack, pc):
    addr = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    stack.append(interp.evm.statedb.get_balance(addr))
    return pc + 1


def op_balancemc(interp, frame, stack, pc):
    """BALANCEMC (0xcd): multicoin balance (pre-AP2 only)."""
    addr = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    coin_id = stack.pop().to_bytes(32, "big")
    stack.append(interp.evm.statedb.get_balance_multi_coin(addr, coin_id))
    return pc + 1


def op_origin(interp, frame, stack, pc):
    stack.append(int.from_bytes(interp.evm.tx_ctx.origin, "big"))
    return pc + 1


def op_caller(interp, frame, stack, pc):
    stack.append(int.from_bytes(frame.caller, "big"))
    return pc + 1


def op_callvalue(interp, frame, stack, pc):
    stack.append(frame.value)
    return pc + 1


def op_calldataload(interp, frame, stack, pc):
    offset = stack.pop()
    if offset > len(frame.input):
        stack.append(0)
    else:
        stack.append(int.from_bytes(get_data(frame.input, offset, 32), "big"))
    return pc + 1


def op_calldatasize(interp, frame, stack, pc):
    stack.append(len(frame.input))
    return pc + 1


def op_calldatacopy(interp, frame, stack, pc):
    mem_off = stack.pop()
    data_off = stack.pop()
    size = stack.pop()
    data_off = min(data_off, len(frame.input))
    mem_write(frame.memory, mem_off, get_data(frame.input, data_off, size))
    return pc + 1


def op_codesize(interp, frame, stack, pc):
    stack.append(len(frame.code))
    return pc + 1


def op_codecopy(interp, frame, stack, pc):
    mem_off = stack.pop()
    code_off = stack.pop()
    size = stack.pop()
    code_off = min(code_off, len(frame.code))
    mem_write(frame.memory, mem_off, get_data(frame.code, code_off, size))
    return pc + 1


def op_gasprice(interp, frame, stack, pc):
    stack.append(interp.evm.tx_ctx.gas_price)
    return pc + 1


def op_extcodesize(interp, frame, stack, pc):
    addr = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    stack.append(interp.evm.statedb.get_code_size(addr))
    return pc + 1


def op_extcodecopy(interp, frame, stack, pc):
    addr = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    mem_off = stack.pop()
    code_off = stack.pop()
    size = stack.pop()
    code = interp.evm.statedb.get_code(addr)
    code_off = min(code_off, len(code))
    mem_write(frame.memory, mem_off, get_data(code, code_off, size))
    return pc + 1


def op_extcodehash(interp, frame, stack, pc):
    addr = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    db = interp.evm.statedb
    if db.empty(addr):
        stack.append(0)
    else:
        stack.append(int.from_bytes(db.get_code_hash(addr), "big"))
    return pc + 1


def op_returndatasize(interp, frame, stack, pc):
    stack.append(len(interp.return_data))
    return pc + 1


def op_returndatacopy(interp, frame, stack, pc):
    mem_off = stack.pop()
    data_off = stack.pop()
    size = stack.pop()
    if data_off + size > len(interp.return_data):
        raise vmerrs.ErrReturnDataOutOfBounds()
    mem_write(frame.memory, mem_off,
              interp.return_data[data_off:data_off + size])
    return pc + 1


# --- block context ---------------------------------------------------------

def op_blockhash(interp, frame, stack, pc):
    num = stack.pop()
    ctx = interp.evm.block_ctx
    if ctx.number > num >= max(ctx.number - 256, 0):
        stack.append(int.from_bytes(ctx.get_hash(num), "big"))
    else:
        stack.append(0)
    return pc + 1


def op_coinbase(interp, frame, stack, pc):
    stack.append(int.from_bytes(interp.evm.block_ctx.coinbase, "big"))
    return pc + 1


def op_timestamp(interp, frame, stack, pc):
    stack.append(interp.evm.block_ctx.time)
    return pc + 1


def op_number(interp, frame, stack, pc):
    stack.append(interp.evm.block_ctx.number)
    return pc + 1


def op_difficulty(interp, frame, stack, pc):
    stack.append(interp.evm.block_ctx.difficulty)
    return pc + 1


def op_gaslimit(interp, frame, stack, pc):
    stack.append(interp.evm.block_ctx.gas_limit)
    return pc + 1


def op_chainid(interp, frame, stack, pc):
    stack.append(interp.evm.chain_id)
    return pc + 1


def op_selfbalance(interp, frame, stack, pc):
    stack.append(interp.evm.statedb.get_balance(frame.address))
    return pc + 1


def op_basefee(interp, frame, stack, pc):
    stack.append(interp.evm.block_ctx.base_fee or 0)
    return pc + 1


# --- stack / memory / storage ---------------------------------------------

def op_pop(interp, frame, stack, pc):
    stack.pop()
    return pc + 1


def op_mload(interp, frame, stack, pc):
    offset = stack.pop()
    stack.append(int.from_bytes(mem_read(frame.memory, offset, 32), "big"))
    return pc + 1


def op_mstore(interp, frame, stack, pc):
    offset = stack.pop()
    value = stack.pop()
    mem_write(frame.memory, offset, value.to_bytes(32, "big"))
    return pc + 1


def op_mstore8(interp, frame, stack, pc):
    offset = stack.pop()
    value = stack.pop()
    frame.memory[offset] = value & 0xFF
    return pc + 1


def op_sload(interp, frame, stack, pc):
    key = stack.pop().to_bytes(32, "big")
    value = interp.evm.statedb.get_state(frame.address, key)
    stack.append(int.from_bytes(value, "big"))
    return pc + 1


def op_sstore(interp, frame, stack, pc):
    key = stack.pop().to_bytes(32, "big")
    value = stack.pop().to_bytes(32, "big")
    interp.evm.statedb.set_state(frame.address, key, value)
    return pc + 1


def op_tload(interp, frame, stack, pc):
    """EIP-1153 TLOAD (instructions.go opTload)."""
    key = stack.pop().to_bytes(32, "big")
    value = interp.evm.statedb.get_transient_state(frame.address, key)
    stack.append(int.from_bytes(value, "big"))
    return pc + 1


def op_tstore(interp, frame, stack, pc):
    """EIP-1153 TSTORE (instructions.go opTstore)."""
    key = stack.pop().to_bytes(32, "big")
    value = stack.pop().to_bytes(32, "big")
    interp.evm.statedb.set_transient_state(frame.address, key, value)
    return pc + 1


def op_mcopy(interp, frame, stack, pc):
    """EIP-5656 MCOPY: memory-to-memory copy."""
    dst = stack.pop()
    src = stack.pop()
    length = stack.pop()
    if length:
        data = mem_read(frame.memory, src, length)
        mem_write(frame.memory, dst, data)
    return pc + 1


def op_blobhash(interp, frame, stack, pc):
    """EIP-4844 BLOBHASH: the i-th versioned blob hash of the tx, or
    zero when out of range.  Avalanche carries no blob transactions,
    so every index is out of range (geth opBlobHash with empty
    BlobHashes)."""
    stack.pop()
    stack.append(0)
    return pc + 1


def op_blobbasefee(interp, frame, stack, pc):
    """EIP-7516 BLOBBASEFEE: with zero excess blob gas (no blob
    market on this chain) the fee sits at MIN_BLOB_GASPRICE = 1."""
    stack.append(getattr(interp.evm.block_ctx, "blob_base_fee", 1))
    return pc + 1


def op_jump(interp, frame, stack, pc):
    dest = stack.pop()
    if not frame.valid_jumpdest(dest):
        raise vmerrs.ErrInvalidJump()
    return dest


def op_jumpi(interp, frame, stack, pc):
    dest = stack.pop()
    cond = stack.pop()
    if cond:
        if not frame.valid_jumpdest(dest):
            raise vmerrs.ErrInvalidJump()
        return dest
    return pc + 1


def op_pc(interp, frame, stack, pc):
    stack.append(pc)
    return pc + 1


def op_msize(interp, frame, stack, pc):
    stack.append(len(frame.memory))
    return pc + 1


def op_gas(interp, frame, stack, pc):
    stack.append(frame.gas)
    return pc + 1


def op_jumpdest(interp, frame, stack, pc):
    return pc + 1


def op_push0(interp, frame, stack, pc):
    stack.append(0)
    return pc + 1


def make_push(n: int):
    def op(interp, frame, stack, pc):
        data = frame.code[pc + 1:pc + 1 + n]
        stack.append(int.from_bytes(data.ljust(n, b"\x00"), "big"))
        return pc + 1 + n
    return op


def make_dup(n: int):
    def op(interp, frame, stack, pc):
        stack.append(stack[-n])
        return pc + 1
    return op


def make_swap(n: int):
    def op(interp, frame, stack, pc):
        stack[-1], stack[-1 - n] = stack[-1 - n], stack[-1]
        return pc + 1
    return op


def make_log(n: int):
    def op(interp, frame, stack, pc):
        offset = stack.pop()
        size = stack.pop()
        topics = [stack.pop().to_bytes(32, "big") for _ in range(n)]
        data = mem_read(frame.memory, offset, size)
        from coreth_tpu_torch.types.receipt import Log
        interp.evm.statedb.add_log(Log(
            address=frame.address, topics=topics, data=data,
            block_number=interp.evm.block_ctx.number))
        return pc + 1
    return op


# --- calls / creates -------------------------------------------------------

def op_create(interp, frame, stack, pc):
    value = stack.pop()
    offset = stack.pop()
    size = stack.pop()
    init_code = mem_read(frame.memory, offset, size)
    gas = frame.gas
    if interp.evm.rules.is_eip150:
        gas -= gas // 64
    frame.use_gas(gas)
    ret, addr, left, err = interp.evm.create(frame.address, init_code, gas,
                                             value)
    frame.gas += left
    if err is None:
        stack.append(int.from_bytes(addr, "big"))
        interp.return_data = b""
    else:
        stack.append(0)
        interp.return_data = ret if isinstance(
            err, vmerrs.ErrExecutionReverted) else b""
    return pc + 1


def op_create2(interp, frame, stack, pc):
    value = stack.pop()
    offset = stack.pop()
    size = stack.pop()
    salt = stack.pop()
    init_code = mem_read(frame.memory, offset, size)
    gas = frame.gas
    gas -= gas // 64  # CREATE2 is post-EIP150 everywhere
    frame.use_gas(gas)
    ret, addr, left, err = interp.evm.create2(frame.address, init_code, gas,
                                              value, salt)
    frame.gas += left
    if err is None:
        stack.append(int.from_bytes(addr, "big"))
        interp.return_data = b""
    else:
        stack.append(0)
        interp.return_data = ret if isinstance(
            err, vmerrs.ErrExecutionReverted) else b""
    return pc + 1


def _call_common(interp, frame, stack, pc, variant: str):
    evm = interp.evm
    gas = stack.pop()  # replaced by call_gas_temp (63/64 already applied)
    addr = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    value = stack.pop() if variant in ("call", "callcode") else 0
    in_off = stack.pop()
    in_size = stack.pop()
    out_off = stack.pop()
    out_size = stack.pop()
    args = mem_read(frame.memory, in_off, in_size)
    gas = evm.call_gas_temp
    if value != 0 and variant == "call":
        gas += P.CALL_STIPEND
    if value != 0 and variant == "callcode":
        gas += P.CALL_STIPEND
    if variant == "call":
        if interp.read_only and value != 0:
            raise vmerrs.ErrWriteProtection()
        ret, left, err = evm.call(frame.address, addr, args, gas, value)
    elif variant == "callcode":
        ret, left, err = evm.call_code(frame.address, addr, args, gas, value)
    elif variant == "delegatecall":
        ret, left, err = evm.delegate_call(frame, addr, args, gas)
    else:
        ret, left, err = evm.static_call(frame.address, addr, args, gas)
    stack.append(0 if err is not None else 1)
    if err is None or isinstance(err, vmerrs.ErrExecutionReverted):
        mem_write(frame.memory, out_off, ret[:out_size])
    frame.gas += left
    interp.return_data = ret
    return pc + 1


def op_call(interp, frame, stack, pc):
    return _call_common(interp, frame, stack, pc, "call")


def op_callcode(interp, frame, stack, pc):
    return _call_common(interp, frame, stack, pc, "callcode")


def op_delegatecall(interp, frame, stack, pc):
    return _call_common(interp, frame, stack, pc, "delegatecall")


def op_staticcall(interp, frame, stack, pc):
    return _call_common(interp, frame, stack, pc, "staticcall")


def op_return(interp, frame, stack, pc):
    offset = stack.pop()
    size = stack.pop()
    raise Halt(mem_read(frame.memory, offset, size))


def op_revert(interp, frame, stack, pc):
    offset = stack.pop()
    size = stack.pop()
    raise Revert(mem_read(frame.memory, offset, size))


def op_stop(interp, frame, stack, pc):
    raise Halt()


def op_selfdestruct(interp, frame, stack, pc):
    beneficiary = (stack.pop() & ADDR_MASK).to_bytes(20, "big")
    db = interp.evm.statedb
    balance = db.get_balance(frame.address)
    if interp.evm.rules.is_cancun \
            and frame.address not in db.created_this_tx:
        # EIP-6780: a contract not created in this tx only moves its
        # balance; the account survives (geth opSelfdestruct6780)
        db.sub_balance(frame.address, balance)
        db.add_balance(beneficiary, balance)
        raise Halt()
    db.add_balance(beneficiary, balance)
    db.suicide(frame.address)
    raise Halt()


def op_invalid(interp, frame, stack, pc):
    raise vmerrs.ErrInvalidOpCode("INVALID (0xfe)")


def op_undefined(interp, frame, stack, pc):
    raise vmerrs.ErrInvalidOpCode("undefined opcode")
