"""Per-contract traced specialisation (K7): bytecode -> straight-line
programs, as the plain PyTorch version and as generated CUDA.

Port of reference ``evm/device/specialize.py``.  A hot contract's
bytecode is walked ONCE, symbolically, into a straight-line program:

- the opcode switch is gone — each traced step emits exactly the work
  its opcode needs;
- PUSH constants fold at trace time (through arithmetic too, so
  computed jump targets and constant storage keys resolve statically;
  a fully-constant KECCAK folds to its digest on the host);
- jump targets resolve at trace time: constant-condition branches
  follow deterministically, a data-dependent JUMPI forks the trace into
  two segments ("leaves", at most ``MAX_LEAVES``), and loops unroll
  under a step budget;
- keccaks whose input words are context words, calldata words,
  constants or earlier such digests are requested from the host per
  lane (``kdig``, ``KDIG_CAP`` slots, ``spec_requests``); other
  keccaks run on the device;
- storage runs the lane-cache search and the EIP-2929/2200/3529 gas
  ladder of the generic machine, so premaps, F_MISS discovery and the
  OCC validation sweep work unchanged.

Anything the walk cannot resolve raises :class:`TraceIneligible`: that
code stays on the generic interpreter (K5's lane interpreter inside
K6), counted by the window runner as ``specialize_escapes``.

ONE walk (``_Tracer._run``, the reference's abstract walk byte for
byte) drives three modes, chosen by its emitter:

- none — the eligibility walk (``trace_eligible``, ``spec_requests``);
- ``_TorchEmitter`` — the plain version: the reference's emit mode in
  torch, batch-wise over ``(B, 16)`` int32 limb tensors with masked
  leaves merged by path mask (``build_spec_exec``);
- ``_CudaEmitter`` — one ``__device__`` function per program over ONE
  lane (``cuda_source``): stack values become locals in K4's 8 x 32-bit
  layout, a data-dependent JUMPI a real ``if``, a leaf a ``return``;
  storage, logs, keccaks and the leaf write-out call the shared device
  functions of ``csrc/spec_lane.cuh``.  K6 (``csrc/occ_window.cu``)
  calls it per lane by ``prog_id``.

Both emitters flush gas, charge steps and close leaves at exactly the
points the walk decides, so the generated code and the plain version
agree bit for bit, and both equal the reference's emit mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coreth_tpu_torch import kernels
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.evm import census
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device import tables as T
from coreth_tpu_torch.evm.interpreter import analyze_jumpdests
from coreth_tpu_torch.ops import u256, u256x
from coreth_tpu_torch.ops.keccak import keccak256_blocks_plain
from coreth_tpu_torch.params import protocol as P

LIMBS = u256.LIMBS
U256_MASK = (1 << 256) - 1

# trace budgets: a path longer than MAX_PATH_STEPS (a loop that does
# not unroll within the budget) or a program with more than MAX_LEAVES
# straight-line segments (branch explosion) is trace-ineligible
MAX_PATH_STEPS = 512
MAX_TOTAL_STEPS = 4096
MAX_LEAVES = 16

# caps the traced program is validated against (the MachineParams
# floors — these dimensions never re-bucket)
_STACK_CAP = 64
_MEM_CAP = 4096
_LOG_CAP = 8
_LOG_DATA_CAP = 160
_KECCAK_CAP = 272


class TraceIneligible(Exception):
    """Bytecode the specialiser cannot compile to a straight-line
    program; its lanes stay on the generic interpreter."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass(frozen=True)
class SpecProgram:
    """Hashable descriptor of one specialised contract: the key of its
    plain program and of the generated kernel variant."""
    code: bytes
    fork: str


# opcodes the tracer can emit (census.trace_precheck pre-filter; the
# symbolic walk itself may still reject — e.g. symbolic jump targets)
SPEC_OPCODES = frozenset(
    [0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09,
     0x0A, 0x0B, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17,
     0x18, 0x19, 0x1A, 0x1B, 0x1C, 0x1D, 0x20, 0x30, 0x32, 0x33,
     0x34, 0x35, 0x36, 0x38, 0x3A, 0x41, 0x42, 0x43, 0x44, 0x45,
     0x46, 0x48, 0x50, 0x51, 0x52, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5A, 0x5B, 0xF3, 0xFD, 0xFE]
    + list(range(0x5F, 0xA5)))  # PUSH0-32, DUP, SWAP, LOG0-4

# context ops whose 256-bit word the window runner reproduces exactly
# from (TxSpec, BlockEnv) — full-width device inputs only (timestamp /
# number / gaslimit are int32-clamped device scalars, so they stay off
# the list to keep host and device digests bit-identical)
HOST_CTX = frozenset((0x30, 0x32, 0x33, 0x34, 0x3A, 0x41, 0x46, 0x48))

# per-lane host-evaluated digest slots fed to the kernel as the `kdig`
# input (W, B, KDIG_CAP, 16); programs needing more fall back to the
# device keccak for the overflow requests
KDIG_CAP = 8


# const-folding rules (must match the machine/u256x semantics exactly:
# a folded constant REPLACES the runtime computation)
def _fold2(op: int, a: int, b: int) -> Optional[int]:
    if op == 0x01:
        return a + b
    if op == 0x02:
        return a * b
    if op == 0x03:
        return a - b
    if op == 0x04:
        return a // b if b else 0
    if op == 0x06:
        return a % b if b else 0
    if op == 0x10:
        return int(a < b)
    if op == 0x11:
        return int(a > b)
    if op == 0x14:
        return int(a == b)
    if op == 0x16:
        return a & b
    if op == 0x17:
        return a | b
    if op == 0x18:
        return a ^ b
    if op == 0x1B:  # SHL: a = shift, b = value
        return (b << a) if a < 256 else 0
    if op == 0x1C:  # SHR
        return (b >> a) if a < 256 else 0
    if op == 0x1A:  # BYTE: a = index, b = value
        return (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0
    return None


class _SV:
    """Symbolic stack value: a trace-time constant, a runtime value
    (the emitter's handle: a (B, 16) limb tensor, or the name of a C++
    local), or (abstract mode) an opaque symbol.

    ``src`` is host-evaluation provenance: ("ctx", op) for a context
    word the window runner knows per lane, ("data", off) for a
    calldataload word, ("kdig", k) for an already-requested digest.  It
    survives only on pristine words (any arithmetic drops it) and feeds
    the keccak-request machinery."""

    __slots__ = ("const", "t", "src")

    def __init__(self, const: Optional[int] = None, t=None, src=None):
        self.const = const if const is None else (const & U256_MASK)
        self.t = t
        self.src = src


_SYM = _SV()  # the shared abstract unknown


class _Path:
    """One straight-line trace segment's threaded state.  Static parts
    (stack of _SVs, word-aligned memory model, msize, accumulated
    constant gas, steps) are Python values; the runtime parts (path
    mask, gas, err/hosty masks, the storage cache, the log pool) are
    the torch emitter's tensors and unused otherwise (the CUDA lane
    keeps them in its ``SpecLane``)."""

    __slots__ = ("stack", "mem", "msize", "accum", "steps", "nlogs",
                 "pmask", "gas", "err", "hosty", "host_reason", "refund",
                 "st5", "logs", "log_cnt")

    def clone(self) -> "_Path":
        p = _Path()
        for k in self.__slots__:
            setattr(p, k, getattr(self, k))
        p.stack = list(self.stack)
        p.mem = dict(self.mem)
        return p


class _Tracer:
    """Symbolic executor over one bytecode.  ``em=None`` runs the
    abstract (eligibility) walk — identical control decisions, no
    values; with an emitter it builds that emitter's program."""

    def __init__(self, code: bytes, fork: str, em=None):
        self.code = code
        self.fork = fork
        self.em = em
        ot = T.op_tables(fork)
        self.CONST = ot.const_gas
        self.NIN = ot.nin
        self.NOUT = ot.nout
        self.SUP = ot.supported
        self.jumpdests = analyze_jumpdests(code)
        self.total_steps = 0
        self.n_leaves = 0
        # host-evaluated keccak requests, discovered in the SAME order
        # by the abstract walk (published by spec_requests) and the emit
        # walks (which read kdig slots): the walks traverse identical
        # paths, so the indices agree
        self.kreqs: List[Tuple] = []
        self._kreq_idx: Dict[Tuple, int] = {}

    # ------------------------------------------------------------ values
    def _t(self, sv: _SV):
        return self.em.val(sv)

    def _bin(self, op: int, a: _SV, b: _SV) -> _SV:
        if a.const is not None and b.const is not None:
            f = _fold2(op, a.const, b.const)
            if f is not None:
                return _SV(const=f)
        if self.em is None:
            return _SYM
        return _SV(t=self.em.bin(op, self._t(a), self._t(b)))

    # ------------------------------------------------------------- gas
    def _flush(self, path: _Path) -> None:
        """Charge the accumulated constant gas of the pure steps since
        the last effectful op.  Lumping is exact: for a run of
        non-negative per-step costs, some prefix OOGs iff the total
        exceeds gas, and a pure step's value can only escape through a
        later (masked) effectful op."""
        if path.accum == 0 or self.em is None:
            path.accum = 0
            return
        self.em.flush(path, path.accum)
        path.accum = 0

    def _charge(self, path: _Path, cost: int):
        """Flush + charge one effectful step's static cost; returns the
        emitter's ok handle (lanes that afford it; OOG lanes err)."""
        self._flush(path)
        if self.em is None:
            return None
        return self.em.charge(path, cost)

    def _mem_expand(self, path: _Path, need: int) -> int:
        """Static memory-expansion gas for a constant byte demand."""
        if need <= 0:
            return 0
        if need > _MEM_CAP:
            raise TraceIneligible(f"memory demand {need} > cap")
        new = max(path.msize, M._ceil32(need))
        cost = (M._mem_cost_words(new // 32)
                - M._mem_cost_words(path.msize // 32))
        path.msize = new
        return int(cost)

    # ---------------------------------------------------------- memory
    def _mem_word(self, path: _Path, off: int) -> _SV:
        return path.mem.get(off, _SV(const=0))

    def _mem_svs(self, path: _Path, off: int, size: int):
        """The memory-model words covering [off, off+size) and the
        offset of ``off`` inside the first."""
        w0 = off // 32
        w1 = (off + size + 31) // 32
        return ([self._mem_word(path, 32 * w) for w in range(w0, w1)],
                off - 32 * w0)

    # ---------------------------------------------------------- keccak
    def _kreq_of(self, path: _Path, off: int, size: int):
        """Host-evaluable keccak request index, or None.

        A keccak whose input words are all pristine context words,
        calldata words, constants, or earlier requested digests is
        computed by the window runner per lane (one batch per window)
        instead of on the device.  The host hashes the exact bytes the
        device would, so the digest is identical by construction.
        All-const inputs return None so the walks leave them to the
        const-folder."""
        if off % 32 or size % 32 or size == 0:
            return None
        w0 = off // 32
        desc, any_src = [], False
        for w in range(w0, w0 + size // 32):
            sv = self._mem_word(path, 32 * w)
            if sv.const is not None:
                desc.append(("const", sv.const))
            elif sv.src is not None:
                desc.append(sv.src)
                any_src = True
            else:
                return None
        if not any_src:
            return None  # pure-const: the fold path owns it
        key = tuple(desc)
        k = self._kreq_idx.get(key)
        if k is None:
            if len(self.kreqs) >= KDIG_CAP:
                return None  # overflow: device keccak fallback
            k = len(self.kreqs)
            self._kreq_idx[key] = k
            self.kreqs.append(key)
        return k

    def _keccak(self, path: _Path, off: int, size: int) -> _SV:
        if size > _KECCAK_CAP - 1:
            raise TraceIneligible(f"keccak size {size} > cap")
        if size == 0:
            return _SV(const=int.from_bytes(keccak256(b""), "big"))
        svs, s = self._mem_svs(path, off, size)
        if all(sv.const is not None for sv in svs):
            blob = b"".join(sv.const.to_bytes(32, "big") for sv in svs)
            return _SV(const=int.from_bytes(keccak256(blob[s:s + size]),
                                            "big"))
        k = self._kreq_of(path, off, size)
        if k is not None:
            return _SV(t=None if self.em is None else self.em.kdig(k),
                       src=("kdig", k))
        if self.em is None:
            return _SYM
        return _SV(t=self.em.keccak([self._t(sv) for sv in svs], s, size))

    # --------------------------------------------------------- storage
    def _storage_op(self, path: _Path, key: _SV, new: Optional[_SV],
                    op: int) -> Optional[_SV]:
        """One SLOAD/SSTORE against the lane cache — the single-op twin
        of the machine's storage family (entry creation incl. F_MISS on
        OOG, EIP-2929 warm/cold, the EIP-2200/3529 ladder + sentry,
        cache-full HOST escape)."""
        is_sstore = op == 0x55
        if key.const is not None:
            key = _SV(const=key.const & ~(1 << 248))
        if self.em is None:
            return None if is_sstore else _SYM
        self._flush(path)
        v = self.em.storage(path, self._t(key), key.const is None,
                            self._t(new) if is_sstore else None,
                            int(self.CONST[op]), is_sstore)
        return None if is_sstore else _SV(t=v)

    # ------------------------------------------------------------- logs
    def _log_op(self, path: _Path, off: int, size: int,
                topics: List[_SV], op: int) -> None:
        if size > _LOG_DATA_CAP:
            raise TraceIneligible(f"log data {size} > cap")
        if path.nlogs >= _LOG_CAP:
            raise TraceIneligible("log pool overflow")
        path.nlogs += 1
        n = len(topics)
        cost = (int(self.CONST[op]) + P.LOG_GAS
                + n * P.LOG_TOPIC_GAS + size * P.LOG_DATA_GAS
                + self._mem_expand(path, off + size if size else 0))
        if self.em is None:
            return
        ok = self._charge(path, cost)
        svs, s = self._mem_svs(path, off, size) if size else ([], 0)
        self.em.log(path, ok, [self._t(t) for t in topics], svs, s, size)

    # ----------------------------------------------------------- leaves
    def _leaf(self, path: _Path, base_status: int) -> None:
        self._flush(path)
        if self.n_leaves >= MAX_LEAVES:
            raise TraceIneligible("leaf budget exceeded")
        self.n_leaves += 1
        if self.em is not None:
            self.em.leaf(path, base_status)

    def _leaf_err(self, path: _Path) -> None:
        """Terminal static error (bad jump, underflow, undefined op):
        every live lane errs — the failing step's gas is NOT charged
        (machine: err lanes skip the deduction; ERR zeroes gas)."""
        self._flush(path)
        if self.em is not None:
            self.em.err_live(path)
        self._leaf(path, M.ERR)

    def _leaf_host(self, path: _Path, reason: int) -> None:
        """Terminal static HOST escape (host-only opcode, stack over
        the machine cap): live lanes escape without paying the step."""
        self._flush(path)
        if self.em is not None:
            self.em.host_live(path, reason)
        self._leaf(path, M.HOST)

    # ------------------------------------------------------------- walk
    def _ctx_sv(self, op: int) -> _SV:
        if op == 0x38:
            return _SV(const=len(self.code))
        if op == 0x44:
            return _SV(const=1)
        if op not in (0x30, 0x32, 0x33, 0x34, 0x36, 0x3A, 0x41, 0x42,
                      0x43, 0x45, 0x46, 0x48):
            raise TraceIneligible(f"context op 0x{op:02x}")
        src = ("ctx", op) if op in HOST_CTX else None
        if self.em is None:
            return _SV(src=src) if src is not None else _SYM
        return _SV(t=self.em.ctx(op), src=src)

    def _calldataload(self, off: int) -> _SV:
        if off >= M._LIMIT_25:
            return _SV(const=0)  # machine: ~a_fit -> all-zero word
        if self.em is None:
            return _SV(src=("data", off))
        return _SV(t=self.em.calldataload(off), src=("data", off))

    def _run(self, pc: int, path: _Path) -> None:
        """Trace one straight-line segment from `pc`; forks recurse."""
        code = self.code
        n = len(code)
        em = self.em
        while True:
            if path.steps > MAX_PATH_STEPS \
                    or self.total_steps > MAX_TOTAL_STEPS:
                raise TraceIneligible("step budget exceeded")
            path.steps += 1
            self.total_steps += 1
            if pc >= n:
                self._leaf(path, M.STOP)  # zero-padded code: STOP
                return
            op = code[pc]
            sup = int(self.SUP[op])
            if sup == 0:
                self._leaf_err(path)     # undefined: INVALID-style
                return
            nin, nout = int(self.NIN[op]), int(self.NOUT[op])
            if len(path.stack) < nin:
                self._leaf_err(path)     # static underflow
                return
            if len(path.stack) - nin + nout > _STACK_CAP:
                self._leaf_host(path, M.R_STACK)
                return
            if sup == 2:
                self._leaf_host(path, M.R_OPCODE)
                return
            cg = int(self.CONST[op])
            st = path.stack

            # ---- terminals
            if op == 0x00:               # STOP
                path.accum += cg
                self._leaf(path, M.STOP)
                return
            if op in (0xF3, 0xFD):       # RETURN / REVERT
                a, b = st.pop(), st.pop()
                if a.const is None or b.const is None:
                    raise TraceIneligible("symbolic return offset")
                size = b.const
                need = a.const + size if size else 0
                if need >= M._LIMIT_25:
                    self._leaf_err(path)  # m_oog
                    return
                self._charge(path, cg + self._mem_expand(path, need))
                self._leaf(path, M.STOP if op == 0xF3 else M.REVERT)
                return
            if op == 0xFE:               # INVALID
                self._leaf_err(path)
                return

            # ---- jumps
            if op == 0x56:               # JUMP
                a = st.pop()
                if a.const is None:
                    raise TraceIneligible("unresolvable jump target")
                if a.const not in self.jumpdests:
                    self._leaf_err(path)
                    return
                path.accum += cg
                pc = a.const
                continue
            if op == 0x57:               # JUMPI
                a, b = st.pop(), st.pop()
                if a.const is None:
                    raise TraceIneligible("unresolvable jump target")
                if b.const is not None:
                    if b.const:
                        if a.const not in self.jumpdests:
                            self._leaf_err(path)
                            return
                        path.accum += cg
                        pc = a.const
                    else:
                        path.accum += cg
                        pc += 1
                    continue
                # data-dependent branch: fork the trace
                taken = path.clone()
                if em is not None:
                    em.fork(path, taken, self._t(b))
                if a.const not in self.jumpdests:
                    self._leaf_err(taken)
                else:
                    taken.accum += cg
                    self._run(a.const, taken)
                if em is not None:
                    em.join()
                path.accum += cg
                pc += 1
                continue

            # ---- pushes / stack shuffles
            if op == 0x5F:               # PUSH0
                path.accum += cg
                st.append(_SV(const=0))
                pc += 1
                continue
            if 0x60 <= op <= 0x7F:       # PUSH1-32
                ln = op - 0x5F
                # zero-pad truncated immediates like the machine's
                # zero-padded code tensor
                v = int.from_bytes(
                    code[pc + 1:pc + 1 + ln].ljust(ln, b"\x00"), "big")
                path.accum += cg
                st.append(_SV(const=v))
                pc += 1 + ln
                continue
            if 0x80 <= op <= 0x8F:       # DUP1-16
                path.accum += cg
                st.append(st[-1 - (op - 0x80)])
                pc += 1
                continue
            if 0x90 <= op <= 0x9F:       # SWAP1-16
                k = op - 0x8F
                path.accum += cg
                st[-1], st[-1 - k] = st[-1 - k], st[-1]
                pc += 1
                continue
            if op == 0x50:               # POP
                path.accum += cg
                st.pop()
                pc += 1
                continue

            # ---- memory
            if op == 0x52:               # MSTORE
                a, b = st.pop(), st.pop()
                if a.const is None:
                    raise TraceIneligible("symbolic memory offset")
                off = a.const
                if off % 32:
                    raise TraceIneligible("unaligned MSTORE")
                if off + 32 >= M._LIMIT_25:
                    self._leaf_err(path)
                    return
                path.accum += cg + self._mem_expand(path, off + 32)
                # no live-masking: a frozen (err/HOST) lane's memory can
                # only be observed through a LATER effectful op, and
                # every effectful op masks on the live set
                path.mem[off] = b
                pc += 1
                continue
            if op == 0x53:
                raise TraceIneligible("MSTORE8")
            if op == 0x51:               # MLOAD
                a = st.pop()
                if a.const is None:
                    raise TraceIneligible("symbolic memory offset")
                off = a.const
                if off % 32:
                    raise TraceIneligible("unaligned MLOAD")
                if off + 32 >= M._LIMIT_25:
                    self._leaf_err(path)
                    return
                path.accum += cg + self._mem_expand(path, off + 32)
                st.append(self._mem_word(path, off))
                pc += 1
                continue

            # ---- keccak
            if op == 0x20:               # SHA3
                a, b = st.pop(), st.pop()
                if a.const is None or b.const is None:
                    raise TraceIneligible("symbolic keccak range")
                off, size = a.const, b.const
                need = off + size if size else 0
                if need >= M._LIMIT_25:
                    self._leaf_err(path)
                    return
                words = (size + 31) // 32
                path.accum += (cg + words * P.KECCAK256_WORD_GAS
                               + self._mem_expand(path, need))
                st.append(self._keccak(path, off, size))
                pc += 1
                continue

            # ---- storage
            if op in (0x54, 0x55):
                key = st.pop()
                new = st.pop() if op == 0x55 else None
                v = self._storage_op(path, key, new, op)
                if op == 0x54:
                    st.append(v if v is not None else _SYM)
                pc += 1
                continue

            # ---- logs
            if 0xA0 <= op <= 0xA4:
                a, b = st.pop(), st.pop()
                ntop = op - 0xA0
                topics = [st.pop() for _ in range(ntop)]
                if a.const is None or b.const is None:
                    raise TraceIneligible("symbolic log range")
                self._log_op(path, a.const, b.const, topics, op)
                pc += 1
                continue

            # ---- context / environment words
            if op in (0x30, 0x32, 0x33, 0x34, 0x36, 0x38, 0x3A, 0x41,
                      0x42, 0x43, 0x44, 0x45, 0x46, 0x48):
                path.accum += cg
                st.append(self._ctx_sv(op))
                pc += 1
                continue
            if op == 0x35:               # CALLDATALOAD
                a = st.pop()
                if a.const is None:
                    raise TraceIneligible("symbolic calldata offset")
                path.accum += cg
                st.append(self._calldataload(a.const))
                pc += 1
                continue
            if op == 0x58:               # PC
                path.accum += cg
                st.append(_SV(const=pc))
                pc += 1
                continue
            if op == 0x59:               # MSIZE
                path.accum += cg
                st.append(_SV(const=path.msize))
                pc += 1
                continue
            if op == 0x5A:               # GAS
                self._flush(path)
                path.accum += cg
                st.append(_SYM if em is None
                          else _SV(t=em.gas_word(path, cg)))
                pc += 1
                continue
            if op == 0x5B:               # JUMPDEST
                path.accum += cg
                pc += 1
                continue

            # ---- ALU
            if op == 0x15:               # ISZERO
                a = st.pop()
                path.accum += cg
                if a.const is not None:
                    st.append(_SV(const=int(a.const == 0)))
                elif em is not None:
                    st.append(_SV(t=em.iszero(self._t(a))))
                else:
                    st.append(_SYM)
                pc += 1
                continue
            if op == 0x19:               # NOT
                a = st.pop()
                path.accum += cg
                if a.const is not None:
                    st.append(_SV(const=~a.const & U256_MASK))
                elif em is not None:
                    st.append(_SV(t=em.not_(self._t(a))))
                else:
                    st.append(_SYM)
                pc += 1
                continue
            if op in (0x08, 0x09):       # ADDMOD / MULMOD
                a, b, c = st.pop(), st.pop(), st.pop()
                path.accum += cg
                if all(x.const is not None for x in (a, b, c)):
                    if c.const == 0:
                        st.append(_SV(const=0))
                    elif op == 0x08:
                        st.append(_SV(const=(a.const + b.const)
                                      % c.const))
                    else:
                        st.append(_SV(const=(a.const * b.const)
                                      % c.const))
                elif em is not None:
                    st.append(_SV(t=em.modop(op, self._t(a), self._t(b),
                                             self._t(c))))
                else:
                    st.append(_SYM)
                pc += 1
                continue
            if op == 0x0A:               # EXP (const exponent only)
                a, b = st.pop(), st.pop()
                if b.const is None:
                    raise TraceIneligible("symbolic EXP exponent")
                ebytes = (b.const.bit_length() + 7) // 8
                path.accum += (cg + P.EXP_GAS
                               + ebytes * P.EXP_BYTE_EIP158)
                if a.const is not None:
                    st.append(_SV(const=pow(a.const, b.const,
                                            1 << 256)))
                elif em is not None:
                    st.append(_SV(t=em.exp(self._t(a), self._t(b))))
                else:
                    st.append(_SYM)
                pc += 1
                continue
            if op in (0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x0B,
                      0x10, 0x11, 0x12, 0x13, 0x14, 0x16, 0x17, 0x18,
                      0x1A, 0x1B, 0x1C, 0x1D):
                a, b = st.pop(), st.pop()
                path.accum += cg
                st.append(self._bin(op, a, b))
                pc += 1
                continue

            raise TraceIneligible(f"untraced opcode 0x{op:02x}")

    # ------------------------------------------------------------ entry
    def run(self) -> None:
        """Trace from pc 0 (the emitter collects what it built)."""
        p = _Path()
        for k in _Path.__slots__:
            setattr(p, k, None)
        p.stack = []
        p.mem = {}
        p.msize = 0
        p.accum = 0
        p.steps = 0
        p.nlogs = 0
        if self.em is not None:
            self.em.start(p)
        self._run(0, p)


# ------------------------------------------------------- eligibility
_ELIGIBLE: Dict[Tuple[bytes, str], Tuple[bool, str]] = {}
_REQS: Dict[Tuple[bytes, str], Tuple] = {}


def trace_eligible(code: bytes, fork: str) -> Tuple[bool, str]:
    """Can `code` compile to a straight-line traced program?  Runs the
    SAME symbolic walk as the program builders in abstract mode (every
    control decision depends only on trace-time constants, so abstract
    success implies the builds succeed).  Memoized by code hash; the
    window runner consults this before giving a lane a program id."""
    key = (keccak256(code), fork)
    cached = _ELIGIBLE.get(key)
    if cached is not None:
        return cached
    ok, reason = census.trace_precheck(code, SPEC_OPCODES)
    if ok:
        try:
            tr = _Tracer(code, fork)
            tr.run()
            _REQS[key] = tuple(tr.kreqs)
        except TraceIneligible as exc:
            ok, reason = False, exc.reason
        except RecursionError:
            ok, reason = False, "branch recursion too deep"
    out = (ok, reason)
    _ELIGIBLE[key] = out
    return out


def spec_requests(code: bytes, fork: str) -> Tuple:
    """The host-evaluated keccak requests of an eligible program, in
    kdig-slot order (empty for ineligible code).  Each request is a
    tuple of 32-byte-word descriptors — ("const", v) | ("ctx", op) |
    ("data", off) | ("kdig", j with j < this request's index) — that
    the window runner evaluates per lane and batch-hashes."""
    if not trace_eligible(code, fork)[0]:
        return ()
    return _REQS.get((keccak256(code), fork), ())


def _eligible_or_raise(prog: SpecProgram) -> None:
    ok, reason = trace_eligible(prog.code, prog.fork)
    if not ok:
        raise TraceIneligible(reason)


# ----------------------------------------------------- the plain version
def _word16_t(v: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(
        (v & U256_MASK).to_bytes(32, "little"),
        dtype=np.uint16).astype(np.int32)).to(dev)


class _TorchEmitter:
    """The reference's emit mode in torch: every traced step runs
    batch-wise over the lanes of the path, and each leaf records its
    state under its path mask (the masks of a program's leaves
    partition its active lanes)."""

    def __init__(self, p: M.MachineParams, inputs, storage, active):
        self.p = p
        self.inputs = inputs
        self.storage0 = storage
        self.active = active.bool()
        self.B = p.batch
        self.S = p.scache_cap
        self.dev = self.active.device
        self.rows = torch.arange(self.B, device=self.dev)
        self.leaves: List[Tuple[torch.Tensor, dict]] = []

    def _i32(self, shape=None):
        return torch.zeros(shape or (self.B,), dtype=torch.int32,
                           device=self.dev)

    def start(self, path: _Path) -> None:
        p, B = self.p, self.B
        LC, LD = p.log_cap, p.log_data_cap
        path.pmask = self.active
        path.gas = self.inputs["start_gas"].to(torch.int32)
        path.err = torch.zeros((B,), dtype=torch.bool, device=self.dev)
        path.hosty = torch.zeros_like(path.err)
        path.host_reason = self._i32()
        path.refund = self._i32()
        path.st5 = self.storage0
        path.logs = (self._i32((B, LC, 4, LIMBS)), self._i32((B, LC)),
                     self._i32((B, LC, LD)), self._i32((B, LC)))
        path.log_cnt = self._i32()

    # ------------------------------------------------------------ values
    def val(self, sv: _SV) -> torch.Tensor:
        if sv.t is not None:
            return sv.t
        return _word16_t(sv.const, self.dev).expand(self.B, LIMBS)

    def bin(self, op: int, ta, tb) -> torch.Tensor:
        if op == 0x01:
            return u256.add(ta, tb)
        if op == 0x02:
            return u256x.mul(ta, tb)
        if op == 0x03:
            return u256.sub(ta, tb)
        if op in (0x04, 0x05, 0x06, 0x07):
            return self._div_like(op, ta, tb)
        if op == 0x10:
            return u256x.bool_word(u256x.lt(ta, tb))
        if op == 0x11:
            return u256x.bool_word(u256x.gt(ta, tb))
        if op == 0x12:
            return u256x.bool_word(u256x.slt(ta, tb))
        if op == 0x13:
            return u256x.bool_word(u256x.sgt(ta, tb))
        if op == 0x14:
            return u256x.bool_word(u256x.eq(ta, tb))
        if op == 0x16:
            return ta & tb
        if op == 0x17:
            return ta | tb
        if op == 0x18:
            return ta ^ tb
        if op == 0x0B:  # SIGNEXTEND(b=index a, x=value b)
            return u256x.signextend(ta, tb)
        if op == 0x1A:  # BYTE(i=a, x=b)
            return u256x.byte_op(ta, tb)
        if op == 0x1B:  # SHL: value b shifted by a
            return u256x.shl(tb, ta)
        if op == 0x1C:
            return u256x.shr(tb, ta)
        return u256x.sar(tb, ta)   # 0x1D

    @staticmethod
    def _div_like(op: int, a, b):
        """Mirror of the machine's div family for one op."""
        signed = op in (0x05, 0x07)
        xa = u256x._abs(a) if signed else a
        xb = u256x._abs(b) if signed else b
        q, r = u256x.divmod_(xa, xb)
        if not signed:
            return q if op == 0x04 else r
        neg_q = (u256x._sign(a) ^ u256x._sign(b)) == 1
        neg_r = u256x._sign(a) == 1
        if op == 0x05:
            return torch.where(neg_q[:, None], u256x.neg(q), q)
        return torch.where(neg_r[:, None], u256x.neg(r), r)

    def iszero(self, ta):
        return u256x.bool_word(u256.is_zero(ta))

    def not_(self, ta):
        return u256x.not_(ta)

    def modop(self, op: int, ta, tb, tc):
        fn = u256x.addmod if op == 0x08 else u256x.mulmod
        return fn(ta, tb, tc)

    def exp(self, ta, tb):
        return u256x.exp_(ta, tb)

    # ------------------------------------------------------------- gas
    @staticmethod
    def _live(path: _Path):
        return path.pmask & ~path.err & ~path.hosty

    def flush(self, path: _Path, accum: int) -> None:
        live = self._live(path)
        oog = live & (path.gas < accum)
        path.gas = torch.where(live & ~oog, path.gas - accum,
                               path.gas).to(torch.int32)
        path.err = path.err | oog

    def charge(self, path: _Path, cost: int):
        live = self._live(path)
        oog = live & (path.gas < cost)
        ok = live & ~oog
        path.gas = torch.where(ok, path.gas - cost,
                               path.gas).to(torch.int32)
        path.err = path.err | oog
        return ok

    def gas_word(self, path: _Path, cg: int):
        return M.word_of_scalar((path.gas - cg).clamp(min=0).to(
            torch.int32))

    # --------------------------------------------------------- branches
    def fork(self, path: _Path, taken: _Path, tb) -> None:
        nz = ~u256.is_zero(tb)
        taken.pmask = path.pmask & nz
        path.pmask = path.pmask & ~nz

    def join(self) -> None:
        pass

    def err_live(self, path: _Path) -> None:
        path.err = path.err | self._live(path)

    def host_live(self, path: _Path, reason: int) -> None:
        live = self._live(path)
        path.hosty = path.hosty | live
        path.host_reason = torch.where(live, reason,
                                       path.host_reason).to(torch.int32)

    def leaf(self, path: _Path, base_status: int) -> None:
        status = torch.full((self.B,), base_status, dtype=torch.int32,
                            device=self.dev)
        status = torch.where(path.err, M.ERR, status)
        status = torch.where(path.hosty, M.HOST, status).to(torch.int32)
        gas = torch.where(status == M.ERR, 0, path.gas).to(torch.int32)
        skey, sval, sorig, sflag, scnt = path.st5
        log_top, log_nt, log_data, log_dlen = path.logs
        self.leaves.append((path.pmask, dict(
            status=status, gas=gas, refund=path.refund,
            host_reason=path.host_reason, scnt=scnt, sflag=sflag,
            skey=skey, sval=sval, sorig=sorig, log_top=log_top,
            log_nt=log_nt, log_data=log_data, log_dlen=log_dlen,
            log_cnt=path.log_cnt,
            steps=torch.full((self.B,), path.steps, dtype=torch.int32,
                             device=self.dev))))

    # ------------------------------------------------------- context
    def ctx(self, op: int):
        inp, B = self.inputs, self.B

        def bcast(w):
            return w.reshape(1, LIMBS).expand(B, LIMBS)

        def scalar(k):
            return M.word_of_scalar(torch.full(
                (B,), int(inp[k]), dtype=torch.int32, device=self.dev))
        if op == 0x30:
            return inp["address_w"]
        if op == 0x32:
            return inp["origin_w"]
        if op == 0x33:
            return inp["caller_w"]
        if op == 0x34:
            return inp["callvalue"]
        if op == 0x36:
            return M.word_of_scalar(inp["data_len"].to(torch.int32))
        if op == 0x3A:
            return inp["gasprice_w"]
        if op == 0x41:
            return bcast(inp["coinbase_w"])
        if op == 0x42:
            return scalar("timestamp")
        if op == 0x43:
            return scalar("number")
        if op == 0x45:
            return scalar("gaslimit")
        if op == 0x46:
            return bcast(inp["chainid_w"])
        return bcast(inp["basefee_w"])   # 0x48

    def calldataload(self, off: int):
        p, inp = self.p, self.inputs
        pos = np.arange(off + 31, off - 1, -1)
        idx = torch.from_numpy(np.clip(pos, 0, p.data_cap - 1)).to(
            self.dev)
        valid = torch.from_numpy(pos < p.data_cap).to(self.dev)
        cd = inp["calldata"][:, idx]
        in_len = torch.from_numpy(pos).to(self.dev)[None, :] \
            < inp["data_len"][:, None]
        cd = torch.where(valid[None, :] & in_len, cd, 0)
        return torch.stack([cd[:, 2 * k] | (cd[:, 2 * k + 1] << 8)
                            for k in range(LIMBS)], dim=-1).to(torch.int32)

    # --------------------------------------------------------- keccak
    def kdig(self, k: int):
        return self.inputs["kdig"][:, k]

    def _bytes(self, handles, s: int, size: int):
        cols = torch.cat([M._limbs_to_bytes(h) for h in handles], dim=1)
        return cols[:, s:s + size]

    def keccak(self, handles, s: int, size: int):
        B = self.B
        data = self._bytes(handles, s, size)
        nb = size // 136 + 1
        buf = torch.zeros((B, nb * 136), dtype=torch.int64, device=self.dev)
        buf[:, :size] = data
        words = (buf[:, 0::4] | (buf[:, 1::4] << 8)
                 | (buf[:, 2::4] << 16) | (buf[:, 3::4] << 24))
        # pad10*1 with a STATIC message length
        pad = np.zeros((nb * 34,), dtype=np.int64)
        pad[size // 4] ^= 1 << ((size % 4) * 8)
        pad[nb * 34 - 1] ^= 0x80000000
        words = words ^ torch.from_numpy(pad).to(self.dev)[None, :]
        words = torch.where(words >= 1 << 31, words - (1 << 32), words)
        blocks = words.to(torch.int32).reshape(B, nb, 34)
        digest = keccak256_blocks_plain(
            blocks, torch.full((B,), nb, dtype=torch.int32, device=self.dev))
        return M._words8_to_limbs(digest)

    # -------------------------------------------------------- storage
    def storage(self, path: _Path, kt, key_sym: bool, nt, cg: int,
                is_sstore: bool):
        S, B, rows = self.S, self.B, self.rows
        if key_sym:
            kt = kt.clone()
            kt[:, LIMBS - 1] = kt[:, LIMBS - 1] & 0xFEFF
        skey, sval, sorig, sflag, scnt = path.st5
        mask_any = self._live(path)
        hit = (skey == kt[:, None, :]).all(dim=-1) \
            & ((sflag & M.F_VALID) != 0)
        found = hit.any(dim=-1)
        hidx = hit.to(torch.int32).argmax(dim=-1)
        need_app = mask_any & ~found
        full = need_app & (scnt >= S)
        eidx = torch.where(found, hidx, scnt.clamp(0, S - 1)).long()
        eflag = sflag[rows, eidx]
        warm = found & ((eflag & M.F_WARM) != 0)
        cur = torch.where(found[:, None], sval[rows, eidx], 0)
        orig = torch.where(found[:, None], sorig[rows, eidx], 0)
        gas = path.gas
        rd = self._i32()
        sentry = torch.zeros((B,), dtype=torch.bool, device=self.dev)
        if not is_sstore:
            cost = cg + torch.where(warm, P.WARM_STORAGE_READ_COST_EIP2929,
                                    P.COLD_SLOAD_COST_EIP2929)
        else:
            sentry = mask_any & (gas <= P.SSTORE_SENTRY_GAS_EIP2200)
            cold_sur = torch.where(warm, 0, P.COLD_SLOAD_COST_EIP2929)
            eq_cn = u256x.eq(cur, nt)
            eq_oc = u256x.eq(orig, cur)
            eq_on = u256x.eq(orig, nt)
            o_zero = u256.is_zero(orig)
            c_zero = u256.is_zero(cur)
            n_zero = u256.is_zero(nt)
            base = torch.where(
                eq_cn, P.WARM_STORAGE_READ_COST_EIP2929,
                torch.where(
                    eq_oc,
                    torch.where(o_zero, P.SSTORE_SET_GAS_EIP2200,
                                P.SSTORE_RESET_GAS_EIP2200
                                - P.COLD_SLOAD_COST_EIP2929),
                    P.WARM_STORAGE_READ_COST_EIP2929))
            cost = cg + cold_sur + base
            if self.p.refunds:
                CL = P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP3529
                dirty = ~eq_cn & ~eq_oc
                rd = rd + torch.where(
                    ~eq_cn & eq_oc & ~o_zero & n_zero, CL, 0)
                rd = rd + torch.where(dirty & ~o_zero & c_zero, -CL, 0)
                rd = rd + torch.where(
                    dirty & ~o_zero & ~c_zero & n_zero, CL, 0)
                rd = rd + torch.where(
                    dirty & eq_on & o_zero,
                    P.SSTORE_SET_GAS_EIP2200
                    - P.WARM_STORAGE_READ_COST_EIP2929, 0)
                rd = rd + torch.where(
                    dirty & eq_on & ~o_zero,
                    P.SSTORE_RESET_GAS_EIP2200
                    - P.COLD_SLOAD_COST_EIP2929
                    - P.WARM_STORAGE_READ_COST_EIP2929, 0)
        afford = gas >= cost
        do_entry = mask_any & ~full
        do_write = do_entry & ~sentry & afford
        wflag = eflag | M.F_VALID | M.F_READ | M.F_WARM
        wflag = torch.where(need_app, wflag | M.F_MISS, wflag)
        if is_sstore:
            wflag = torch.where(do_write, wflag | M.F_WRITTEN, wflag)
        app = do_entry & need_app
        nkey = torch.where(app[:, None], kt, skey[rows, eidx])
        base_v = torch.where(app[:, None], 0, sval[rows, eidx])
        nval = torch.where(do_write[:, None], nt, base_v) if is_sstore \
            else base_v
        nori = torch.where(app[:, None], 0, sorig[rows, eidx])
        # functional update: forked paths share the caches they had
        r, e = rows[do_entry], eidx[do_entry]
        skey2, sval2, sorig2, sflag2 = (skey.clone(), sval.clone(),
                                        sorig.clone(), sflag.clone())
        skey2[r, e] = nkey[do_entry].to(torch.int32)
        sval2[r, e] = nval[do_entry].to(torch.int32)
        sorig2[r, e] = nori[do_entry].to(torch.int32)
        sflag2[r, e] = wflag[do_entry].to(torch.int32)
        scnt2 = (scnt + app.to(torch.int32)).to(torch.int32)
        path.st5 = (skey2, sval2, sorig2, sflag2, scnt2)
        # step resolution (mirrors the machine's final gas/status stage)
        oog = mask_any & ~afford
        err_new = mask_any & (sentry | oog)
        host_new = mask_any & ~err_new & full
        ok = mask_any & ~err_new & ~host_new
        path.gas = torch.where(ok, gas - cost, gas).to(torch.int32)
        path.refund = (path.refund + torch.where(ok, rd, 0)).to(
            torch.int32)
        path.err = path.err | err_new
        path.hosty = path.hosty | host_new
        path.host_reason = torch.where(host_new, M.R_SCACHE,
                                       path.host_reason).to(torch.int32)
        if is_sstore:
            return None
        return torch.where(found[:, None], cur, 0).to(torch.int32)

    # ----------------------------------------------------------- logs
    def log(self, path: _Path, ok, topics, svs, s: int, size: int) -> None:
        p, B, rows = self.p, self.B, self.rows
        LC, LD = p.log_cap, p.log_data_cap
        n = len(topics)
        tws = list(topics) + [self._i32((B, LIMBS))] * (4 - n)
        tw = torch.stack(tws, dim=1)
        dsrc = self._i32((B, LD))
        if size:
            if all(sv.const is not None for sv in svs):
                blob = b"".join(sv.const.to_bytes(32, "big")
                                for sv in svs)[s:s + size]
                data = torch.from_numpy(np.frombuffer(
                    blob, dtype=np.uint8).astype(np.int32)).to(self.dev)
                dsrc[:, :size] = data[None, :]
            else:
                dsrc[:, :size] = self._bytes([self.val(sv) for sv in svs],
                                             s, size)
        log_top, log_nt, log_data, log_dlen = (t.clone() for t in path.logs)
        slot = path.log_cnt.clamp(0, LC - 1).long()
        r, sl = rows[ok], slot[ok]
        log_top[r, sl] = tw[ok]
        log_nt[r, sl] = n
        log_data[r, sl] = dsrc[ok]
        log_dlen[r, sl] = size
        path.logs = (log_top, log_nt, log_data, log_dlen)
        path.log_cnt = (path.log_cnt + ok.to(torch.int32)).to(torch.int32)

    # ----------------------------------------------------------- merge
    def result(self) -> dict:
        """The merged ``_OCC_RES`` state dict plus ``steps`` (the traced
        steps of each lane's leaf, 0 for lanes of no leaf)."""
        res = M._occ_res0(self.p, self.dev)
        res["steps"] = self._i32()
        for pmask, leaf in self.leaves:
            for f in res:
                m = pmask.reshape((self.B,) + (1,) * (res[f].dim() - 1))
                res[f] = torch.where(m, leaf[f], res[f])
        return res


def build_spec_exec(prog: SpecProgram, params: M.MachineParams):
    """The plain straight-line executor for one contract under one
    shape: ``spec_exec(inputs, storage, active) -> dict``, the drop-in
    replacement for the generic exec over the lanes whose code selected
    this program (reference ``build_spec_exec``).  ``inputs`` holds the
    window's per-block exec inputs with ``kdig`` (B, KDIG_CAP, 16);
    ``storage`` is (skey, sval, sorig, sflag, scnt).  The result holds
    the ``machine._OCC_RES`` fields and ``steps``."""
    _eligible_or_raise(prog)

    def spec_exec(inputs, storage, active):
        em = _TorchEmitter(params, inputs, storage, active)
        _Tracer(prog.code, prog.fork, em).run()
        return em.result()

    return spec_exec


# ------------------------------------------------------ the generated CUDA
def _u256_literal(v: int) -> str:
    v &= U256_MASK
    return "u256_c(" + ", ".join(
        f"0x{(v >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(8)) + ")"


# context words: (K6's per-block MachineIn field, offset) or a dims scalar
_CUDA_CTX = {
    0x30: "u256_from_limbs(in.address + i * 16)",
    0x32: "u256_from_limbs(in.origin + i * 16)",
    0x33: "u256_from_limbs(in.caller + i * 16)",
    0x34: "u256_from_limbs(in.callvalue + i * 16)",
    0x36: "u256_small((uint32_t)in.data_len[i])",
    0x3A: "u256_from_limbs(in.gasprice + i * 16)",
    0x41: "u256_from_limbs(in.env)",
    0x42: "u256_small((uint32_t)d.timestamp)",
    0x43: "u256_small((uint32_t)d.number)",
    0x45: "u256_small((uint32_t)d.gaslimit)",
    0x46: "u256_from_limbs(in.env + 16)",
    0x48: "u256_from_limbs(in.env + 32)",
}

_CUDA_BIN = {
    0x01: "u256_add({a}, {b})", 0x02: "u256_mul({a}, {b})",
    0x03: "u256_sub({a}, {b})", 0x04: "spec_div({a}, {b})",
    0x05: "u256_sdiv({a}, {b})", 0x06: "spec_mod({a}, {b})",
    0x07: "u256_smod({a}, {b})",
    0x10: "u256_small(u256_lt({a}, {b}))",
    0x11: "u256_small(u256_lt({b}, {a}))",
    0x12: "u256_small(u256_slt({a}, {b}))",
    0x13: "u256_small(u256_slt({b}, {a}))",
    0x14: "u256_small(u256_eq({a}, {b}))",
    0x16: "u256_and({a}, {b})", 0x17: "u256_or({a}, {b})",
    0x18: "u256_xor({a}, {b})",
    0x0B: "u256_signextend({a}, {b})", 0x1A: "u256_byte({a}, {b})",
    0x1B: "u256_shl({b}, {a})", 0x1C: "u256_shr({b}, {a})",
    0x1D: "u256_sar({b}, {a})",
}


class _CudaEmitter:
    """C++ for one lane of one program.  Values are ``const u256``
    locals (constants inline literals); the lane's runtime state —
    gas, err/HOST flags, refund, cache count, log count — lives in its
    ``SpecLane``, and its storage cache and logs in its packed row, as
    K5's lane interpreter keeps them.  One thread follows one path, so a
    data-dependent JUMPI is an ``if`` whose taken side ends in
    ``return``s, and the fall-through side continues after it."""

    def __init__(self, refunds: bool):
        self.refunds = refunds
        self.lines: List[str] = []
        self.depth = 1
        self.n = 0

    def _emit(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def _local(self, expr: str) -> str:
        name = f"v{self.n}"
        self.n += 1
        self._emit(f"const u256 {name} = {expr};")
        return name

    def start(self, path: _Path) -> None:
        self._emit("SpecLane L;")
        self._emit("spec_begin(in, d, i, row, &L);")

    def val(self, sv: _SV) -> str:
        return sv.t if sv.t is not None else _u256_literal(sv.const)

    def bin(self, op: int, a: str, b: str) -> str:
        return self._local(_CUDA_BIN[op].format(a=a, b=b))

    def iszero(self, a: str) -> str:
        return self._local(f"u256_small(u256_is_zero({a}))")

    def not_(self, a: str) -> str:
        return self._local(f"u256_not({a})")

    def modop(self, op: int, a: str, b: str, c: str) -> str:
        fn = "u256_addmod" if op == 0x08 else "u256_mulmod"
        return self._local(f"{fn}({a}, {b}, {c})")

    def exp(self, a: str, b: str) -> str:
        return self._local(f"u256_exp({a}, {b})")

    def flush(self, path: _Path, accum: int) -> None:
        self._emit(f"spec_flush(&L, {accum});")

    def charge(self, path: _Path, cost: int) -> str:
        name = f"ok{self.n}"
        self.n += 1
        self._emit(f"const bool {name} = spec_charge(&L, {cost});")
        return name

    def gas_word(self, path: _Path, cg: int) -> str:
        return self._local(f"spec_gas_word(L, {cg})")

    def fork(self, path: _Path, taken: _Path, b: str) -> None:
        self._emit(f"if (!u256_is_zero({b})) {{")
        self.depth += 1

    def join(self) -> None:
        self.depth -= 1
        self._emit("}")

    def err_live(self, path: _Path) -> None:
        self._emit("spec_err_live(&L);")

    def host_live(self, path: _Path, reason: int) -> None:
        self._emit(f"spec_host_live(&L, {reason});")

    def leaf(self, path: _Path, base_status: int) -> None:
        self._emit(f"return spec_leaf(d, row, L, {base_status}, "
                   f"{path.steps});")

    def ctx(self, op: int) -> str:
        return self._local(_CUDA_CTX[op])

    def calldataload(self, off: int) -> str:
        return self._local(f"spec_calldataload(in, d, i, {off})")

    def kdig(self, k: int) -> str:
        return self._local(f"u256_from_limbs(kdig + {16 * k})")

    def _words(self, handles) -> str:
        name = f"mw{self.n}"
        self.n += 1
        self._emit(f"const u256 {name}[{len(handles)}] = "
                   f"{{{', '.join(handles)}}};")
        return name

    def keccak(self, handles, s: int, size: int) -> str:
        mw = self._words(handles)
        return self._local(f"spec_keccak({mw}, {s}, {size})")

    def storage(self, path: _Path, kt: str, key_sym: bool, nt, cg: int,
                is_sstore: bool):
        call = (f"spec_storage(d, row, &L, {kt}, {str(key_sym).lower()}, "
                f"{nt if is_sstore else 'u256_zero()'}, "
                f"{str(is_sstore).lower()}, {cg}, "
                f"{str(self.refunds).lower()})")
        if is_sstore:
            self._emit(call + ";")
            return None
        return self._local(call)

    def log(self, path: _Path, ok: str, topics, svs, s: int,
            size: int) -> None:
        tp = self._words(list(topics) + ["u256_zero()"] * (4 - len(topics)))
        mw = self._words([self.val(sv) for sv in svs]) if svs else "nullptr"
        self._emit(f"spec_log(d, row, &L, {ok}, {len(topics)}, {tp}, "
                   f"{mw}, {s}, {size});")


def cuda_program(prog: SpecProgram, k: int) -> str:
    """The ``__device__`` function ``spec_prog_<k>`` of one eligible
    program: runs lane ``i`` of a block to its leaf, writes the lane's
    packed row, returns the leaf's traced step count."""
    _eligible_or_raise(prog)
    em = _CudaEmitter(refunds=prog.fork != "ap2")
    tr = _Tracer(prog.code, prog.fork, em)
    tr.run()
    head = (f"// program {k}: {len(prog.code)} bytes of bytecode, keccak "
            f"{keccak256(prog.code).hex()[:16]}..., fork {prog.fork}: "
            f"{tr.total_steps} traced steps, {tr.n_leaves} leaves, "
            f"{len(tr.kreqs)} kdig requests\n"
            f"__device__ __noinline__ int spec_prog_{k}(\n"
            f"    const MachineIn& in, const MachineDims& d, int i, "
            f"int32_t* row,\n    const int32_t* kdig) {{\n")
    return head + "\n".join(em.lines) + "\n}\n"


def cuda_source(spec: Tuple[SpecProgram, ...]) -> str:
    """The generated translation unit of K6's specialised variant: the
    shared lane helpers, one function per program (index = ``prog_id``),
    ``spec_dispatch``, then K6 itself (``csrc/occ_window.cu``)."""
    parts = ["// Generated by coreth_tpu_torch/evm/device/specialize.py "
             "(cuda_source) from the\n// bytecode of the window runner's "
             "program set; do not edit.\n",
             "#define OCC_SPEC 1\n#include \"spec_lane.cuh\"\n"]
    parts += [cuda_program(prog, k) for k, prog in enumerate(spec)]
    cases = "".join(f"    case {k}: return spec_prog_{k}(in, d, i, row, "
                    f"kdig);\n" for k in range(len(spec)))
    parts.append(
        "__device__ __noinline__ int spec_dispatch(\n"
        "    int pid, const MachineIn& in, const MachineDims& d, int i,\n"
        "    int32_t* row, const int32_t* kdig) {\n"
        "  switch (pid) {\n" + cases + "  }\n"
        "  __trap();  // a prog_id with no program in this set\n"
        "  return 0;\n}\n")
    parts.append("#include \"occ_window.cu\"\n")
    return "\n".join(parts)


# ------------------------------------------------------- the variants
_LIBS: Dict[Tuple[SpecProgram, ...], object] = {}


def variant(spec: Tuple[SpecProgram, ...]) -> Tuple[str, str]:
    """(library name, generated source) of K6's variant for a program
    set: ``occ_window_spec_<sha12>``, the hash over the source and
    ``csrc/``."""
    src = cuda_source(spec)
    return kernels.generated_name("occ_window_spec", src), src


def occ_library(spec: Tuple[SpecProgram, ...]):
    """The loaded variant for ``spec``, built at its first use (the
    caller waits for nvcc; the seconds land in ``kernels.BUILD_SECONDS``).
    A failed build raises."""
    lib = _LIBS.get(spec)
    if lib is None:
        name, src = variant(spec)
        lib = _LIBS[spec] = kernels.load(name, src)
    return lib
