"""The batched EVM step machine — K5, the plain PyTorch version and its
CUDA wrapper.

Port of reference ``evm/device/machine.py`` (``_build_exec``,
``build_machine``, ``pack_result``): every lane of a tx batch runs its
call to completion, with

- **fixed shapes**: stack, memory, calldata, storage cache, transient
  cache and log pools are static-capacity arrays; a lane that exceeds a
  pool marks itself ``HOST`` (capacity, not correctness, decides);
- **exact gas**: constant gas and stack arity come from the jump tables
  (``tables.op_tables``), dynamic gas follows core/vm/gas_table.go and
  operations_acl.go (EIP-2929 warm/cold via cache flags, the EIP-2200
  SSTORE ladder with the EIP-3529 refund counter from AP3, quadratic
  memory expansion, copy/log/keccak/exp word costs);
- **storage through a per-lane cache**: a lookup miss appends an
  ``F_MISS`` entry and speculates zero; the runner (``adapter``) fills
  the real value and reruns the lane.

``run_machine`` dispatches on the device of its inputs: CUDA tensors go
to the hand-written kernel (``csrc/step_machine.cu``, one thread per
lane running a ``switch`` interpreter to completion), CPU tensors to
``run_plain``, which keeps the reference's batch-wise step (one opcode
for every running lane per iteration, heavy families skipped when no
lane needs them).  Both return the same packed int32 row per lane
(``pack_result``), in every column, for every lane.

Reference: core/vm/interpreter.go:121 (Run).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from coreth_tpu_torch import kernels
from coreth_tpu_torch.evm.device import tables as T
from coreth_tpu_torch.ops import u256, u256x
from coreth_tpu_torch.ops.keccak import keccak256_blocks_plain
from coreth_tpu_torch.parallel.mesh import MAX_SHARDS, collective_reduce_plain
from coreth_tpu_torch.params import protocol as P

# lane status
RUN, STOP, REVERT, ERR, HOST, SKIP = 0, 1, 2, 3, 4, 5

# storage-cache flag bits
F_VALID, F_WARM, F_WRITTEN, F_MISS, F_READ = 1, 2, 4, 8, 16

# host_reason codes (diagnostics)
(R_NONE, R_STACK, R_MEM, R_SCACHE, R_TCACHE, R_LOG, R_COPY, R_KECCAK,
 R_STEPS, R_OPCODE) = range(10)

_LIMIT_25 = 1 << 25  # mem/copy addresses beyond this are always-OOG
LIMBS = u256.LIMBS


@dataclass(frozen=True)
class MachineParams:
    fork: str
    batch: int
    stack_cap: int = 64
    mem_cap: int = 4096
    code_cap: int = 4096
    data_cap: int = 512
    scache_cap: int = 16
    tcache_cap: int = 8
    log_cap: int = 8
    log_data_cap: int = 160
    keccak_cap: int = 272      # buffer bytes; messages <= 271
    copy_cap: int = 512
    max_steps: int = 1 << 16

    @property
    def refunds(self) -> bool:
        """Whether the EIP-3529 refund ladder runs in the SSTORE family
        (AP3+).  The per-lane refund counter is diagnostic only: gas
        refunds were removed at ApricotPhase1, so gas_used never
        subtracts it."""
        return self.fork != "ap2"

    @property
    def width(self) -> int:
        """Columns of one packed output row (``pack_result``)."""
        S, LC = self.scache_cap, self.log_cap
        return 5 + S + 3 * S * LIMBS + 2 * LC + 1 + LC * 4 * LIMBS \
            + LC * self.log_data_cap


# ----------------------------------------------------------- word helpers

def word_of_scalar(x: torch.Tensor) -> torch.Tensor:
    """(B,) int32 -> (B, 16) limbs (value < 2^31)."""
    w = torch.zeros(tuple(x.shape) + (LIMBS,), dtype=torch.int32,
                    device=x.device)
    w[..., 0] = x & 0xFFFF
    w[..., 1] = (x >> 16) & 0xFFFF
    return w


def _fits25(w: torch.Tensor):
    """(int32 value, fits<2^25 flag) from a u256 word; non-fitting
    values clamp to 2^25 (the always-OOG sentinel)."""
    fits = ~(w[..., 2:] != 0).any(dim=-1) & (w[..., 1] < (1 << 9))
    v = torch.where(fits, w[..., 0] + (w[..., 1] << 16), _LIMIT_25)
    return v, fits


def _bytes_to_limbs(be: torch.Tensor) -> torch.Tensor:
    """(B, 32) big-endian bytes -> (B, 16) limbs."""
    return be.flip(-1).reshape(be.shape[0], LIMBS, 2)[..., 0] \
        | (be.flip(-1).reshape(be.shape[0], LIMBS, 2)[..., 1] << 8)


def _limbs_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(B, 16) limbs -> (B, 32) big-endian bytes."""
    le = torch.stack([w & 0xFF, (w >> 8) & 0xFF], dim=-1)
    return le.reshape(w.shape[0], 32).flip(-1)


def _le_bytes_to_limbs(le: torch.Tensor) -> torch.Tensor:
    """(B, 32) little-endian bytes -> (B, 16) limbs."""
    return le[:, 0::2] | (le[:, 1::2] << 8)


def _words8_to_limbs(wds: torch.Tensor) -> torch.Tensor:
    """(B, 8) keccak digest words -> (B, 16) limbs (digest bytes read
    as a big-endian u256)."""
    w = wds.to(torch.int64) & 0xFFFFFFFF
    digest = torch.stack([(w >> (8 * j)) & 0xFF for j in range(4)],
                         dim=-1).reshape(wds.shape[0], 32)
    return _bytes_to_limbs(digest.to(torch.int32))


def _ceil32(x):
    return ((x + 31) // 32) * 32


def _mem_cost_words(w):
    return w * P.MEMORY_GAS + w * w // P.QUAD_COEFF_DIV


# ----------------------------------------------------- the plain version

def _tables(fork: str, device) -> Dict[str, torch.Tensor]:
    ot = T.op_tables(fork)
    return {k: torch.from_numpy(getattr(ot, k)).to(device)
            for k in ("const_gas", "nin", "nout", "supported")}


def run_plain(p: MachineParams, inputs: Dict[str, torch.Tensor]) -> dict:
    """Run every active lane to completion, batch-wise (reference
    ``_build_exec``).  Returns the final state dict with ``packed``."""
    code, jdest = inputs["code"], inputs["jdest"]
    calldata, data_len = inputs["calldata"], inputs["data_len"]
    dev = code.device
    B, S, TC, LC = p.batch, p.scache_cap, p.tcache_cap, p.log_cap
    CW = code.shape[1]
    tb = _tables(p.fork, dev)
    CONST, NIN, NOUT, SUP = (tb["const_gas"], tb["nin"], tb["nout"],
                             tb["supported"])
    rows = torch.arange(B, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def bcast(w):
        return w.reshape(1, LIMBS).expand(B, LIMBS)

    ctx = {0x30: inputs["address_w"], 0x32: inputs["origin_w"],
           0x33: inputs["caller_w"], 0x34: inputs["callvalue"],
           0x3A: inputs["gasprice_w"], 0x41: bcast(inputs["coinbase_w"]),
           0x46: bcast(inputs["chainid_w"])}
    if p.fork != "ap2":
        ctx[0x48] = bcast(inputs["basefee_w"])
    full = lambda v: torch.full((B,), int(v), **i32)  # noqa: E731
    scalar_words = {
        0x36: word_of_scalar(data_len),
        0x38: word_of_scalar(inputs["code_len"]),
        0x42: word_of_scalar(full(inputs["timestamp"])),
        0x43: word_of_scalar(full(inputs["number"])),
        0x44: word_of_scalar(full(1)),            # difficulty = 1
        0x45: word_of_scalar(full(inputs["gaslimit"])),
    }
    le_pos = torch.arange(32, **i32)[None, :]

    st = dict(
        pc=torch.zeros((B,), **i32),
        gas=inputs["start_gas"].to(torch.int32).clone(),
        status=torch.where(inputs["active"].bool(), RUN, SKIP).to(
            torch.int32),
        sp=torch.zeros((B,), **i32),
        refund=torch.zeros((B,), **i32),
        steps=torch.zeros((B,), **i32),
        stack=torch.zeros((B, p.stack_cap, LIMBS), **i32),
        mem=torch.zeros((B, p.mem_cap), **i32),
        msize=torch.zeros((B,), **i32),
        skey=inputs["skey"].clone(), sval=inputs["sval"].clone(),
        sorig=inputs["sorig"].clone(), sflag=inputs["sflag"].clone(),
        scnt=inputs["scnt"].clone(),
        tkey=torch.zeros((B, TC, LIMBS), **i32),
        tval=torch.zeros((B, TC, LIMBS), **i32),
        tcnt=torch.zeros((B,), **i32),
        log_top=torch.zeros((B, LC, 4, LIMBS), **i32),
        log_nt=torch.zeros((B, LC), **i32),
        log_data=torch.zeros((B, LC, p.log_data_cap), **i32),
        log_dlen=torch.zeros((B, LC), **i32),
        log_cnt=torch.zeros((B,), **i32),
        host_reason=torch.zeros((B,), **i32),
    )

    def peek(stack, sp, k):
        idx = (sp - 1 - k).clamp(0, p.stack_cap - 1).long()
        return stack[rows, idx]

    def put(stack, pos, val, mask):
        r = rows[mask]
        stack[r, pos[mask].clamp(0, p.stack_cap - 1).long()] = val[mask]

    def gather(arr, idx, hi):
        return torch.gather(arr, 1, idx.clamp(0, hi).long())

    n_iter = 0
    while n_iter < p.max_steps and bool((st["status"] == RUN).any()):
        n_iter += 1
        _step(p, st, code, jdest, calldata, data_len, CW, CONST, NIN,
              NOUT, SUP, ctx, scalar_words, le_pos, rows, peek, put,
              gather)

    timed_out = st["status"] == RUN
    st["status"] = torch.where(timed_out, HOST, st["status"])
    st["host_reason"] = torch.where(timed_out, R_STEPS, st["host_reason"])
    # every error consumes all gas (interpreter.go: any err but
    # ErrExecutionReverted burns the remaining gas)
    st["gas"] = torch.where(st["status"] == ERR, 0, st["gas"])
    st["packed"] = pack_result(B, st)
    return st


def _step(p, st, code, jdest, calldata, data_len, CW, CONST, NIN, NOUT,
          SUP, ctx, scalar_words, le_pos, rows, peek, put, gather):
    """One opcode for every running lane (reference ``step``)."""
    B, S, TC, LC = p.batch, p.scache_cap, p.tcache_cap, p.log_cap
    pc, gas, status, sp = st["pc"], st["gas"], st["status"], st["sp"]
    stack, mem, msize = st["stack"], st["mem"], st["msize"]
    running = status == RUN
    dev = pc.device
    i32 = dict(dtype=torch.int32, device=dev)
    zb = torch.zeros((B,), dtype=torch.bool, device=dev)
    zi = torch.zeros((B,), **i32)

    op = code[rows, pc.clamp(0, CW - 1).long()]
    op = torch.where(running, op, 0)
    opl = op.long()
    nin, nout, sup, const_gas = NIN[opl], NOUT[opl], SUP[opl], CONST[opl]

    # ---------------- stack discipline
    under = sp < nin
    newsp = sp - nin + nout
    over_1024 = newsp > P.STACK_LIMIT
    over_cap = (newsp > p.stack_cap) & ~over_1024
    undefined = sup == 0
    hostop = sup == 2

    a = peek(stack, sp, 0)
    b = peek(stack, sp, 1)
    c = peek(stack, sp, 2)
    a_v, a_fit = _fits25(a)
    b_v, b_fit = _fits25(b)
    c_v, c_fit = _fits25(c)
    a_zero, b_zero, c_zero = u256.is_zero(a), u256.is_zero(b), \
        u256.is_zero(c)

    def m(o):
        return op == o

    is_push = (op >= 0x5F) & (op <= 0x7F)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    is_log = (op >= 0xA0) & (op <= 0xA4)
    is_mload, is_mstore, is_mstore8 = m(0x51), m(0x52), m(0x53)
    is_keccak = m(0x20)
    is_ret_rev = m(0xF3) | m(0xFD)
    is_ddcopy = m(0x37) | m(0x39)
    is_mcopy = m(0x5E)
    is_sload, is_sstore = m(0x54), m(0x55)
    is_jump, is_jumpi = m(0x56), m(0x57)

    # ---------------- memory demand + expansion gas
    len32 = is_mload | is_mstore
    offa_lenb = is_keccak | is_ret_rev | is_log
    copy3 = is_ddcopy | is_mcopy
    need = zi.clone()
    need = torch.where(len32, a_v + 32, need)
    m_oog = len32 & ~a_fit
    need = torch.where(is_mstore8, a_v + 1, need)
    m_oog = m_oog | (is_mstore8 & ~a_fit)
    nonz = ~b_zero
    need = torch.where(offa_lenb & nonz, a_v + b_v, need)
    m_oog = m_oog | (offa_lenb & nonz & ~(a_fit & b_fit))
    nonzc = ~c_zero
    need = torch.where(is_ddcopy & nonzc, a_v + c_v, need)
    m_oog = m_oog | (is_ddcopy & nonzc & ~(a_fit & c_fit))
    need = torch.where(is_mcopy & nonzc, torch.maximum(a_v, b_v) + c_v,
                       need)
    m_oog = m_oog | (is_mcopy & nonzc & ~(a_fit & b_fit & c_fit))
    m_host_mem = (need > p.mem_cap) & ~m_oog
    need_c = need.clamp(0, p.mem_cap)
    new_msize = torch.maximum(msize, _ceil32(need_c))
    exp_gas = torch.where(
        need > 0,
        _mem_cost_words(new_msize // 32) - _mem_cost_words(msize // 32), 0)

    # ---------------- dynamic gas (non-storage)
    dyn = exp_gas
    words_c = (c_v + 31) // 32
    dyn = dyn + torch.where(copy3, words_c * P.COPY_GAS, 0)
    words_b = (b_v + 31) // 32
    dyn = dyn + torch.where(is_keccak, words_b * P.KECCAK256_WORD_GAS, 0)
    ntopics = (op - 0xA0).clamp(0, 4)
    dyn = dyn + torch.where(
        is_log, P.LOG_GAS + ntopics * P.LOG_TOPIC_GAS + b_v * P.LOG_DATA_GAS,
        0)
    is_exp = m(0x0A)
    if bool(is_exp.any()):
        ebytes = (u256x.bit_length(b) + 7) // 8
        dyn = dyn + torch.where(is_exp, P.EXP_GAS + ebytes * P.EXP_BYTE_EIP158,
                                0)

    # capacity escapes (host, not error); later reasons win
    m_host = m_host_mem | hostop | over_cap
    reason = torch.where(hostop, R_OPCODE, R_NONE)
    reason = torch.where(over_cap, R_STACK, reason)
    reason = torch.where(m_host_mem, R_MEM, reason)
    too_copy = copy3 & (c_v > p.copy_cap)
    m_host = m_host | too_copy
    reason = torch.where(too_copy, R_COPY, reason)
    too_kec = is_keccak & (b_v > p.keccak_cap - 1)
    m_host = m_host | too_kec
    reason = torch.where(too_kec, R_KECCAK, reason)
    too_log = is_log & ((b_v > p.log_data_cap) | (st["log_cnt"] >= LC))
    m_host = m_host | too_log
    reason = torch.where(too_log, R_LOG, reason)

    # ---------------- jumps
    dest_ok = a_fit & (a_v < p.code_cap)
    dest_bit = jdest[rows, a_v.clamp(0, p.code_cap - 1).long()]
    jump_valid = dest_ok & (dest_bit == 1)
    take_jump = is_jump | (is_jumpi & ~b_zero)
    bad_jump = take_jump & ~jump_valid

    # INVALID (0xFE) errs and burns all gas like opInvalid
    pre_err = under | over_1024 | undefined | bad_jump | m_oog | m(0xFE)
    ok_pre = running & ~pre_err & ~m_host

    # ---------------- cheap value families
    val = torch.zeros((B, LIMBS), **i32)

    def sel(mask, v):
        return torch.where(mask[:, None], v, val)

    val = sel(m(0x01), u256.add(a, b))
    val = sel(m(0x03), u256.sub(a, b))
    val = sel(m(0x10), u256x.bool_word(u256x.lt(a, b)))
    val = sel(m(0x11), u256x.bool_word(u256x.gt(a, b)))
    val = sel(m(0x12), u256x.bool_word(u256x.slt(a, b)))
    val = sel(m(0x13), u256x.bool_word(u256x.sgt(a, b)))
    val = sel(m(0x14), u256x.bool_word(u256x.eq(a, b)))
    val = sel(m(0x15), u256x.bool_word(a_zero))
    val = sel(m(0x16), a & b)
    val = sel(m(0x17), a | b)
    val = sel(m(0x18), a ^ b)
    val = sel(m(0x19), u256x.not_(a))

    # PUSH0..PUSH32: big-endian bytes following pc
    pushlen = torch.where(is_push, op - 0x5F, 0)
    idxp = pc[:, None] + pushlen[:, None] - le_pos
    pbytes = gather(code, idxp, CW - 1)
    pbytes = torch.where(le_pos < pushlen[:, None], pbytes, 0)
    val = sel(is_push, _le_bytes_to_limbs(pbytes))

    val = sel(is_dup, peek(stack, sp, (op - 0x80).clamp(0, 15)))

    # CALLDATALOAD: 32 bytes from calldata[a..], zero-padded
    cd_idx = a_v[:, None] + 31 - le_pos
    cd_ok = (a_fit[:, None] & (cd_idx >= a_v[:, None])
             & (cd_idx < data_len[:, None]) & (cd_idx < p.data_cap))
    cd_bytes = torch.where(cd_ok, gather(calldata, cd_idx, p.data_cap - 1),
                           0)
    val = sel(m(0x35), _le_bytes_to_limbs(cd_bytes))

    for o, w in ctx.items():
        val = sel(m(o), w)
    for o, w in scalar_words.items():
        val = sel(m(o), w)
    val = sel(m(0x58), word_of_scalar(pc))
    val = sel(m(0x59), word_of_scalar(msize))
    val = sel(m(0x5A), word_of_scalar((gas - const_gas).clamp(min=0)))

    # MLOAD: big-endian byte j of the word is mem[off + j]
    ml_be = gather(mem, a_v.clamp(0, p.mem_cap)[:, None] + le_pos,
                   p.mem_cap - 1)
    val = sel(is_mload, _bytes_to_limbs(ml_be))

    # ---------------- heavy families (skipped when no lane needs them)
    if bool((m(0x02) & ok_pre).any()):
        val = sel(m(0x02), u256x.mul(a, b))
    div_mask = m(0x04) | m(0x05) | m(0x06) | m(0x07)
    if bool((div_mask & ok_pre).any()):
        signed = m(0x05) | m(0x07)
        xa = torch.where(signed[:, None], u256x._abs(a), a)
        xb = torch.where(signed[:, None], u256x._abs(b), b)
        q, r = u256x.divmod_(xa, xb)
        neg_q = (u256x._sign(a) ^ u256x._sign(b)) == 1
        neg_r = u256x._sign(a) == 1
        sq = torch.where((signed & neg_q)[:, None], u256x.neg(q), q)
        sr = torch.where((signed & neg_r)[:, None], u256x.neg(r), r)
        val = sel(m(0x04), q)
        val = sel(m(0x05), sq)
        val = sel(m(0x06), r)
        val = sel(m(0x07), sr)
    if bool((m(0x08) & ok_pre).any()):
        val = sel(m(0x08), u256x.addmod(a, b, c))
    if bool((m(0x09) & ok_pre).any()):
        val = sel(m(0x09), u256x.mulmod(a, b, c))
    if bool((is_exp & ok_pre).any()):
        val = sel(is_exp, u256x.exp_(a, b))
    shift_mask = m(0x0B) | m(0x1A) | m(0x1B) | m(0x1C) | m(0x1D)
    if bool((shift_mask & ok_pre).any()):
        val = sel(m(0x0B), u256x.signextend(a, b))
        val = sel(m(0x1A), u256x.byte_op(a, b))
        # SHL/SHR/SAR: shift amount on top (a), value b
        val = sel(m(0x1B), u256x.shl(b, a))
        val = sel(m(0x1C), u256x.shr(b, a))
        val = sel(m(0x1D), u256x.sar(b, a))
    if bool((is_keccak & ok_pre).any()):
        KC = p.keccak_cap
        off = a_v.clamp(0, p.mem_cap)
        jj = torch.arange(KC, **i32)[None, :]
        src = gather(mem, off[:, None] + jj, p.mem_cap - 1)
        src = torch.where(jj < b_v[:, None], src, 0).to(torch.int64)
        words = src[:, 0::4] | (src[:, 1::4] << 8) | (src[:, 2::4] << 16) \
            | (src[:, 3::4] << 24)
        # pad10*1: 0x01 at byte len, 0x80 at the last rate byte
        widx = torch.arange(KC // 4, device=dev)[None, :]
        bv = b_v.to(torch.int64)
        sfx = torch.where(widx == (bv // 4)[:, None],
                          1 << ((bv % 4) * 8)[:, None], 0)
        nb = b_v // 136 + 1
        sfx = sfx ^ torch.where(widx == (nb.to(torch.int64) * 34 - 1)[:, None],
                                0x80000000, 0)
        words = words ^ sfx
        words = torch.where(words >= 1 << 31, words - (1 << 32),
                            words).to(torch.int32)
        digest = keccak256_blocks_plain(words.reshape(B, KC // 136, 34), nb)
        val = sel(is_keccak, _words8_to_limbs(digest))

    # ---------------- storage family (cost + cache writes inside)
    skey, sval = st["skey"], st["sval"]
    sorig, sflag, scnt = st["sorig"], st["sflag"], st["scnt"]
    cost_st, refund_d, st_err = zi, zi, zb
    mask_any = (is_sload | is_sstore) & ok_pre
    if bool(mask_any.any()):
        # Avalanche multicoin partition: normal storage keys have bit 0
        # of byte 0 (the high byte of limb 15) cleared
        key = a.clone()
        key[:, LIMBS - 1] &= 0xFEFF
        new = b
        hit = (skey == key[:, None, :]).all(dim=-1) \
            & ((sflag & F_VALID) != 0)
        found = hit.any(dim=-1)
        hidx = hit.to(torch.int32).argmax(dim=-1)
        need_app = mask_any & ~found
        full = need_app & (scnt >= S)
        eidx = torch.where(found, hidx, scnt.clamp(0, S - 1)).long()
        eflag = sflag[rows, eidx]
        warm = found & ((eflag & F_WARM) != 0)
        cur = torch.where(found[:, None], sval[rows, eidx], 0)
        orig = torch.where(found[:, None], sorig[rows, eidx], 0)
        c_sload = torch.where(warm, P.WARM_STORAGE_READ_COST_EIP2929,
                              P.COLD_SLOAD_COST_EIP2929)
        sentry = is_sstore & (gas <= P.SSTORE_SENTRY_GAS_EIP2200)
        cold_sur = torch.where(warm, 0, P.COLD_SLOAD_COST_EIP2929)
        eq_cn, eq_oc, eq_on = u256x.eq(cur, new), u256x.eq(orig, cur), \
            u256x.eq(orig, new)
        o_zero, cz, n_zero = u256.is_zero(orig), u256.is_zero(cur), \
            u256.is_zero(new)
        base = torch.where(
            eq_cn, P.WARM_STORAGE_READ_COST_EIP2929,
            torch.where(eq_oc,
                        torch.where(o_zero, P.SSTORE_SET_GAS_EIP2200,
                                    P.SSTORE_RESET_GAS_EIP2200
                                    - P.COLD_SLOAD_COST_EIP2929),
                        P.WARM_STORAGE_READ_COST_EIP2929))
        c_sstore = cold_sur + base
        cost_st = torch.where(is_sload & mask_any, c_sload, 0) \
            + torch.where(is_sstore & mask_any, c_sstore, 0)
        rd = zi
        if p.refunds:
            CL = P.SSTORE_CLEARS_SCHEDULE_REFUND_EIP3529
            dirty = ~eq_cn & ~eq_oc
            rd = rd + torch.where(~eq_cn & eq_oc & ~o_zero & n_zero, CL, 0)
            rd = rd + torch.where(dirty & ~o_zero & cz, -CL, 0)
            rd = rd + torch.where(dirty & ~o_zero & ~cz & n_zero, CL, 0)
            rd = rd + torch.where(
                dirty & eq_on & o_zero,
                P.SSTORE_SET_GAS_EIP2200 - P.WARM_STORAGE_READ_COST_EIP2929,
                0)
            rd = rd + torch.where(
                dirty & eq_on & ~o_zero,
                P.SSTORE_RESET_GAS_EIP2200 - P.COLD_SLOAD_COST_EIP2929
                - P.WARM_STORAGE_READ_COST_EIP2929, 0)
            rd = torch.where(is_sstore & mask_any, rd, 0)
        refund_d = rd
        afford = gas >= cost_st
        # the entry (and its F_MISS flag) lands even when the op then
        # errs: a blind SSTORE may be mispriced on the speculative zero,
        # and the runner reruns the lane only if the miss was recorded
        do_entry = mask_any & ~full
        do_write = do_entry & ~sentry & afford
        wflag = eflag | F_VALID | F_READ | F_WARM
        wflag = torch.where(need_app, wflag | F_MISS, wflag)
        wflag = torch.where(is_sstore & do_write, wflag | F_WRITTEN, wflag)
        app = do_entry & need_app
        nkey = torch.where(app[:, None], key, skey[rows, eidx])
        nval = torch.where((do_write & is_sstore)[:, None], new,
                           torch.where(app[:, None], 0, sval[rows, eidx]))
        nori = torch.where(app[:, None], 0, sorig[rows, eidx])
        r, e = rows[do_entry], eidx[do_entry]
        skey[r, e] = nkey[do_entry]
        sval[r, e] = nval[do_entry]
        sorig[r, e] = nori[do_entry]
        sflag[r, e] = wflag[do_entry]
        st["scnt"] = scnt + app.to(torch.int32)
        val = torch.where((is_sload & do_write)[:, None], cur, val)
        st_err = sentry & mask_any
        m_host = m_host | full
        reason = torch.where(full, R_SCACHE, reason)

    # ---------------- transient storage (cancun)
    tkey, tval, tcnt = st["tkey"], st["tval"], st["tcnt"]
    is_tload, is_tstore = m(0x5C), m(0x5D)
    t_any = (is_tload | is_tstore) & ok_pre
    if bool(t_any.any()):
        hit = (tkey == a[:, None, :]).all(dim=-1) \
            & (torch.arange(TC, device=dev)[None, :] < tcnt[:, None])
        found = hit.any(dim=-1)
        hidx = hit.to(torch.int32).argmax(dim=-1)
        need_app = t_any & is_tstore & ~found
        t_full = need_app & (tcnt >= TC)
        do = t_any & ~t_full
        eidx = torch.where(found, hidx, tcnt.clamp(0, TC - 1)).long()
        cur = torch.where(found[:, None], tval[rows, eidx], 0)
        w = do & is_tstore
        tkey[rows[w], eidx[w]] = a[w]
        tval[rows[w], eidx[w]] = b[w]
        st["tcnt"] = tcnt + (do & need_app).to(torch.int32)
        val = torch.where((is_tload & do)[:, None], cur, val)
        m_host = m_host | t_full
        reason = torch.where(t_full, R_TCACHE, reason)

    # ---------------- final gas + status resolution
    cost = const_gas + dyn + cost_st
    oog = running & ~pre_err & (gas < cost)
    err = running & (pre_err | st_err | oog)
    host_now = running & ~err & m_host
    ok = running & ~err & ~host_now

    # ---------------- side effects (masked by ok)
    ms_mask = ok & (is_mstore | is_mstore8)
    if bool(ms_mask.any()):
        w_bytes = _limbs_to_bytes(b)
        w_src = torch.where(is_mstore8[:, None],
                            (b[:, 0] & 0xFF)[:, None].expand(B, 32),
                            w_bytes)
        n_write = torch.where(is_mstore8, 1, 32)
        wr = ms_mask[:, None] & (le_pos < n_write[:, None])
        w_idx = (a_v[:, None] + le_pos).clamp(0, p.mem_cap - 1)
        rr = rows[:, None].expand(B, 32)
        mem[rr[wr], w_idx[wr].long()] = w_src[wr]

    copy_mask = ok & copy3
    if bool(copy_mask.any()):
        CC = p.copy_cap
        jj = torch.arange(CC, **i32)[None, :]
        src_idx = b_v[:, None] + jj
        cd = torch.where(b_fit[:, None] & (src_idx < data_len[:, None])
                         & (src_idx < p.data_cap),
                         gather(calldata, src_idx, p.data_cap - 1), 0)
        co = torch.where(b_fit[:, None] & (src_idx < CW),
                         gather(code, src_idx, CW - 1), 0)
        mm = gather(mem, src_idx, p.mem_cap - 1)
        src = torch.where(m(0x37)[:, None], cd,
                          torch.where(m(0x39)[:, None], co, mm))
        wr = copy_mask[:, None] & (jj < c_v[:, None])
        d_idx = (a_v[:, None] + jj).clamp(0, p.mem_cap - 1)
        rr = rows[:, None].expand(B, CC)
        mem[rr[wr], d_idx[wr].long()] = src[wr]

    lmask = ok & is_log
    if bool(lmask.any()):
        n = (op - 0xA0).clamp(0, 4)
        topics = torch.stack([peek(stack, sp, 2 + k) for k in range(4)],
                             dim=1)
        tmask = torch.arange(4, device=dev)[None, :] < n[:, None]
        topics = torch.where(tmask[..., None], topics, 0)
        LD = p.log_data_cap
        jj = torch.arange(LD, **i32)[None, :]
        dsrc = gather(mem, a_v[:, None] + jj, p.mem_cap - 1)
        dsrc = torch.where(jj < b_v[:, None], dsrc, 0)
        slot = st["log_cnt"].clamp(0, LC - 1).long()
        r, s = rows[lmask], slot[lmask]
        st["log_top"][r, s] = topics[lmask]
        st["log_nt"][r, s] = n[lmask]
        st["log_data"][r, s] = dsrc[lmask]
        st["log_dlen"][r, s] = b_v[lmask]
        st["log_cnt"] = st["log_cnt"] + lmask.to(torch.int32)

    # ---------------- stack writes
    put(stack, newsp - 1, val, ok & (nout > 0) & ~is_swap)
    swap_n = (op - 0x8F).clamp(1, 16)
    sw_mask = ok & is_swap
    if bool(sw_mask.any()):
        oth_v = peek(stack, sp, swap_n)
        put(stack, sp - 1, oth_v, sw_mask)
        put(stack, sp - 1 - swap_n, a, sw_mask)

    # ---------------- advance
    is_stop = m(0x00) | m(0xF3)
    next_pc = torch.where(take_jump, a_v, pc + 1 + pushlen)
    new_status = torch.where(
        err, ERR, torch.where(
            host_now, HOST, torch.where(
                ok & is_stop, STOP, torch.where(ok & m(0xFD), REVERT,
                                                RUN))))
    status = torch.where(running, new_status, status)
    st["status"] = status.to(torch.int32)
    st["gas"] = torch.where(ok, gas - cost, gas)
    st["sp"] = torch.where(ok, newsp, sp)
    st["pc"] = torch.where(ok & (status == RUN), next_pc, pc)
    st["msize"] = torch.where(ok & (need > 0), new_msize, msize)
    st["refund"] = st["refund"] + torch.where(ok, refund_d, 0)
    st["host_reason"] = torch.where(host_now, reason, st["host_reason"])
    st["steps"] = st["steps"] + running.to(torch.int32)


def pack_result(B: int, st: dict) -> torch.Tensor:
    """ONE packed int32 output row per lane, in the reference layout
    (``pack_result``; read back by ``adapter.PackedOut``)."""
    return torch.cat([
        st["status"][:, None], st["gas"][:, None],
        st["refund"][:, None], st["host_reason"][:, None],
        st["scnt"][:, None], st["sflag"],
        st["skey"].reshape(B, -1), st["sval"].reshape(B, -1),
        st["sorig"].reshape(B, -1), st["log_nt"],
        st["log_dlen"], st["log_cnt"][:, None],
        st["log_top"].reshape(B, -1),
        st["log_data"].reshape(B, -1)], dim=1).to(torch.int32)


# ------------------------------------------------------------ the kernel
# Lane inputs, in the order the kernel takes them (after ``code``).
_LANE_INPUTS = ("jdest", "code_len", "calldata", "data_len", "start_gas",
                "active", "skey", "sval", "sorig", "sflag", "scnt",
                "callvalue", "caller_w", "address_w", "origin_w",
                "gasprice_w")
_ENV_WORDS = ("coinbase_w", "chainid_w", "basefee_w")

# Integer operations the kernel spends on one executed step, counted
# from csrc/step_machine.cu's common path (fetch + table lookups, three
# operand peeks and fit checks, memory-gas and escape arithmetic, one
# 8-word value op, the stack write and the advance).  The K5 bound uses
# it with the per-lane step counts the kernel reports.
OPS_PER_STEP = 200

LAUNCHES = 0


def _env_words(inputs, dev) -> torch.Tensor:
    return torch.stack([inputs[k].reshape(LIMBS).to(dev)
                        for k in _ENV_WORDS])


def run_machine(p: MachineParams, inputs: Dict[str, torch.Tensor]):
    """K5: run the batch.  CUDA inputs launch ``csrc/step_machine.cu``
    (asynchronous, current stream); CPU inputs run ``run_plain``.
    Returns (packed (B, width) int32 rows, (B,) executed step counts)."""
    code = inputs["code"]
    dev = code.device
    B = p.batch
    if code.shape != (B, p.code_cap + 33):
        raise ValueError(f"run_machine: code {tuple(code.shape)} != "
                         f"({B}, {p.code_cap + 33})")
    for k in ("code",) + _LANE_INPUTS + _ENV_WORDS:
        t = inputs[k]
        if t.device != dev or t.dtype not in (torch.int32, torch.bool):
            raise ValueError(f"run_machine: {k} must be int32 on {dev}")
    if dev.type == "cpu":
        st = run_plain(p, inputs)
        return st["packed"], st["steps"]
    if dev.type != "cuda":
        raise ValueError(f"run_machine: unsupported device {dev}")
    global LAUNCHES
    lib = kernels.load("step_machine")
    lane = [inputs[k].to(torch.int32).contiguous() for k in _LANE_INPUTS]
    code = code.contiguous()
    env = _env_words(inputs, dev).contiguous()
    tb = _tables(p.fork, dev)
    tables = torch.stack([tb["const_gas"], tb["nin"], tb["nout"],
                          tb["supported"]]).to(torch.int32).contiguous()
    S, TC = p.scache_cap, p.tcache_cap
    packed = torch.empty((B, p.width), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    # per-lane scratch arena: stack (8 x u32 words), memory bytes, and
    # the transient cache (keys + values, 8 x u32 words each)
    arena = torch.empty(
        (B, p.stack_cap * 32 + p.mem_cap + 2 * TC * 32),
        dtype=torch.uint8, device=dev)
    dims = np.array([B, p.stack_cap, p.mem_cap, p.code_cap, p.data_cap, S,
                     TC, p.log_cap, p.log_data_cap, p.keccak_cap,
                     p.copy_cap, p.max_steps, int(p.refunds),
                     int(inputs["timestamp"]),
                     int(inputs["number"]), int(inputs["gaslimit"]),
                     p.width, arena.shape[1]], dtype=np.int32)
    rc = lib.step_machine_launch(
        code.data_ptr(), *(t.data_ptr() for t in lane), env.data_ptr(),
        tables.data_ptr(), dims.ctypes.data, packed.data_ptr(),
        steps.data_ptr(), arena.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "step_machine")
    LAUNCHES += 1
    return packed, steps


# ------------------------------------------------------------------- OCC
# The fused, device-resident OCC window (K6): the Block-STM round loop,
# read-set validation and the cross-block state fold run inside one
# launch per window of machine blocks, against a global slot-value table
# that stays on the device.  Lanes carry their read/write sets in the
# storage cache of their packed row; the table row of each cache entry
# is premapped by the host (``sgid``).

@dataclass(frozen=True)
class OccParams:
    """Shape of one fused OCC window launch."""
    blocks: int        # W — machine blocks per launch
    table_cap: int     # G — global slot-table rows
    rounds: int        # per-block OCC round cap (batch + 1 converges)


# per-lane result fields the OCC loop carries between rounds
_OCC_RES = ("status", "gas", "refund", "host_reason", "scnt", "sflag",
            "skey", "sval", "sorig", "log_top", "log_nt", "log_data",
            "log_dlen", "log_cnt")

# per-block exec inputs of a window (leading axis W), as build_machine
# takes them for one block
_EXEC_KEYS = ("code", "jdest", "code_len", "calldata", "data_len",
              "start_gas", "callvalue", "caller_w", "address_w",
              "origin_w", "gasprice_w", "timestamp", "number",
              "gaslimit", "coinbase_w", "basefee_w")

# Integer operations the kernel spends per lane per validation sweep,
# per storage-cache entry: the table/overlay gather (stamp test + 16
# limbs), the 16-limb compare against ``sorig``, the flag tests and the
# seed or overlay write.  The K6 bound uses it with the rounds each block
# ran.
OPS_PER_SWEEP_ENTRY = 60

OCC_LAUNCHES = 0
# launches of K6's specialised variants (K7 inside), also in OCC_LAUNCHES
SPEC_LAUNCHES = 0


def _occ_res0(p: MachineParams, dev) -> dict:
    """The result of a lane that never ran: status SKIP, all else 0."""
    B, S, LC = p.batch, p.scache_cap, p.log_cap
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        status=torch.full((B,), SKIP, **i32),
        gas=torch.zeros((B,), **i32), refund=torch.zeros((B,), **i32),
        host_reason=torch.zeros((B,), **i32),
        scnt=torch.zeros((B,), **i32), sflag=torch.zeros((B, S), **i32),
        skey=torch.zeros((B, S, LIMBS), **i32),
        sval=torch.zeros((B, S, LIMBS), **i32),
        sorig=torch.zeros((B, S, LIMBS), **i32),
        log_top=torch.zeros((B, LC, 4, LIMBS), **i32),
        log_nt=torch.zeros((B, LC), **i32),
        log_data=torch.zeros((B, LC, p.log_data_cap), **i32),
        log_dlen=torch.zeros((B, LC), **i32),
        log_cnt=torch.zeros((B,), **i32))


def occ_run_plain(p: MachineParams, occ: OccParams, table: torch.Tensor,
                  key_tab: torch.Tensor, blocks_in: dict,
                  spec: tuple = ()) -> dict:
    """The plain version of K6 (with K7's plain programs): reference
    ``build_occ_machine``'s ``occ_run`` (machine.py:1024) written out in
    torch.

    table   (G, 16) int32 — committed slot values (not modified).
    key_tab (G, 16) int32 — slot-key words per table row.
    blocks_in — per-block inputs with leading axis W: the exec inputs of
      ``run_plain`` (``_EXEC_KEYS`` and ``active``), ``sgid`` (W, B, S)
      int32, the table row of each lane-cache entry (>= G: unused),
      ``prog_id`` (W, B) int32, each lane's index into ``spec`` (-1: the
      generic interpreter), ``kdig`` (W, B, KDIG_CAP, 16) int32, the
      lanes' host-evaluated keccak digests, and ``chainid_w`` (16,)
      shared across the window.
    spec — ``specialize.SpecProgram`` descriptors, the runner's program
      set in program-index order.

    Returns {"table": (G, 16), "packed": (W, B, width + 4), "steps":
    (W, B)}: per-lane results in the ``pack_result`` layout plus the
    committed / escape / pending / rounds columns, and the lane-steps
    each lane executed over all rounds (a traced lane counts its leaf's
    traced steps).  Blocks after the first dirty block ran against a
    speculative table; the runner discards them."""
    B, S, G, R = p.batch, p.scache_cap, occ.table_cap, occ.rounds
    dev = table.device
    if spec:
        from coreth_tpu_torch.evm.device import specialize as SP
        spec_fns = tuple(SP.build_spec_exec(prog, p) for prog in spec)
    else:
        spec_fns = ()
    if bool((blocks_in["prog_id"] >= len(spec)).any()):
        # the kernel traps on such a lane (no program to dispatch to)
        raise ValueError(f"occ_run_plain: a prog_id past the program set "
                         f"of {len(spec)}")
    tbl = table.clone()
    packed, steps_all = [], []
    lane_ids = torch.arange(B, dtype=torch.int32,
                            device=dev)[:, None].expand(B, S)
    for w in range(occ.blocks):
        exec_in = {k: blocks_in[k][w] for k in _EXEC_KEYS + ("kdig",)}
        exec_in["chainid_w"] = blocks_in["chainid_w"]
        prog_id = blocks_in["prog_id"][w]
        sgid = blocks_in["sgid"][w].long()
        active0 = blocks_in["active"][w].bool()
        premapped = sgid < G
        nkeys = premapped.sum(dim=1).to(torch.int32)
        sgc = sgid.clamp(0, G - 1)

        def gather(t2, gids, gc):
            return torch.where((gids < G)[..., None], t2[gc], 0)

        skey0 = gather(key_tab, sgid, sgc)
        sflag0 = torch.where(premapped, F_VALID, 0).to(torch.int32)
        res = _occ_res0(p, dev)
        rnd = 0
        pending = active0
        seeds = gather(tbl, sgid, sgc)
        committed = torch.zeros((B,), dtype=torch.bool, device=dev)
        escape = torch.zeros((B,), dtype=torch.bool, device=dev)
        t_out = tbl
        steps = torch.zeros((B,), dtype=torch.int32, device=dev)
        while rnd < R and bool(pending.any()) and not bool(escape.any()):
            st = _exec_mixed(p, exec_in, (skey0, seeds, seeds, sflag0,
                                          nkeys), pending, prog_id,
                             spec_fns)
            res = {f: torch.where(
                pending.reshape((B,) + (1,) * (res[f].dim() - 1)),
                st[f], res[f]) for f in _OCC_RES}
            steps = steps + torch.where(pending, st["steps"], 0)
            t_out, committed, pending, seeds, escape = _occ_sweep(
                res, tbl, sgid, sgc, premapped, seeds, active0, lane_ids,
                G, gather)
            rnd += 1
        tbl = t_out
        extra = torch.stack(
            [committed.to(torch.int32), escape.to(torch.int32),
             pending.to(torch.int32),
             torch.full((B,), rnd, dtype=torch.int32, device=dev)], dim=1)
        packed.append(torch.cat([pack_result(B, res), extra], dim=1))
        steps_all.append(steps)
    return dict(table=tbl, packed=torch.stack(packed),
                steps=torch.stack(steps_all))


def _exec_mixed(p: MachineParams, exec_in: dict, storage, active,
                prog_id, spec_fns) -> dict:
    """One round's exec (reference ``exec_mixed``, machine.py:1004): the
    generic interpreter on the lanes with ``prog_id < 0``, traced
    program k on the lanes with ``prog_id == k``, merged by lane mask."""
    skey, sval, sorig, sflag, scnt = storage

    def generic(mask):
        return run_plain(p, dict(exec_in, skey=skey, sval=sval,
                                 sorig=sorig, sflag=sflag, scnt=scnt,
                                 active=mask))
    if not spec_fns:
        return generic(active)
    out = generic(active & (prog_id < 0))
    out = {f: out[f] for f in _OCC_RES + ("steps",)}
    for k, fn in enumerate(spec_fns):
        mk = active & (prog_id == k)
        if not bool(mk.any()):
            continue
        stk = fn(exec_in, storage, mk)
        for f in out:
            m = mk.reshape((p.batch,) + (1,) * (out[f].dim() - 1))
            out[f] = torch.where(m, stk[f], out[f])
    return out


def _occ_sweep(res, tbl, sgid, sgc, premapped, seeds, active0, lane_ids,
               G, gather):
    """One round's validation in tx order against the block-start table
    (reference ``occ_body`` :1099-1193): the disjoint fast path when no
    lane reads or writes a row another lane may write, else the
    sequential sweep.  Returns (table after the valid lanes' writes,
    valid, re-pending, next seeds, escape)."""
    B, S = sgid.shape
    dev = tbl.device
    sflag, status = res["sflag"], res["status"]
    entry = torch.arange(S, device=dev)[None, :] < res["scnt"][:, None]
    missed = (entry & ((sflag & F_MISS) != 0)).any(dim=1)
    hosty = (status == HOST) | missed
    skip = status == SKIP
    rflags = entry & ((sflag & F_READ) != 0) & premapped
    pot_w = entry & ((sflag & F_WRITTEN) != 0) & premapped \
        & (~skip & ~hosty & (status == STOP))[:, None]
    gids_w_all = torch.where(pot_w, sgid, G).reshape(-1)
    nw = torch.zeros((G + 1,), dtype=torch.int32, device=dev)
    nw.index_add_(0, gids_w_all, torch.ones_like(gids_w_all,
                                                 dtype=torch.int32))
    wlane = torch.full((G + 1,), -1, dtype=torch.int32, device=dev)
    wlane[gids_w_all] = lane_ids.reshape(-1)
    rg = sgid.clamp(0, G)
    conflict = bool((nw[:G] > 1).any()) or bool(
        (rflags & (nw[rg] > 0) & (wlane[rg] != lane_ids)).any())
    sval, sorig = res["sval"], res["sorig"]
    if not conflict:
        cur0 = gather(tbl, sgid, sgc)
        match0 = (sorig == cur0).all(dim=-1)
        reads_ok0 = (~rflags | match0).all(dim=1)
        valid0 = ~skip & ~hosty & reads_ok0
        wr0 = pot_w & valid0[:, None]
        t2 = tbl.clone()
        t2[sgid[wr0]] = sval[wr0]
        pend0 = ~skip & ~hosty & ~reads_ok0
        seeds2 = torch.where(pend0[:, None, None], cur0, seeds)
        return t2, valid0, pend0, seeds2, hosty & active0
    t2 = tbl.clone()
    ok = torch.zeros((B,), dtype=torch.bool, device=dev)
    pend2 = torch.zeros((B,), dtype=torch.bool, device=dev)
    seeds2 = seeds.clone()
    for j in range(B):
        cur = gather(t2, sgid[j], sgc[j])                   # (S, 16)
        readf = entry[j] & ((sflag[j] & F_READ) != 0) & premapped[j]
        match = (sorig[j] == cur).all(dim=-1)
        reads_ok = bool((~readf | match).all())
        valid = not bool(skip[j]) and not bool(hosty[j]) and reads_ok
        if valid and int(status[j]) == STOP:
            wr = entry[j] & ((sflag[j] & F_WRITTEN) != 0) & premapped[j]
            t2[sgid[j][wr]] = sval[j][wr]
        if not bool(skip[j]) and not bool(hosty[j]) and not reads_ok:
            seeds2[j] = cur
            pend2[j] = True
        ok[j] = valid
    return t2, ok, pend2, seeds2, hosty & active0


def _check_window(what: str, p: MachineParams, occ: OccParams,
                  table: torch.Tensor, key_tab: torch.Tensor,
                  blocks_in: dict, n: int = 1) -> torch.device:
    """Raise ValueError unless the window's tensors have K6's shapes
    (K9's with ``n`` shards: lanes ``n * batch``, tables ``n * table_cap``
    rows) and lie on one CPU or CUDA device; returns the device."""
    from coreth_tpu_torch.evm.device import specialize as SP
    dev = table.device
    B, S, W, G = n * p.batch, p.scache_cap, occ.blocks, n * occ.table_cap
    if table.shape != (G, LIMBS) or key_tab.shape != (G, LIMBS):
        raise ValueError(f"{what}: tables {tuple(table.shape)}, "
                         f"{tuple(key_tab.shape)} != ({G}, {LIMBS})")
    shapes = {"code": (W, B, p.code_cap + 33), "jdest": (W, B, p.code_cap),
              "calldata": (W, B, p.data_cap), "sgid": (W, B, S),
              "active": (W, B), "timestamp": (W,),
              "chainid_w": (LIMBS,), "coinbase_w": (W, LIMBS),
              "prog_id": (W, B), "kdig": (W, B, SP.KDIG_CAP, LIMBS)}
    for k in _EXEC_KEYS + ("active", "sgid", "prog_id", "kdig",
                           "chainid_w"):
        t = blocks_in[k]
        if t.device != dev or t.dtype not in (torch.int32, torch.bool):
            raise ValueError(f"{what}: {k} must be int32 on {dev}")
        if k in shapes and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{what}: {k} {tuple(t.shape)} != "
                             f"{shapes[k]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and S * LIMBS * 4 > 48 * 1024:
        raise ValueError(f"{what}: scache_cap {S} exceeds the sweep's "
                         "shared-memory row buffer")
    return dev


def run_occ_window(p: MachineParams, occ: OccParams, table: torch.Tensor,
                   key_tab: torch.Tensor, blocks_in: dict,
                   spec: tuple = ()) -> dict:
    """K6: one fused OCC window.  CUDA inputs launch ``csrc/occ_window.cu``
    — its generic build for an empty program set, else the specialised
    variant generated for ``spec`` (K7 inside; built by nvcc at its
    first use, synchronously) — asynchronously on the current stream:
    nothing here waits for the card.  CPU inputs run ``occ_run_plain``.
    Same arguments and result as ``occ_run_plain``; ``prog_id`` must
    index ``spec`` or be -1 (else the plain version raises and the
    kernel traps, which fails the launch)."""
    from coreth_tpu_torch.evm.device import specialize as SP
    dev = _check_window("run_occ_window", p, occ, table, key_tab, blocks_in)
    if dev.type == "cpu":
        return occ_run_plain(p, occ, table, key_tab, blocks_in, spec)
    global OCC_LAUNCHES, SPEC_LAUNCHES
    if spec:
        lib = SP.occ_library(spec)
    else:
        lib = kernels.load("occ_window")
    args, out = occ_launch_args(p, occ, table, key_tab, blocks_in)
    rc = lib.occ_window_launch(
        *pointers(args), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "occ_window")
    OCC_LAUNCHES += 1
    SPEC_LAUNCHES += bool(spec)
    return out


def occ_launch_args(p: MachineParams, occ: OccParams, table: torch.Tensor,
                    key_tab: torch.Tensor, blocks_in: dict, n: int = 1):
    """``occ_window_launch``'s arguments but the stream (arrays on the
    inputs' device; ``pointers`` gives the launch's addresses) and its
    outputs {"table", "packed", "steps"}: the wrapper allocates the
    outputs and every scratch buffer, the kernel nothing.  With ``n``
    shards (K9) the lane tensors are ``n * batch`` wide, the tables
    ``n * table_cap`` rows, and every scratch buffer holds one slice per
    shard."""
    dev = table.device
    B, S, W, G = p.batch, p.scache_cap, occ.blocks, occ.table_cap
    NB = n * B
    lane = [blocks_in[k].to(torch.int32).contiguous()
            for k in _OCC_LANE_INPUTS]
    env = torch.stack([blocks_in["coinbase_w"],
                       blocks_in["chainid_w"].reshape(1, LIMBS).expand(
                           W, LIMBS),
                       blocks_in["basefee_w"]], dim=1).to(
        torch.int32).contiguous()                            # (W, 3, 16)
    scal = torch.stack([blocks_in[k].to(torch.int32) for k in
                        ("timestamp", "number", "gaslimit")]).contiguous()
    tb = _tables(p.fork, dev)
    tables = torch.stack([tb["const_gas"], tb["nin"], tb["nout"],
                          tb["supported"]]).to(torch.int32).contiguous()
    TC = p.tcache_cap
    out_table = table.to(torch.int32).clone()
    key_tab = key_tab.to(torch.int32).contiguous()
    packed = torch.empty((W, NB, p.width + 4), dtype=torch.int32,
                         device=dev)
    steps = torch.empty((W, NB), dtype=torch.int32, device=dev)
    arena = torch.empty(
        (NB, p.stack_cap * 32 + p.mem_cap + 2 * TC * 32),
        dtype=torch.uint8, device=dev)
    # scratch: the lanes' storage-cache inputs (keys, seeds, flags, key
    # counts), the pending mask, and the sweep's per-row overlay
    # (values + the stamp of the sweep that wrote them)
    i32 = dict(dtype=torch.int32, device=dev)
    skey0 = torch.empty((NB, S, LIMBS), **i32)
    seeds = torch.empty((NB, S, LIMBS), **i32)
    lanes_i = torch.empty((n, 4, B), **i32)     # nkeys, pending, ok, esc
    sflag0 = torch.empty((NB, S), **i32)
    ov = torch.empty((n * G, LIMBS), **i32)
    stamp = torch.zeros((n * G,), **i32)
    dims = np.array([B, p.stack_cap, p.mem_cap, p.code_cap, p.data_cap, S,
                     TC, p.log_cap, p.log_data_cap, p.keccak_cap,
                     p.copy_cap, p.max_steps, int(p.refunds), 0, 0, 0,
                     p.width, arena.shape[1], W, G, occ.rounds],
                    dtype=np.int32)
    args = lane + [env, scal, tables, key_tab, dims, out_table, packed,
                   steps, arena, skey0, seeds, sflag0, lanes_i, ov, stamp]
    return args, dict(table=out_table, packed=packed, steps=steps)


def pointers(args):
    """The addresses of launch arguments (tensors and host arrays)."""
    return [a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()
            for a in args]


# Per-lane inputs of a window, in the order K6 takes them.
_OCC_LANE_INPUTS = ("code", "jdest", "code_len", "calldata", "data_len",
                    "start_gas", "active", "sgid", "prog_id", "kdig",
                    "callvalue", "caller_w", "address_w", "origin_w",
                    "gasprice_w")


# ------------------------------------------------------------------ K9
# The fused OCC window per shard of a mesh engine (reference
# evm/device/shard.py:151 build_sharded_occ_machine).  A sharded window's
# lane tensors are n * batch wide (shard d's lanes at [d*B, (d+1)*B) of
# every block row) and its tables n * table_cap rows (shard d's arena at
# [d*G, (d+1)*G)); the per-block leaves and chainid_w are shared.  K9x
# (:267 get_shard_exchange) reduces the shards' per-block flags.

OCC_SHARDED_LAUNCHES = 0
SHARD_FLAGS_LAUNCHES = 0


def _shard_in(blocks_in: dict, d: int, B: int, w=None) -> dict:
    """Shard d's window inputs (lanes [d*B, (d+1)*B)); with ``w`` only
    block w (a window of one block)."""
    out = {}
    for k, v in blocks_in.items():
        if k in _OCC_LANE_INPUTS:
            v = v[:, d * B:(d + 1) * B]
        if w is not None and k != "chainid_w":
            v = v[w:w + 1]
        out[k] = v
    return out


def occ_sharded_plain(p: MachineParams, occ: OccParams, table: torch.Tensor,
                      key_tab: torch.Tensor, blocks_in: dict,
                      spec: tuple = (), n: int = 1,
                      sync_rows: Optional[torch.Tensor] = None,
                      mode: str = "psum") -> dict:
    """The plain version of K9: ``occ_run_plain`` per shard over its
    lanes and arena (``p.batch`` and ``occ.table_cap`` are per-shard).

    ``sync_rows`` (X, n + 1) int32 with X > 0 is the key-range variant
    (reference ``run_kr``, shard.py:197-236): row j names key j's local
    row on each shard (``table_cap``: none there) and, last, its owner
    shard.  The window first gives every copy the owner's value; then
    the blocks run one at a time, and after each one a shard whose block
    changed a copy offers d + 1, the largest offer wins (a max-reduce),
    and the winner's value goes to every copy (an add-reduce); with no
    offer a row keeps its value.  Both reduces take ``mode``'s order
    (``collective_reduce_plain``).  Returns {"table": (n * G, 16),
    "packed": (W, n * B, width + 4), "steps": (W, n * B)}."""
    B, G, W = p.batch, occ.table_cap, occ.blocks
    tabs = [table[d * G:(d + 1) * G] for d in range(n)]
    keys = [key_tab[d * G:(d + 1) * G] for d in range(n)]
    if sync_rows is None or sync_rows.shape[0] == 0:
        outs = [occ_run_plain(p, occ, tabs[d], keys[d],
                              _shard_in(blocks_in, d, B), spec)
                for d in range(n)]
        return dict(table=torch.cat([o["table"] for o in outs]),
                    packed=torch.cat([o["packed"] for o in outs], dim=1),
                    steps=torch.cat([o["steps"] for o in outs], dim=1))
    occ1 = OccParams(blocks=1, table_cap=G, rounds=occ.rounds)
    rows = sync_rows.long()
    own = rows[:, n]
    has = [rows[:, d] < G for d in range(n)]
    idx = [rows[:, d].clamp(0, G - 1) for d in range(n)]

    def read(d):
        return torch.where(has[d][:, None], tabs[d][idx[d]], 0)

    def write(d, v):
        t = tabs[d].clone()
        t[idx[d][has[d]]] = v[has[d]]
        tabs[d] = t

    cur0 = [read(d) for d in range(n)]
    val0 = collective_reduce_plain(torch.stack(
        [torch.where((own == d)[:, None], cur0[d], 0) for d in range(n)]),
        mode, "add")
    for d in range(n):
        write(d, val0[d])
    packed, steps = [], []
    for w in range(W):
        pre = [read(d) for d in range(n)]
        outs = [occ_run_plain(p, occ1, tabs[d], keys[d],
                              _shard_in(blocks_in, d, B, w), spec)
                for d in range(n)]
        tabs = [o["table"] for o in outs]
        cur = [read(d) for d in range(n)]
        changed = [has[d] & (cur[d] != pre[d]).any(dim=1) for d in range(n)]
        cand = torch.stack([torch.where(changed[d], d + 1, 0).to(
            torch.int32) for d in range(n)])
        win = collective_reduce_plain(cand, mode, "max")
        val = collective_reduce_plain(torch.stack(
            [torch.where((changed[d] & (cand[d] == win[d]))[:, None],
                         cur[d], 0) for d in range(n)]), mode, "add")
        for d in range(n):
            write(d, torch.where((win[d] > 0)[:, None], val[d], cur[d]))
        packed.append(torch.cat([o["packed"][0] for o in outs]))
        steps.append(torch.cat([o["steps"][0] for o in outs]))
    return dict(table=torch.cat(tabs), packed=torch.stack(packed),
                steps=torch.stack(steps))


def shard_flags_plain(packed: torch.Tensor, active: torch.Tensor, n: int,
                      mode: str = "psum") -> torch.Tensor:
    """The plain version of K9x: per block, the shards whose active lanes
    all committed and the shards with an active lane that escaped or is
    still pending (columns -4, -3 and -2 of the packed rows), summed
    over the shards in ``mode``'s order: (W, 2) int32."""
    W, NB, _ = packed.shape
    B = NB // n
    act = active.bool()
    com = packed[:, :, -4] != 0
    esc = (packed[:, :, -3] != 0) | (packed[:, :, -2] != 0)
    clean = (~act | com).view(W, n, B).all(dim=2)
    dirty = (act & esc).view(W, n, B).any(dim=2)
    flags = torch.stack([clean.to(torch.int32), dirty.to(torch.int32)],
                        dim=2)                                  # (W, n, 2)
    return collective_reduce_plain(flags.transpose(0, 1).contiguous(),
                                   mode, "add")[0]


def _check_mesh(what: str, n: int, mode: str) -> None:
    if not isinstance(n, int) or n < 1 or n & (n - 1) or n > MAX_SHARDS:
        raise ValueError(f"{what}: {n!r} shards; the width must be a power "
                         f"of two in [1, {MAX_SHARDS}]")
    if mode not in ("psum", "ppermute"):
        raise ValueError(f"{what}: unknown mode {mode!r}")


def run_occ_sharded(p: MachineParams, occ: OccParams, table: torch.Tensor,
                    key_tab: torch.Tensor, blocks_in: dict,
                    spec: tuple = (), n: int = 1,
                    sync_rows: Optional[torch.Tensor] = None,
                    mode: str = "psum") -> dict:
    """K9: one sharded window.  CUDA inputs launch ``occ_sharded_launch``
    of ``csrc/occ_window.cu`` (one cluster of n CTAs, asynchronous on the
    current stream) from the generic library or, for a program set, its
    specialised variant (K7 inside, built at its first use); CPU inputs
    run ``occ_sharded_plain``.  Same arguments and result; a cluster
    that does not fit on the card raises.  The kernel sums the shards in
    shard order whatever ``mode``: integer adds and maxes, so on one card
    the mode's order cannot be observed."""
    from coreth_tpu_torch.evm.device import specialize as SP
    _check_mesh("run_occ_sharded", n, mode)
    dev = _check_window("run_occ_sharded", p, occ, table, key_tab,
                        blocks_in, n)
    X = 0 if sync_rows is None else sync_rows.shape[0]
    if X and (sync_rows.shape != (X, n + 1) or sync_rows.device != dev):
        raise ValueError(f"run_occ_sharded: sync_rows "
                         f"{tuple(sync_rows.shape)} on {sync_rows.device} "
                         f"!= (X, {n + 1}) on {dev}")
    if dev.type == "cpu":
        return occ_sharded_plain(p, occ, table, key_tab, blocks_in, spec, n,
                                 sync_rows, mode)
    global OCC_SHARDED_LAUNCHES
    lib = SP.occ_library(spec) if spec else kernels.load("occ_window")
    args, out = occ_launch_args(p, occ, table, key_tab, blocks_in, n)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = (sync_rows.to(torch.int32).contiguous() if X
            else torch.zeros((1, n + 1), **i32))
    pre = torch.empty((n, max(X, 1), LIMBS), **i32)
    xc = torch.empty((2, n, max(X, 1)), **i32)
    xv = torch.empty((2, n, max(X, 1), LIMBS), **i32)
    rc = lib.occ_sharded_launch(
        n, X, rows.data_ptr(), pre.data_ptr(),
        xc.data_ptr(), xv.data_ptr(), *pointers(args),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc == -1:
        raise RuntimeError(f"occ_sharded: no cluster of {n} CTAs fits on "
                           "this card")
    kernels.check(rc, "occ_sharded")
    OCC_SHARDED_LAUNCHES += 1
    return out


def shard_flags(packed: torch.Tensor, active: torch.Tensor, n: int,
                mode: str = "psum") -> torch.Tensor:
    """K9x: ``shard_flags_launch`` of ``csrc/occ_window.cu`` on CUDA
    tensors (asynchronous on the current stream, behind K9), the plain
    version on CPU ones.  packed (W, n * B, width + 4), active (W, n * B)
    int32; returns (W, 2) int32.  ``mode`` picks the plain version's
    order only (as for K9)."""
    _check_mesh("shard_flags", n, mode)
    W, NB, PW = packed.shape
    if NB % n or tuple(active.shape) != (W, NB) \
            or active.device != packed.device:
        raise ValueError(f"shard_flags: packed {tuple(packed.shape)}, "
                         f"active {tuple(active.shape)}, {n} shards")
    dev = packed.device
    if dev.type == "cpu":
        return shard_flags_plain(packed, active, n, mode)
    if dev.type != "cuda":
        raise ValueError(f"shard_flags: unsupported device {dev}")
    global SHARD_FLAGS_LAUNCHES
    lib = kernels.load("occ_window")
    packed = packed.to(torch.int32).contiguous()
    active = active.to(torch.int32).contiguous()
    flags = torch.empty((W, 2), dtype=torch.int32, device=dev)
    rc = lib.shard_flags_launch(
        packed.data_ptr(), active.data_ptr(), W, NB, NB // n, PW,
        flags.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "shard_flags")
    SHARD_FLAGS_LAUNCHES += 1
    return flags
