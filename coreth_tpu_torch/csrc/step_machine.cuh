// The EVM step machine's lane interpreter (K5) for Hopper (sm_90a).
//
// One call runs one lane of a tx batch to completion: a fetch, then a
// `switch`-style dispatch per opcode, until the lane stops, reverts,
// errs, escapes to the host, or hits the step bound.  The kernel entry
// around it is step_machine.cu; the semantics are those of the
// reference's batch-wise step (coreth_tpu/evm/device/machine.py:175
// _build_exec) restricted to one lane, and the output is the same
// packed int32 row (machine.py:868 pack_result) in every column —
// status, gas, refund, host reason, the storage cache with its flags,
// and the log pool — including for lanes that end ERR, REVERT or HOST.
//
// State: pc/gas/sp/msize/counters in registers; the stack (8 x u32
// words per slot), memory bytes and the transient cache in the lane's
// scratch arena: a slot of its CTA's dynamic shared memory under the
// fused window (occ_window.cu) and under K5's batch kernel
// (step_machine.cu), slots an odd number of words apart so that lanes at
// the same offset hit different banks (sm_lane_stride, sm_lane_slot);
// in device memory under K5 when one arena does not fit a CTA's shared
// memory.  The caller seeds the lane's row first (sm_seed_row, a CTA's
// threads together).  Nothing is zeroed up front: the stack is never
// read at or above sp, the transient cache never past its count, and
// memory is zeroed word by word only as far as msize grows (every read
// lies below the new msize), so a lane pays for the memory it touches,
// not for mem_cap.  The storage cache and the log pool live directly in
// the lane's packed output row, in the reference's 16-bit limb layout
// (storage ops are a handful per tx, so converting at each access is
// cheap).  Arithmetic goes through u256x.cuh (K4), SHA3 through
// keccak.cuh (K3), read as 32-bit words from the lane's memory.  The
// `// @split` lines mark the lane's start and end and the ALU switch:
// occ_split.py --lanes inserts its cycle counters there, in a copy.

#pragma once

#include <cstdint>

#include "keccak.cuh"
#include "u256x.cuh"

// lane status
#define SM_RUN 0
#define SM_STOP 1
#define SM_REVERT 2
#define SM_ERR 3
#define SM_HOST 4
#define SM_SKIP 5
// storage-cache flag bits
#define F_VALID 1
#define F_WARM 2
#define F_WRITTEN 4
#define F_MISS 8
#define F_READ 16
// host reasons
#define R_NONE 0
#define R_STACK 1
#define R_MEM 2
#define R_SCACHE 3
#define R_TCACHE 4
#define R_LOG 5
#define R_COPY 6
#define R_KECCAK 7
#define R_STEPS 8
#define R_OPCODE 9

struct MachineDims {
  int B, stack_cap, mem_cap, code_cap, data_cap, S, TC, LC, LD,
      keccak_cap, copy_cap, max_steps, refunds, timestamp, number,
      gaslimit, width, arena_w;
};

struct MachineIn {
  const int32_t *code, *jdest, *code_len, *calldata, *data_len, *start_gas,
      *active, *skey, *sval, *sorig, *sflag, *scnt, *callvalue, *caller,
      *address, *origin, *gasprice;
  const int32_t* env;     // (3, 16): coinbase, chain id, base fee
  const int32_t* tables;  // (4, 256): const gas, nin, nout, supported
};

__device__ __forceinline__ int sm_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (value, fits < 2^25); a non-fitting value reads as the 2^25 sentinel
__device__ __forceinline__ int sm_fits25(const u256& w, bool* fits) {
  bool hi = false;
  for (int i = 1; i < 8; ++i) hi |= w.w[i] != 0;
  *fits = !hi && w.w[0] < (1u << 25);
  return *fits ? (int)w.w[0] : (1 << 25);
}

__device__ __forceinline__ int sm_mem_cost(int words) {
  return words * 3 + words * words / 512;
}

__device__ __forceinline__ u256 sm_scalar(int v) {
  return u256_small((uint32_t)v);
}

// a keccak digest (8 little-endian words: bytes 0..31) as the EVM word
// whose big-endian bytes they are
__device__ __forceinline__ u256 sm_digest_word(const uint32_t dg[8]) {
  u256 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[7 - k] = keccak_bswap32(dg[k]);
  return r;
}

// The packed row's column offsets (pack_result): status, gas, refund,
// host reason, cache count, then the cache flags, keys, values and
// originals, the log pool's topic counts, data lengths, count, topics
// and data.
struct RowLayout {
  int SFLAG, SKEY, SVAL, SORIG, LOGNT, LOGDLEN, LOGCNT, LOGTOP, LOGDATA;
};

__device__ __forceinline__ RowLayout sm_row_layout(const MachineDims& d) {
  RowLayout o;
  o.SFLAG = 5;
  o.SKEY = o.SFLAG + d.S;
  o.SVAL = o.SKEY + 16 * d.S;
  o.SORIG = o.SVAL + 16 * d.S;
  o.LOGNT = o.SORIG + 16 * d.S;
  o.LOGDLEN = o.LOGNT + d.LC;
  o.LOGCNT = o.LOGDLEN + d.LC;
  o.LOGTOP = o.LOGCNT + 1;
  o.LOGDATA = o.LOGTOP + d.LC * 64;
  return o;
}

// Lane slots in a CTA's dynamic shared memory (K5's batch kernel and
// K6's group): a slot of a lane's arena (stack_cap * 32 + mem_cap + 2 *
// TC * 32 bytes) rounded up to an odd number of words, so that lanes at
// the same offset hit different banks; the slot of thread tid of nt,
// lanes spread over the warps (slot s on warp s % warps).
__host__ __device__ __forceinline__ int sm_lane_stride(int arena_w) {
  return (((arena_w + 3) / 4) | 1) * 4;
}

__device__ __forceinline__ int sm_lane_slot(int tid, int nt) {
  const int nw = nt / 32 > 0 ? nt / 32 : 1;
  return (tid % 32) * nw + tid / 32;
}

// A lane's row before it runs: the storage cache is the lane's seeded
// input, the log pool empty.  Columns first, first + stride, ... of
// [SFLAG, width), so a CTA's threads seed a row together.
__device__ __forceinline__ void sm_seed_row(const MachineIn& in,
                                            const MachineDims& d, int i,
                                            int32_t* row, int first,
                                            int stride) {
  const RowLayout o = sm_row_layout(d);
  const size_t cache = (size_t)i * 16 * d.S;
  for (int k = o.SFLAG + first; k < d.width; k += stride) {
    int32_t v = 0;
    if (k < o.SKEY)
      v = in.sflag[(size_t)i * d.S + k - o.SFLAG];
    else if (k < o.SVAL)
      v = in.skey[cache + k - o.SKEY];
    else if (k < o.SORIG)
      v = in.sval[cache + k - o.SVAL];
    else if (k < o.LOGNT)
      v = in.sorig[cache + k - o.SORIG];
    row[k] = v;
  }
}

// Run lane i; returns the steps it executed.  `row` is the lane's
// packed output row, already seeded (sm_seed_row: its storage cache
// written, its log pool cleared); `arena` its scratch bytes.
__device__ int sm_run_lane(const MachineIn& in, const MachineDims& d, int i,
                           int32_t* row, uint8_t* arena) {
  const int S = d.S, LC = d.LC, LD = d.LD, TC = d.TC;
  const int CW = d.code_cap + 33;
  const RowLayout o = sm_row_layout(d);
  const int O_SFLAG = o.SFLAG, O_SKEY = o.SKEY, O_SVAL = o.SVAL,
            O_SORIG = o.SORIG, O_LOGNT = o.LOGNT, O_LOGDLEN = o.LOGDLEN,
            O_LOGCNT = o.LOGCNT, O_LOGTOP = o.LOGTOP, O_LOGDATA = o.LOGDATA;
  const int32_t* code = in.code + (size_t)i * CW;
  const int32_t* jdest = in.jdest + (size_t)i * d.code_cap;
  const int32_t* cdata = in.calldata + (size_t)i * d.data_cap;
  const int data_len = in.data_len[i];
  const int32_t* CONST = in.tables;
  const int32_t* NIN = in.tables + 256;
  const int32_t* NOUT = in.tables + 512;
  const int32_t* SUP = in.tables + 768;

  u256* stack = (u256*)arena;
  uint8_t* mem = arena + (size_t)d.stack_cap * 32;
  u256* tkey = (u256*)(mem + d.mem_cap);
  u256* tval = tkey + TC;

  int pc = 0, gas = in.start_gas[i], sp = 0, msize = 0, refund = 0;
  int status = in.active[i] ? SM_RUN : SM_SKIP, hreason = R_NONE;
  int scnt = in.scnt[i], tcnt = 0, log_cnt = 0, steps = 0;
  // @split lane-start

  while (status == SM_RUN && steps < d.max_steps) {
    ++steps;
    const int op = code[sm_clamp(pc, 0, CW - 1)];
    const int nin = NIN[op], nout = NOUT[op], sup = SUP[op];
    const int cg = CONST[op];
    const int newsp = sp - nin + nout;
    const bool over_1024 = newsp > 1024;
    const bool over_cap = newsp > d.stack_cap && !over_1024;
    // stack underflow/overflow, undefined op, INVALID: error, no effect
    if (sp < nin || over_1024 || sup == 0 || op == 0xFE) {
      status = SM_ERR;
      break;
    }
    const u256 zero = u256_zero();
    const u256 a = nin >= 1 ? stack[sp - 1] : zero;
    const u256 b = nin >= 2 ? stack[sp - 2] : zero;
    const u256 c = nin >= 3 ? stack[sp - 3] : zero;
    bool a_fit, b_fit, c_fit;
    const int a_v = sm_fits25(a, &a_fit);
    const int b_v = sm_fits25(b, &b_fit);
    const int c_v = sm_fits25(c, &c_fit);
    const bool b_zero = u256_is_zero(b), c_zero = u256_is_zero(c);

    const bool is_push = op >= 0x5F && op <= 0x7F;
    const bool is_swap = op >= 0x90 && op <= 0x9F;
    const bool is_log = op >= 0xA0 && op <= 0xA4;
    const bool is_keccak = op == 0x20;
    const bool copy3 = op == 0x37 || op == 0x39 || op == 0x5E;

    // ---- memory demand + expansion gas
    int need = 0;
    bool m_oog = false;
    if (op == 0x51 || op == 0x52) {
      need = a_v + 32;
      m_oog = !a_fit;
    } else if (op == 0x53) {
      need = a_v + 1;
      m_oog = !a_fit;
    } else if (is_keccak || op == 0xF3 || op == 0xFD || is_log) {
      if (!b_zero) {
        need = a_v + b_v;
        m_oog = !(a_fit && b_fit);
      }
    } else if (op == 0x37 || op == 0x39) {
      if (!c_zero) {
        need = a_v + c_v;
        m_oog = !(a_fit && c_fit);
      }
    } else if (op == 0x5E) {
      if (!c_zero) {
        need = (a_v > b_v ? a_v : b_v) + c_v;
        m_oog = !(a_fit && b_fit && c_fit);
      }
    }
    const bool m_host_mem = need > d.mem_cap && !m_oog;
    const int need_c = sm_clamp(need, 0, d.mem_cap);
    int new_msize = ((need_c + 31) / 32) * 32;
    if (new_msize < msize) new_msize = msize;
    int dyn = need > 0 ? sm_mem_cost(new_msize / 32) - sm_mem_cost(msize / 32)
                       : 0;
    if (copy3) dyn += ((c_v + 31) / 32) * 3;
    if (is_keccak) dyn += ((b_v + 31) / 32) * 6;
    if (is_log) dyn += 375 + (op - 0xA0) * 375 + b_v * 8;
    if (op == 0x0A) dyn += 10 + ((u256_bit_length(b) + 7) / 8) * 50;

    // ---- capacity escapes (host, not error); later reasons win
    bool m_host = m_host_mem || sup == 2 || over_cap;
    int reason = sup == 2 ? R_OPCODE : R_NONE;
    if (over_cap) reason = R_STACK;
    if (m_host_mem) reason = R_MEM;
    if (copy3 && c_v > d.copy_cap) {
      m_host = true;
      reason = R_COPY;
    }
    if (is_keccak && b_v > d.keccak_cap - 1) {
      m_host = true;
      reason = R_KECCAK;
    }
    if (is_log && (b_v > LD || log_cnt >= LC)) {
      m_host = true;
      reason = R_LOG;
    }

    // ---- jumps
    const bool take_jump = op == 0x56 || (op == 0x57 && !b_zero);
    if (take_jump &&
        !(a_fit && a_v < d.code_cap && jdest[sm_clamp(a_v, 0, d.code_cap - 1)] == 1))
      m_oog = true;  // bad jump: an error like the memory overflow
    if (m_oog) {
      status = SM_ERR;
      break;
    }
    // memory grows: its new words read as zero
    if (!m_host && need > 0)
      for (int k = msize / 4; k < new_msize / 4; ++k) ((uint32_t*)mem)[k] = 0;

    // ---- values, storage and transient families (ok_pre lanes)
    u256 val = zero;
    int cost_st = 0, rd = 0;
    bool st_err = false;
    if (!m_host) {
      if (is_push) {
        const int pushlen = op - 0x5F;
        uint8_t be[32];
        for (int j = 0; j < 32; ++j) {
          const int l = 31 - j;  // little-endian byte position
          be[j] = l < pushlen
                      ? (uint8_t)code[sm_clamp(pc + pushlen - l, 0, CW - 1)]
                      : 0;
        }
        val = u256_from_be(be);
      } else if (op >= 0x80 && op <= 0x8F) {
        val = stack[sp - 1 - (op - 0x80)];
      } else {
        // @split alu-start
        switch (op) {
          case 0x01: val = u256_add(a, b); break;
          case 0x02: val = u256_mul(a, b); break;
          case 0x03: val = u256_sub(a, b); break;
          // one division body for the four, one for the two modular ops
          case 0x04:
          case 0x05:
          case 0x06:
          case 0x07: val = u256_divmod_op(op, a, b); break;
          case 0x08:
          case 0x09: val = u256_modop(op == 0x09, a, b, c); break;
          case 0x0A: val = u256_exp(a, b); break;
          case 0x0B: val = u256_signextend(a, b); break;
          case 0x10: val = sm_scalar(u256_lt(a, b)); break;
          case 0x11: val = sm_scalar(u256_lt(b, a)); break;
          case 0x12: val = sm_scalar(u256_slt(a, b)); break;
          case 0x13: val = sm_scalar(u256_slt(b, a)); break;
          case 0x14: val = sm_scalar(u256_eq(a, b)); break;
          case 0x15: val = sm_scalar(u256_is_zero(a)); break;
          case 0x16:
            for (int k = 0; k < 8; ++k) val.w[k] = a.w[k] & b.w[k];
            break;
          case 0x17:
            for (int k = 0; k < 8; ++k) val.w[k] = a.w[k] | b.w[k];
            break;
          case 0x18:
            for (int k = 0; k < 8; ++k) val.w[k] = a.w[k] ^ b.w[k];
            break;
          case 0x19: val = u256_not(a); break;
          case 0x1A: val = u256_byte(a, b); break;
          case 0x1B: val = u256_shl(b, a); break;
          case 0x1C: val = u256_shr(b, a); break;
          case 0x1D: val = u256_sar(b, a); break;
          case 0x20: {
            uint32_t dg[8];
            keccak256_mem(mem, sm_clamp(a_v, 0, d.mem_cap), b_v, dg);
            val = sm_digest_word(dg);
            break;
          }
          case 0x30: val = u256_from_limbs(in.address + i * 16); break;
          case 0x32: val = u256_from_limbs(in.origin + i * 16); break;
          case 0x33: val = u256_from_limbs(in.caller + i * 16); break;
          case 0x34: val = u256_from_limbs(in.callvalue + i * 16); break;
          case 0x35: {
            uint8_t be[32];
            for (int j = 0; j < 32; ++j) {
              const int idx = a_v + j;
              be[j] = (a_fit && idx < data_len && idx < d.data_cap)
                          ? (uint8_t)cdata[idx]
                          : 0;
            }
            val = u256_from_be(be);
            break;
          }
          case 0x36: val = sm_scalar(data_len); break;
          case 0x38: val = sm_scalar(in.code_len[i]); break;
          case 0x3A: val = u256_from_limbs(in.gasprice + i * 16); break;
          case 0x41: val = u256_from_limbs(in.env); break;
          case 0x42: val = sm_scalar(d.timestamp); break;
          case 0x43: val = sm_scalar(d.number); break;
          case 0x44: val = sm_scalar(1); break;  // difficulty
          case 0x45: val = sm_scalar(d.gaslimit); break;
          case 0x46: val = u256_from_limbs(in.env + 16); break;
          case 0x48: val = u256_from_limbs(in.env + 32); break;
          case 0x51: {
            uint8_t be[32];
            const int off = sm_clamp(a_v, 0, d.mem_cap);
            for (int j = 0; j < 32; ++j)
              be[j] = mem[sm_clamp(off + j, 0, d.mem_cap - 1)];
            val = u256_from_be(be);
            break;
          }
          case 0x58: val = sm_scalar(pc); break;
          case 0x59: val = sm_scalar(msize); break;
          case 0x5A: val = sm_scalar(gas - cg > 0 ? gas - cg : 0); break;
          default: break;
        }
        // @split alu-end
      }

      if (op == 0x54 || op == 0x55) {
        // Avalanche multicoin partition: bit 0 of the key's top byte
        // is cleared for normal storage
        const bool is_sstore = op == 0x55;
        u256 key = a;
        key.w[7] &= 0xFEFFFFFFu;
        int found = -1;
        for (int j = 0; j < S; ++j) {
          if ((row[O_SFLAG + j] & F_VALID) &&
              u256_eq(u256_from_limbs(row + O_SKEY + 16 * j), key)) {
            found = j;
            break;
          }
        }
        const bool need_app = found < 0;
        const bool full = need_app && scnt >= S;
        const int e = found >= 0 ? found : sm_clamp(scnt, 0, S - 1);
        const int eflag = row[O_SFLAG + e];
        const bool warm = found >= 0 && (eflag & F_WARM);
        const u256 cur =
            found >= 0 ? u256_from_limbs(row + O_SVAL + 16 * e) : zero;
        const u256 orig =
            found >= 0 ? u256_from_limbs(row + O_SORIG + 16 * e) : zero;
        const bool sentry = is_sstore && gas <= 2300;
        if (!is_sstore) {
          cost_st = warm ? 100 : 2100;
        } else {
          // make_gas_sstore_eip2929
          const bool eq_cn = u256_eq(cur, b), eq_oc = u256_eq(orig, cur);
          const bool eq_on = u256_eq(orig, b);
          const bool o_zero = u256_is_zero(orig), cz = u256_is_zero(cur);
          const bool n_zero = b_zero;
          const int base = eq_cn ? 100
                                 : (eq_oc ? (o_zero ? 20000 : 5000 - 2100)
                                          : 100);
          cost_st = (warm ? 0 : 2100) + base;
          if (d.refunds) {
            const int CL = 5000 - 2100 + 1900;  // EIP-3529 clears refund
            const bool dirty = !eq_cn && !eq_oc;
            if (!eq_cn && eq_oc && !o_zero && n_zero) rd += CL;
            if (dirty && !o_zero && cz) rd -= CL;
            if (dirty && !o_zero && !cz && n_zero) rd += CL;
            if (dirty && eq_on && o_zero) rd += 20000 - 100;
            if (dirty && eq_on && !o_zero) rd += 5000 - 2100 - 100;
          }
        }
        const bool afford = gas >= cost_st;
        // the entry (with F_MISS) lands even when the op then errs: the
        // runner reruns the lane with the true value only if recorded
        if (!full) {
          const bool do_write = !sentry && afford;
          int wflag = eflag | F_VALID | F_READ | F_WARM;
          if (need_app) wflag |= F_MISS;
          if (is_sstore && do_write) wflag |= F_WRITTEN;
          if (need_app) {
            u256_to_limbs(key, row + O_SKEY + 16 * e);
            u256_to_limbs(zero, row + O_SORIG + 16 * e);
            u256_to_limbs(zero, row + O_SVAL + 16 * e);
            ++scnt;
          }
          if (is_sstore && do_write) u256_to_limbs(b, row + O_SVAL + 16 * e);
          row[O_SFLAG + e] = wflag;
          if (!is_sstore && do_write) val = cur;
        }
        st_err = sentry;
        if (full) {
          m_host = true;
          reason = R_SCACHE;
        }
      } else if (op == 0x5C || op == 0x5D) {
        const bool is_tstore = op == 0x5D;
        int found = -1;
        for (int j = 0; j < tcnt; ++j) {
          if (u256_eq(tkey[j], a)) {
            found = j;
            break;
          }
        }
        const bool need_app = is_tstore && found < 0;
        const bool t_full = need_app && tcnt >= TC;
        const int e = found >= 0 ? found : sm_clamp(tcnt, 0, TC - 1);
        if (!t_full) {
          if (is_tstore) {
            tkey[e] = a;
            tval[e] = b;
          } else {
            val = found >= 0 ? tval[e] : zero;
          }
          if (need_app) ++tcnt;
        } else {
          m_host = true;
          reason = R_TCACHE;
        }
      }
    }

    // ---- final gas + status resolution
    const int cost = cg + dyn + cost_st;
    if (st_err || gas < cost) {
      status = SM_ERR;
      break;
    }
    if (m_host) {
      status = SM_HOST;
      hreason = reason;
      break;
    }

    // ---- side effects of an ok step
    if (op == 0x52) {
      for (int j = 0; j < 32; ++j) mem[a_v + j] = (uint8_t)u256_be_byte(b, j);
    } else if (op == 0x53) {
      mem[a_v] = (uint8_t)(b.w[0] & 0xFFu);
    } else if (op == 0x37) {
      for (int j = 0; j < c_v; ++j) {
        const int src = b_v + j;
        mem[a_v + j] = (b_fit && src < data_len && src < d.data_cap)
                           ? (uint8_t)cdata[src]
                           : 0;
      }
    } else if (op == 0x39) {
      for (int j = 0; j < c_v; ++j) {
        const int src = b_v + j;
        mem[a_v + j] = (b_fit && src < CW) ? (uint8_t)code[src] : 0;
      }
    } else if (op == 0x5E) {
      // every byte reads the memory as it was before the copy
      if (a_v <= b_v) {
        for (int j = 0; j < c_v; ++j) mem[a_v + j] = mem[b_v + j];
      } else {
        for (int j = c_v - 1; j >= 0; --j) mem[a_v + j] = mem[b_v + j];
      }
    } else if (is_log) {
      const int n = op - 0xA0;
      const int slot = sm_clamp(log_cnt, 0, LC - 1);
      for (int k = 0; k < 4; ++k)
        u256_to_limbs(k < n ? stack[sp - 3 - k] : zero,
                      row + O_LOGTOP + (slot * 4 + k) * 16);
      row[O_LOGNT + slot] = n;
      for (int j = 0; j < LD; ++j)
        row[O_LOGDATA + slot * LD + j] =
            j < b_v ? mem[sm_clamp(a_v + j, 0, d.mem_cap - 1)] : 0;
      row[O_LOGDLEN + slot] = b_v;
      ++log_cnt;
    }
    if (is_swap) {
      const int n = op - 0x8F;
      stack[sp - 1] = stack[sp - 1 - n];
      stack[sp - 1 - n] = a;
    } else if (nout > 0) {
      stack[newsp - 1] = val;
    }

    // ---- advance
    if (op == 0x00 || op == 0xF3) status = SM_STOP;
    else if (op == 0xFD) status = SM_REVERT;
    gas -= cost;
    sp = newsp;
    if (status == SM_RUN) pc = take_jump ? a_v : pc + 1 + (is_push ? op - 0x5F : 0);
    if (need > 0) msize = new_msize;
    refund += rd;
  }
  if (status == SM_RUN) {  // still running at the step bound
    status = SM_HOST;
    hreason = R_STEPS;
  }
  if (status == SM_ERR) gas = 0;  // every error burns the remaining gas
  row[0] = status;
  row[1] = gas;
  row[2] = refund;
  row[3] = hreason;
  row[4] = scnt;
  row[O_LOGCNT] = log_cnt;
  // @split lane-end
  return steps;
}
