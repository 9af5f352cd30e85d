// The per-lane helpers of K7's generated programs for Hopper (sm_90a).
//
// K7 replaces the reference's traced straight-line programs
//   coreth_tpu/evm/device/specialize.py:1152 build_spec_exec
//   (the emit mode of _Tracer, :213-1084),
// which ran one contract's bytecode, traced once, batch-wise over the
// lanes whose code selected it inside the fused OCC window.  Here
// coreth_tpu_torch/evm/device/specialize.py (cuda_source) writes one
// __device__ function per traced program over ONE lane; K6
// (occ_window.cu) calls it through spec_dispatch for lanes with
// prog_id >= 0.  This header holds what every generated function
// calls: the lane's runtime state (SpecLane), the lumped gas charge,
// the storage op (a transcription of _storage_op, :472-583), the log
// op (_log_op, :585), the device keccak fallback, calldata words and
// the leaf write-out (_leaf, _leaf_err, _leaf_host, :624-664).  Values
// are K4's u256 (u256x.cuh), keccak is K3's (keccak.cuh), and the
// storage cache and log pool live in the lane's packed row exactly as
// K5's lane interpreter keeps them (step_machine.cuh), flags included.
//
// A lane reaches exactly one leaf.  Until then it computes every
// traced value, also after it has erred or escaped: its path choices
// then follow the reference's path masks, and only the effectful ops
// (gas, storage writes, logs) test whether it is still live.
//
// Bound: a traced lane is a few hundred integer operations per storage
// op and per 256-bit product, no fetch, no dispatch and no stack or
// memory traffic (stack values and the word-aligned memory model are
// locals); what remains in device memory is the lane's storage cache
// and log rows, as in K5.

#pragma once

#include <cstdint>

#include "step_machine.cuh"

struct SpecLane {
  int gas, refund, host_reason, scnt, log_cnt;
  bool err, hosty;
};

__device__ __forceinline__ u256 u256_c(uint32_t w0, uint32_t w1, uint32_t w2,
                                       uint32_t w3, uint32_t w4, uint32_t w5,
                                       uint32_t w6, uint32_t w7) {
  u256 r;
  r.w[0] = w0;
  r.w[1] = w1;
  r.w[2] = w2;
  r.w[3] = w3;
  r.w[4] = w4;
  r.w[5] = w5;
  r.w[6] = w6;
  r.w[7] = w7;
  return r;
}

__device__ __forceinline__ u256 u256_and(const u256& a, const u256& b) {
  u256 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = a.w[k] & b.w[k];
  return r;
}

__device__ __forceinline__ u256 u256_or(const u256& a, const u256& b) {
  u256 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = a.w[k] | b.w[k];
  return r;
}

__device__ __forceinline__ u256 u256_xor(const u256& a, const u256& b) {
  u256 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = a.w[k] ^ b.w[k];
  return r;
}

// DIV / MOD out of line: the division is the largest ALU body
__device__ __noinline__ u256 spec_div(u256 a, u256 b) {
  return u256_divmod_op(0x04, a, b);
}

__device__ __noinline__ u256 spec_mod(u256 a, u256 b) {
  return u256_divmod_op(0x06, a, b);
}

__device__ __forceinline__ bool spec_live(const SpecLane& L) {
  return !L.err && !L.hosty;
}

// The path's start (reference _Tracer.run): the lane's full gas,
// nothing charged, refunded, logged or escaped.  The window has already
// seeded the lane's row as K5 seeds it (occ_window.cu's exec phase).
__device__ __noinline__ void spec_begin(const MachineIn& in,
                                        const MachineDims& d, int i,
                                        int32_t* row, SpecLane* L) {
  L->gas = in.start_gas[i];
  L->refund = 0;
  L->host_reason = R_NONE;
  L->scnt = in.scnt[i];
  L->log_cnt = 0;
  L->err = false;
  L->hosty = false;
}

// _flush: the lumped constant gas of the pure steps since the last
// effectful op; a live lane that cannot pay it errs
__device__ __forceinline__ void spec_flush(SpecLane* L, int accum) {
  const bool live = spec_live(*L);
  const bool oog = live && L->gas < accum;
  if (live && !oog) L->gas -= accum;
  L->err |= oog;
}

// _charge: one effectful step's static cost; returns whether the lane
// paid it (live and affording)
__device__ __forceinline__ bool spec_charge(SpecLane* L, int cost) {
  const bool live = spec_live(*L);
  const bool oog = live && L->gas < cost;
  const bool ok = live && !oog;
  if (ok) L->gas -= cost;
  L->err |= oog;
  return ok;
}

// GAS: what is left after the step's own constant cost
__device__ __forceinline__ u256 spec_gas_word(const SpecLane& L, int cg) {
  const int g = L.gas - cg;
  return u256_small((uint32_t)(g > 0 ? g : 0));
}

__device__ __forceinline__ void spec_err_live(SpecLane* L) {
  if (spec_live(*L)) L->err = true;
}

__device__ __forceinline__ void spec_host_live(SpecLane* L, int reason) {
  if (spec_live(*L)) {
    L->hosty = true;
    L->host_reason = reason;
  }
}

// _leaf: the lane's status and counters into its row (ERR burns the
// gas left; a HOST escape wins over the leaf's own status)
__device__ __forceinline__ int spec_leaf(const MachineDims& d, int32_t* row,
                                         const SpecLane& L, int status,
                                         int steps) {
  if (L.err) status = SM_ERR;
  if (L.hosty) status = SM_HOST;
  row[0] = status;
  row[1] = status == SM_ERR ? 0 : L.gas;
  row[2] = L.refund;
  row[3] = L.host_reason;
  row[4] = L.scnt;
  row[sm_row_layout(d).LOGCNT] = L.log_cnt;
  return steps;
}

// CALLDATALOAD at a trace-time offset below 2^25: big-endian bytes of
// the calldata, zero past its length and past the data capacity
__device__ __forceinline__ u256 spec_calldataload(const MachineIn& in,
                                                  const MachineDims& d,
                                                  int i, int off) {
  const int32_t* cd = in.calldata + (size_t)i * d.data_cap;
  const int len = in.data_len[i];
  uint8_t be[32];
  for (int j = 0; j < 32; ++j) {
    const int idx = off + j;
    be[j] = idx < len && idx < d.data_cap ? (uint8_t)cd[idx] : 0;
  }
  return u256_from_be(be);
}

// big-endian byte `pos` of the memory-model words mw[0..] (in memory, so
// indexed directly)
__device__ __forceinline__ uint32_t spec_mem_byte(const u256* mw, int pos) {
  const int p = 31 - (pos & 31);  // little-endian byte position
  return (mw[pos >> 5].w[p >> 2] >> ((p & 3) * 8)) & 0xFFu;
}

// SHA3 on the device (neither constant nor a kdig request): `size`
// (<= 271) bytes from byte `s` of the memory-model words, absorbed as
// 32-bit words straight from them
__device__ __noinline__ u256 spec_keccak(const u256* mw, int s, int size) {
  uint32_t dg[8];
  keccak256_be_words(mw, s, size, dg);
  return sm_digest_word(dg);
}

// One SLOAD (returns the value read) or SSTORE against the lane's cache
// in its row: the first valid entry with the key, else a new entry with
// F_MISS and a speculative zero; EIP-2929 warm/cold, the EIP-2200
// ladder with its sentry and (from AP3, `refunds`) the EIP-3529 refund
// counter; a full cache escapes HOST with R_SCACHE.  Dead lanes only
// read.  A symbolic key loses bit 0 of its top byte (the multicoin
// partition); a constant key arrives with it already cleared.
__device__ __noinline__ u256 spec_storage(const MachineDims& d, int32_t* row,
                                          SpecLane* L, u256 key, bool key_sym,
                                          u256 nv, bool is_sstore, int cg,
                                          bool refunds) {
  const int S = d.S;
  const RowLayout o = sm_row_layout(d);
  if (key_sym) key.w[7] &= 0xFEFFFFFFu;
  const bool mask_any = spec_live(*L);
  int found = -1;
  for (int j = 0; j < S; ++j) {
    if ((row[o.SFLAG + j] & F_VALID) &&
        u256_eq(u256_from_limbs(row + o.SKEY + 16 * j), key)) {
      found = j;
      break;
    }
  }
  const u256 zero = u256_zero();
  const bool need_app = mask_any && found < 0;
  const bool full = need_app && L->scnt >= S;
  const int e = found >= 0 ? found : sm_clamp(L->scnt, 0, S - 1);
  const int eflag = row[o.SFLAG + e];
  const bool warm = found >= 0 && (eflag & F_WARM);
  const u256 cur = found >= 0 ? u256_from_limbs(row + o.SVAL + 16 * e) : zero;
  const u256 orig =
      found >= 0 ? u256_from_limbs(row + o.SORIG + 16 * e) : zero;
  const int gas = L->gas;
  int rd = 0, cost;
  bool sentry = false;
  if (!is_sstore) {
    cost = cg + (warm ? 100 : 2100);
  } else {
    sentry = mask_any && gas <= 2300;
    const bool eq_cn = u256_eq(cur, nv), eq_oc = u256_eq(orig, cur);
    const bool eq_on = u256_eq(orig, nv);
    const bool o_zero = u256_is_zero(orig), c_zero = u256_is_zero(cur);
    const bool n_zero = u256_is_zero(nv);
    const int base =
        eq_cn ? 100 : (eq_oc ? (o_zero ? 20000 : 5000 - 2100) : 100);
    cost = cg + (warm ? 0 : 2100) + base;
    if (refunds) {
      const int CL = 5000 - 2100 + 1900;  // EIP-3529 clears refund
      const bool dirty = !eq_cn && !eq_oc;
      if (!eq_cn && eq_oc && !o_zero && n_zero) rd += CL;
      if (dirty && !o_zero && c_zero) rd -= CL;
      if (dirty && !o_zero && !c_zero && n_zero) rd += CL;
      if (dirty && eq_on && o_zero) rd += 20000 - 100;
      if (dirty && eq_on && !o_zero) rd += 5000 - 2100 - 100;
    }
  }
  const bool afford = gas >= cost;
  const bool do_entry = mask_any && !full;
  const bool do_write = do_entry && !sentry && afford;
  if (do_entry) {
    // the entry (with F_MISS) lands even when the op then errs: the
    // runner re-runs the lane with the true value only if recorded
    int wflag = eflag | F_VALID | F_READ | F_WARM;
    if (need_app) wflag |= F_MISS;
    if (is_sstore && do_write) wflag |= F_WRITTEN;
    if (need_app) {
      u256_to_limbs(key, row + o.SKEY + 16 * e);
      u256_to_limbs(zero, row + o.SVAL + 16 * e);
      u256_to_limbs(zero, row + o.SORIG + 16 * e);
      ++L->scnt;
    }
    if (is_sstore && do_write) u256_to_limbs(nv, row + o.SVAL + 16 * e);
    row[o.SFLAG + e] = wflag;
  }
  const bool oog = mask_any && !afford;
  const bool err_new = mask_any && (sentry || oog);
  const bool host_new = mask_any && !err_new && full;
  if (mask_any && !err_new && !host_new) {
    L->gas = gas - cost;
    L->refund += rd;
  }
  L->err |= err_new;
  if (host_new) {
    L->hosty = true;
    L->host_reason = R_SCACHE;
  }
  return found >= 0 ? cur : zero;
}

// LOGn into the lane's next log slot, when the lane paid for the step
// (`ok`): n topics (the rest zero), `size` data bytes from byte `s` of
// the memory-model words (zero past them)
__device__ __noinline__ void spec_log(const MachineDims& d, int32_t* row,
                                      SpecLane* L, bool ok, int n,
                                      const u256* tp, const u256* mw, int s,
                                      int size) {
  if (!ok) return;
  const RowLayout o = sm_row_layout(d);
  const int LC = d.LC, LD = d.LD;
  const int slot = sm_clamp(L->log_cnt, 0, LC - 1);
  for (int k = 0; k < 4; ++k)
    u256_to_limbs(tp[k], row + o.LOGTOP + (slot * 4 + k) * 16);
  row[o.LOGNT + slot] = n;
  for (int j = 0; j < LD; ++j)
    row[o.LOGDATA + slot * LD + j] =
        j < size ? (int32_t)spec_mem_byte(mw, s + j) : 0;
  row[o.LOGDLEN + slot] = size;
  ++L->log_cnt;
}
