// One block of value transfers on window-local tables: the body that the
// transfer-window kernel (K1, transfer_window.cu) and the sharded window
// kernel (K8, sharded_window.cu) share, for Hopper (sm_90a).
//
// Port of the reference's per-block step (coreth_tpu/replay/engine.py
// _step_core:209, _transfer_step:282, _slot_step:224, _gather_fetch:196
// and the ops/u256.py limb chains).  Every function here is called by
// all threads of one thread block, which loop over the block's lanes:
//
//   zero_touched  - zero the accumulator rows this block's lanes touch;
//   accumulate    - per-lane segment sums of a range of lanes (debit =
//                   value + fee, the buyGas requirement and the send
//                   count at the sender, the value at the recipient, the
//                   fee at the coinbase, the token amount at both slots)
//                   and the nonce-sequence check of those lanes;
//   apply_touched - each touched row once: its summed accumulators
//                   (through a callable, so K8 sums its shards' slabs in
//                   the exchange order), solvency against the pre-block
//                   value, then sub(add(value, credit), debit) and the
//                   nonce bump;
//   write_fetch   - the block's fetch rows (touched accounts, touched
//                   slots, the ok flag).
// K8 alone uses accumulate_limbs (accumulate's sums into its compact
// per-block rows, one thread a limb) and the warp-wide limb chains hw_*
// (nvcc only).
//
// Accumulators are uint32 limb sums normalized once: a limb takes at most
// 2 * pad adds of < 2^16, which fits while pad <= 32768 (the wrappers
// allow 16384).  An accumulator row is ACCW words: debit | required |
// credit | send count.  Limb values of every input are in [0, 2^16)
// (ops/u256.pack_np).  Integer adds are associative, so atomics in any
// order give the reference's sums exactly.

#pragma once

#include <cstdint>

namespace tw {

constexpr int LIMBS = 16;
constexpr int COLS = 72;            // pack_txd layout, see engine.TXD_COLS
constexpr int ACCW = 3 * LIMBS + 1; // debit | required | credit | count
constexpr int SACC = 2 * LIMBS;     // slot debit | slot credit
constexpr int FW = LIMBS + 1;       // fetch row: 16 limbs + nonce / flag

__device__ __forceinline__ bool in_range(int i, int n) {
  return i >= 0 && i < n;
}

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// running carry over 16 uint32 limb sums get(c0 .. c0+15); the carry out
// of limb 15 is dropped (mod 2^256, as u256.normalize)
template <class Get>
__device__ __forceinline__ void normalize(Get get, int c0, int* out) {
  unsigned carry = 0;
#pragma unroll
  for (int j = 0; j < LIMBS; ++j) {
    unsigned v = get(c0 + j) + carry;
    out[j] = (int)(v & 0xFFFFu);
    carry = v >> 16;
  }
}

// a >= b, most significant limb first (u256.gte)
__device__ __forceinline__ bool gte(const int* a, const int* b) {
#pragma unroll
  for (int j = LIMBS - 1; j >= 0; --j) {
    if (a[j] > b[j]) return true;
    if (a[j] < b[j]) return false;
  }
  return true;
}

// row = sub(add(row, credit), debit) mod 2^256 (u256.add / u256.sub)
__device__ __forceinline__ void apply(int* row, const int* credit,
                                      const int* debit) {
  int t[LIMBS];
  int carry = 0;
#pragma unroll
  for (int j = 0; j < LIMBS; ++j) {
    int v = row[j] + credit[j] + carry;
    t[j] = v & 0xFFFF;
    carry = v >> 16;
  }
  int borrow = 0;
#pragma unroll
  for (int j = 0; j < LIMBS; ++j) {
    int v = t[j] - debit[j] - borrow;
    borrow = v < 0;
    row[j] = v + (borrow << 16);
  }
}

// Zero the accumulator rows of every account and slot that a lane of
// [0, pad) touches, and the coinbase's.
__device__ void zero_touched(const int* __restrict__ txd, int pad, int L,
                             int SL, unsigned* __restrict__ acc,
                             unsigned* __restrict__ sacc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < pad; i += nt) {
    const int* row = txd + (int64_t)i * COLS;
    int rows[2] = {row[0], row[1]};
    for (int r : rows) {
      if (!in_range(r, L)) continue;
      for (int j = 0; j < ACCW; ++j) acc[(int64_t)r * ACCW + j] = 0u;
    }
    int srows[2] = {row[54], row[55]};
    for (int r : srows) {
      if (!in_range(r, SL)) continue;
      for (int j = 0; j < SACC; ++j) sacc[(int64_t)r * SACC + j] = 0u;
    }
  }
  const int cb = txd[5];  // coinbase, broadcast in every row
  if (tid == 0 && in_range(cb, L))
    for (int j = 0; j < ACCW; ++j) acc[(int64_t)cb * ACCW + j] = 0u;
}

// Segment sums of lanes [lo, hi) into acc / sacc, and their nonce check
// against the pre-block nonces ln (sets *bad on a mismatch).
__device__ void accumulate(const int* __restrict__ txd, int lo, int hi,
                           int L, int SL, const int* __restrict__ ln,
                           unsigned* __restrict__ acc,
                           unsigned* __restrict__ sacc, int* bad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cb = txd[5];
  for (int i = lo + tid; i < hi; i += nt) {
    const int* row = txd + (int64_t)i * COLS;
    if (row[4] == 0) continue;  // masked-out pad row adds nothing
    const int s = row[0], r = row[1];
    const int* value = row + 6;
    const int* fee = row + 22;
    const int* req = row + 38;
    const int* amt = row + 56;
    if (row[2] != ln[clamp_idx(s, L)] + row[3]) *bad = 1;
    // debit = add(value, fee), normalized per tx like the reference
    int debit[LIMBS];
    int carry = 0;
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) {
      int v = value[j] + fee[j] + carry;
      debit[j] = v & 0xFFFF;
      carry = v >> 16;
    }
    if (in_range(s, L)) {
      unsigned* a = acc + (int64_t)s * ACCW;
      for (int j = 0; j < LIMBS; ++j) {
        atomicAdd(a + j, (unsigned)debit[j]);
        atomicAdd(a + LIMBS + j, (unsigned)req[j]);
      }
      atomicAdd(a + 3 * LIMBS, 1u);
    }
    if (in_range(r, L)) {
      unsigned* a = acc + (int64_t)r * ACCW + 2 * LIMBS;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)value[j]);
    }
    if (in_range(cb, L)) {
      unsigned* a = acc + (int64_t)cb * ACCW + 2 * LIMBS;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)fee[j]);
    }
    const int fs = row[54], ts = row[55];
    if (in_range(fs, SL)) {
      unsigned* a = sacc + (int64_t)fs * SACC;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)amt[j]);
    }
    if (in_range(ts, SL)) {
      unsigned* a = sacc + (int64_t)ts * SACC + LIMBS;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)amt[j]);
    }
  }
}

// accumulate's sums for the sharded window (K8), one thread a (lane, limb)
// of lanes [lo, hi): into the accumulator row arow(r) of account r and
// srow(r) of slot r (K8's compact per-block rows), the same words as
// accumulate.  A limb's debit takes the value + fee carry chain up to it.
template <class ARow, class SRow>
__device__ void accumulate_limbs(const int* __restrict__ txd, int lo, int hi,
                                 int L, int SL, const int* __restrict__ ln,
                                 ARow arow, SRow srow, int* bad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cb = txd[5];
  for (int e = tid; e < (hi - lo) * LIMBS; e += nt) {
    const int* row = txd + (int64_t)(lo + e / LIMBS) * COLS;
    const int j = e % LIMBS;
    if (row[4] == 0) continue;  // masked-out pad row adds nothing
    const int s = row[0], r = row[1];
    const int* value = row + 6;
    const int* fee = row + 22;
    int carry = 0;
    for (int i = 0; i < j; ++i) carry = (value[i] + fee[i] + carry) >> 16;
    const unsigned debit = (unsigned)((value[j] + fee[j] + carry) & 0xFFFF);
    if (in_range(s, L)) {
      unsigned* a = arow(s);
      atomicAdd(a + j, debit);
      atomicAdd(a + LIMBS + j, (unsigned)row[38 + j]);
      if (j == 0) atomicAdd(a + 3 * LIMBS, 1u);
    }
    if (in_range(r, L)) atomicAdd(arow(r) + 2 * LIMBS + j, (unsigned)value[j]);
    if (in_range(cb, L)) atomicAdd(arow(cb) + 2 * LIMBS + j, (unsigned)fee[j]);
    const int fs = row[54], ts = row[55];
    const unsigned amt = (unsigned)row[56 + j];
    if (in_range(fs, SL)) atomicAdd(srow(fs) + j, amt);
    if (in_range(ts, SL)) atomicAdd(srow(ts) + LIMBS + j, amt);
    if (j == 0 && row[2] != ln[clamp_idx(s, L)] + row[3]) *bad = 1;
  }
}

#ifdef __CUDACC__
constexpr unsigned FULL = 0xFFFFFFFFu;

// u256 limb chains across a warp, one limb a lane: a 16-limb number in
// each 16-lane half (lane & 15 = limb).  A chain's carries resolve in one
// step: with G the limbs that carry out and P the limbs that pass a carry
// on (all ones), the carries in are (P + (G << 1)) ^ P, per half, the
// carry out of limb 15 dropped (mod 2^256).  Every lane of the warp calls
// these together.
__device__ __forceinline__ unsigned hw_carry_in(bool gen, bool prop,
                                               int lane) {
  const int h = lane & 16;
  const unsigned G = (__ballot_sync(FULL, gen) >> h) & 0xFFFFu;
  const unsigned P = (__ballot_sync(FULL, prop) >> h) & 0xFFFFu;
  return (((P + (G << 1)) ^ P) >> (lane & 15)) & 1u;
}

// uint32 limb sums (< 2^32) -> 16-bit limbs, as normalize
__device__ __forceinline__ unsigned hw_normalize(unsigned v, int lane) {
  unsigned c = __shfl_up_sync(FULL, v >> 16, 1);
  if ((lane & 15) == 0) c = 0;
  v = (v & 0xFFFFu) + c;  // < 2^17
  const bool gen = v > 0xFFFFu;
  v &= 0xFFFFu;
  return (v + hw_carry_in(gen, v == 0xFFFFu, lane)) & 0xFFFFu;
}

// (a + b) mod 2^256, limbs < 2^16
__device__ __forceinline__ unsigned hw_add(unsigned a, unsigned b, int lane) {
  unsigned s = a + b;
  const bool gen = s > 0xFFFFu;
  s &= 0xFFFFu;
  return (s + hw_carry_in(gen, s == 0xFFFFu, lane)) & 0xFFFFu;
}

// (a - b) mod 2^256, limbs < 2^16: a borrow passes through a zero limb
__device__ __forceinline__ unsigned hw_sub(unsigned a, unsigned b, int lane) {
  const bool brw = a < b;
  const unsigned d = (a - b) & 0xFFFFu;
  return (d - hw_carry_in(brw, d == 0, lane)) & 0xFFFFu;
}
#endif

// Each row a lane of [0, pad) or the coinbase touches, once (the first
// thread to stamp it with this block's k): its sums sum_a(r, c) /
// sum_s(r, c) normalized, solvency against the pre-block value (sets
// *bad), then sub(add(value, credit), debit) and the nonce bump.
template <class SumA, class SumS>
__device__ void apply_touched(const int* __restrict__ txd, int pad, int k,
                              int L, int SL, int* __restrict__ lb,
                              int* __restrict__ ln, int* __restrict__ ls,
                              int* __restrict__ stamp,
                              int* __restrict__ sstamp, SumA sum_a,
                              SumS sum_s, int* bad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cb = txd[5];
  for (int i = tid; i <= pad; i += nt) {
    int rows[2];
    int srows[2] = {-1, -1};
    if (i < pad) {
      const int* row = txd + (int64_t)i * COLS;
      rows[0] = row[0];
      rows[1] = row[1];
      srows[0] = row[54];
      srows[1] = row[55];
    } else {
      rows[0] = cb;
      rows[1] = -1;
    }
    for (int r : rows) {
      if (!in_range(r, L) || atomicExch(stamp + r, k) == k) continue;
      int debit[LIMBS], req[LIMBS], credit[LIMBS];
      auto get = [&](int c) { return sum_a(r, c); };
      normalize(get, 0, debit);
      normalize(get, LIMBS, req);
      normalize(get, 2 * LIMBS, credit);
      int* b = lb + (int64_t)r * LIMBS;
      const int n = (int)sum_a(r, 3 * LIMBS);
      if (n != 0 && !gte(b, req)) *bad = 1;
      apply(b, credit, debit);
      ln[r] += n;
    }
    for (int r : srows) {
      if (!in_range(r, SL) || atomicExch(sstamp + r, k) == k) continue;
      int debit[LIMBS], credit[LIMBS];
      auto get = [&](int c) { return sum_s(r, c); };
      normalize(get, 0, debit);
      normalize(get, LIMBS, credit);
      int* v = ls + (int64_t)r * LIMBS;
      if (!gte(v, debit)) *bad = 1;
      apply(v, credit, debit);
    }
  }
}

// The block's fetch rows at f: touched (balance, nonce) rows, touched
// slot rows, the ok flag (indices clamp like a jnp gather).
__device__ void write_fetch(int* __restrict__ f, const int* __restrict__ ti,
                            int t_pad, const int* __restrict__ si, int s_pad,
                            const int* __restrict__ lb,
                            const int* __restrict__ ln,
                            const int* __restrict__ ls, int L, int SL,
                            bool ok) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < t_pad * FW; e += nt) {
    int i = e / FW, j = e % FW;
    int l = clamp_idx(ti[i], L);
    f[e] = j < LIMBS ? lb[(int64_t)l * LIMBS + j] : ln[l];
  }
  for (int e = tid; e < s_pad * FW; e += nt) {
    int i = e / FW, j = e % FW;
    int l = clamp_idx(si[i], SL);
    f[t_pad * FW + e] = j < LIMBS ? ls[(int64_t)l * LIMBS + j] : 0;
  }
  for (int j = tid; j < FW; j += nt)
    f[(t_pad + s_pad) * FW + j] = j == 0 ? (ok ? 1 : 0) : 0;
}

}  // namespace tw
