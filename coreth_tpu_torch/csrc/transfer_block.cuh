// The per-block transfer arithmetic shared by the window kernels, for
// Hopper (sm_90a): the sharded window (K8, sharded_window.cu), the
// sharded per-block steps (K8s, sharded_step.cu) and the transfer window
// (K1, transfer_window.cu, which takes the layout constants, the index
// helpers and normalize).
//
// Port of the reference's per-block step (coreth_tpu/replay/engine.py
// _step_core:209, _transfer_step:282, _slot_step:224, _gather_fetch:196
// and the ops/u256.py limb chains):
//
//   normalize / gte / apply - the u256 limb chains (u256.normalize, gte,
//                     sub(add(value, credit), debit));
//   accumulate_limbs - K8's per-lane segment sums into its compact
//                     per-block rows, one thread a (lane, limb): debit =
//                     value + fee, the buyGas requirement and the send
//                     count at the sender, the value at the recipient, the
//                     fee at the coinbase, the token amount at both slots,
//                     and the nonce-sequence check of those lanes;
//   hw_*            - K8's warp-wide limb chains (nvcc only).
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

// a gather's row as a jnp gather takes index i of n rows: a negative
// index counts from the end (i + n), then clamps to [0, n - 1]; so -2
// reads row n - 2 and -(n + 3) row 0
__device__ __forceinline__ int wrap_idx(int i, int n) {
  if (i < 0) i += n;
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
    if (j == 0 && row[2] != ln[wrap_idx(s, L)] + row[3]) *bad = 1;
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

}  // namespace tw
