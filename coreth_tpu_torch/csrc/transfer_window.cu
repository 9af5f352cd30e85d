// One window of value-transfer blocks in one launch, for Hopper (sm_90a).
//
// Replaces the reference's jitted device program
//   coreth_tpu/replay/engine.py:245 _transfer_window
//   (with _step_core:209, _transfer_step:282, _slot_step:224,
//    _gather_fetch:196 and the ops/u256.py limb chains).
// It gathers the window-local accounts and slots, runs the K blocks in
// order (each block's nonce-sequence and solvency checks, per-account
// debits / required balance / credits plus the coinbase fee, per-slot
// token debits and credits), writes one fetch row block per block and
// scatters the locals back.  The plain PyTorch version it is held
// against is engine._transfer_window_plain; both follow the reference
// bit for bit, including out-of-bounds pad gids (gather zeros, drop on
// scatter) and blocks whose ok flag is 0 (their state still applies,
// sub wrapping mod 2^256, and later blocks run on top).
//
// Design: blocks depend on each other in sequence, so ONE thread block
// loops over the K blocks with __syncthreads() between phases, working
// on window-local tables in device memory.  Per block it visits only
// the rows the block's txs touch (senders, recipients, coinbase, token
// slots) instead of all L locals: integer adds are associative, so
// accumulating with atomics in any order gives the reference's sums
// exactly, and rows no tx touches keep their values under the reference
// too.  Sums accumulate in uint32 limbs and normalize once: a limb takes
// at most 2 * pad adds of < 2^16, which fits while pad <= 32768 (the
// wrapper allows 16384).
//
// Bound: bytes — each table, the packed txs and the fetch rows read or
// written once, ~15 MB at main-path shapes (~4 us at 3.35 TB/s); a few
// hundred integer ops per tx are far below that.  This simple design
// is far from the bound: it waits on the chain of dependent phases (4
// barriers per block) and on device-memory and atomic latency inside
// one SM.
//
// Limb values of every input are in [0, 2^16) (ops/u256.pack_np).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LIMBS = 16;
constexpr int COLS = 72;     // pack_txd layout, see engine.TXD_COLS
constexpr int ACC = 3 * LIMBS;  // debit | required | credit
constexpr int SACC = 2 * LIMBS; // slot debit | slot credit

__device__ __forceinline__ bool in_range(int i, int n) {
  return i >= 0 && i < n;
}

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// running carry over 16 uint32 limb sums; the carry out of limb 15 is
// dropped (mod 2^256, as u256.normalize)
__device__ __forceinline__ void normalize(const unsigned* in, int* out) {
  unsigned carry = 0;
#pragma unroll
  for (int j = 0; j < LIMBS; ++j) {
    unsigned v = in[j] + carry;
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

__global__ void __launch_bounds__(1024) transfer_window_kernel(
    int* __restrict__ bal, int* __restrict__ non, int* __restrict__ sv,
    int cap, int scap, const int* __restrict__ acct_gids, int L,
    const int* __restrict__ slot_gids, int SL, const int* __restrict__ txds,
    int K, int pad, const int* __restrict__ t_idxs, int t_pad,
    const int* __restrict__ s_idxs, int s_pad, int* __restrict__ lb,
    int* __restrict__ ln, int* __restrict__ ls, unsigned* __restrict__ acc,
    int* __restrict__ cnt, int* __restrict__ stamp,
    unsigned* __restrict__ sacc, int* __restrict__ sstamp,
    int* __restrict__ fetches) {
  __shared__ int bad;
  const int tid = threadIdx.x, nt = blockDim.x;

  // gather the window-local rows; out-of-bounds gids read zeros
  for (int e = tid; e < L * LIMBS; e += nt) {
    int g = acct_gids[e / LIMBS];
    lb[e] = in_range(g, cap) ? bal[(int64_t)g * LIMBS + e % LIMBS] : 0;
  }
  for (int l = tid; l < L; l += nt) {
    int g = acct_gids[l];
    ln[l] = in_range(g, cap) ? non[g] : 0;
    stamp[l] = -1;
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    int g = slot_gids[e / LIMBS];
    ls[e] = in_range(g, scap) ? sv[(int64_t)g * LIMBS + e % LIMBS] : 0;
  }
  for (int l = tid; l < SL; l += nt) sstamp[l] = -1;
  __syncthreads();

  const int frows = t_pad + s_pad + 1;
  for (int k = 0; k < K; ++k) {
    const int* txd = txds + (int64_t)k * pad * COLS;
    const int cb = txd[5];  // coinbase, broadcast in every row
    if (tid == 0) bad = 0;

    // phase A: zero the accumulators of every row this block touches
    for (int i = tid; i < pad; i += nt) {
      const int* row = txd + (int64_t)i * COLS;
      int rows[2] = {row[0], row[1]};
      for (int r : rows) {
        if (!in_range(r, L)) continue;
        for (int j = 0; j < ACC; ++j) acc[(int64_t)r * ACC + j] = 0u;
        cnt[r] = 0;
      }
      int srows[2] = {row[54], row[55]};
      for (int r : srows) {
        if (!in_range(r, SL)) continue;
        for (int j = 0; j < SACC; ++j) sacc[(int64_t)r * SACC + j] = 0u;
      }
    }
    if (tid == 0 && in_range(cb, L)) {
      for (int j = 0; j < ACC; ++j) acc[(int64_t)cb * ACC + j] = 0u;
      cnt[cb] = 0;
    }
    __syncthreads();

    // phase B: per-tx segment sums and the nonce-sequence check
    for (int i = tid; i < pad; i += nt) {
      const int* row = txd + (int64_t)i * COLS;
      if (row[4] == 0) continue;  // masked-out pad row adds nothing
      const int s = row[0], r = row[1];
      const int* value = row + 6;
      const int* fee = row + 22;
      const int* req = row + 38;
      const int* amt = row + 56;
      if (row[2] != ln[clamp_idx(s, L)] + row[3]) bad = 1;
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
        unsigned* a = acc + (int64_t)s * ACC;
        for (int j = 0; j < LIMBS; ++j) {
          atomicAdd(a + j, (unsigned)debit[j]);
          atomicAdd(a + LIMBS + j, (unsigned)req[j]);
        }
        atomicAdd(cnt + s, 1);
      }
      if (in_range(r, L)) {
        unsigned* a = acc + (int64_t)r * ACC + 2 * LIMBS;
        for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)value[j]);
      }
      if (in_range(cb, L)) {
        unsigned* a = acc + (int64_t)cb * ACC + 2 * LIMBS;
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
    __syncthreads();

    // phase C: each touched row once (the first thread to stamp it with
    // this block's k): solvency against the pre-block value, then
    // sub(add(value, credit), debit) and the nonce bump
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
        const unsigned* a = acc + (int64_t)r * ACC;
        normalize(a, debit);
        normalize(a + LIMBS, req);
        normalize(a + 2 * LIMBS, credit);
        int* b = lb + (int64_t)r * LIMBS;
        const int n = cnt[r];
        if (n != 0 && !gte(b, req)) bad = 1;
        apply(b, credit, debit);
        ln[r] += n;
      }
      for (int r : srows) {
        if (!in_range(r, SL) || atomicExch(sstamp + r, k) == k) continue;
        int debit[LIMBS], credit[LIMBS];
        const unsigned* a = sacc + (int64_t)r * SACC;
        normalize(a, debit);
        normalize(a + LIMBS, credit);
        int* v = ls + (int64_t)r * LIMBS;
        if (!gte(v, debit)) bad = 1;
        apply(v, credit, debit);
      }
    }
    __syncthreads();

    // phase D: the block's fetch rows — touched (balance, nonce) rows,
    // touched slot rows, the ok flag (indices clamp like a jnp gather)
    int* f = fetches + (int64_t)k * frows * (LIMBS + 1);
    const int* ti = t_idxs + (int64_t)k * t_pad;
    const int* si = s_idxs + (int64_t)k * s_pad;
    for (int e = tid; e < t_pad * (LIMBS + 1); e += nt) {
      int i = e / (LIMBS + 1), j = e % (LIMBS + 1);
      int l = clamp_idx(ti[i], L);
      f[e] = j < LIMBS ? lb[(int64_t)l * LIMBS + j] : ln[l];
    }
    for (int e = tid; e < s_pad * (LIMBS + 1); e += nt) {
      int i = e / (LIMBS + 1), j = e % (LIMBS + 1);
      int l = clamp_idx(si[i], SL);
      f[t_pad * (LIMBS + 1) + e] = j < LIMBS ? ls[(int64_t)l * LIMBS + j] : 0;
    }
    for (int j = tid; j < LIMBS + 1; j += nt)
      f[(t_pad + s_pad) * (LIMBS + 1) + j] = j == 0 ? (bad ? 0 : 1) : 0;
    __syncthreads();
  }

  // scatter the locals back; out-of-bounds gids drop
  for (int e = tid; e < L * LIMBS; e += nt) {
    int g = acct_gids[e / LIMBS];
    if (in_range(g, cap)) bal[(int64_t)g * LIMBS + e % LIMBS] = lb[e];
  }
  for (int l = tid; l < L; l += nt) {
    int g = acct_gids[l];
    if (in_range(g, cap)) non[g] = ln[l];
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    int g = slot_gids[e / LIMBS];
    if (in_range(g, scap)) sv[(int64_t)g * LIMBS + e % LIMBS] = ls[e];
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  bal/non/sv are updated
// in place; the wrapper hands in clones of the engine's tables.  The
// scratch (lb, ln, ls, acc, cnt, stamp, sacc, sstamp) is allocated by
// the wrapper.  Returns cudaGetLastError().
extern "C" int transfer_window_launch(
    void* bal, void* non, void* sv, int cap, int scap, const void* acct_gids,
    int L, const void* slot_gids, int SL, const void* txds, int K, int pad,
    const void* t_idxs, int t_pad, const void* s_idxs, int s_pad, void* lb,
    void* ln, void* ls, void* acc, void* cnt, void* stamp, void* sacc,
    void* sstamp, void* fetches, void* stream) {
  transfer_window_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (int*)bal, (int*)non, (int*)sv, cap, scap, (const int*)acct_gids, L,
      (const int*)slot_gids, SL, (const int*)txds, K, pad,
      (const int*)t_idxs, t_pad, (const int*)s_idxs, s_pad, (int*)lb,
      (int*)ln, (int*)ls, (unsigned*)acc, (int*)cnt, (int*)stamp,
      (unsigned*)sacc, (int*)sstamp, (int*)fetches);
  return (int)cudaGetLastError();
}
