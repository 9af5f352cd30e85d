// One block's transfer step and token-slot step over n shards of state,
// as a row-parallel walk over every SM, for Hopper (sm_90a).
//
// Replaces the reference's per-block mesh programs
//   coreth_tpu/parallel/mesh.py:93  sharded_transfer_step
//   coreth_tpu/parallel/mesh.py:166 sharded_slot_step
// (shard_map bodies over a "dp" axis: each tx shard segment-sums its
// effects over the full table width, a psum_scatter reduces them onto
// the row sharding, nonces check against an all_gather of the nonce
// row, and a psum ANDs the shards' flags).  The plain PyTorch versions
// it is held against are parallel/mesh.sharded_transfer_step_plain and
// sharded_slot_step_plain, which run shard by shard as the reference
// does; both follow the reference bit for bit.
//
// Design.  The result does not depend on n: every sum is an integer add
// and ok is the AND of all the checks, whichever shard makes them.  So
// the launch does not take n.  A row's new value depends only on its
// own old value and the txs that touch it, so the table is cut into
// ranges of rows, one CTA a range (ranges of rpc rows, rpc chosen so the
// grid about fills the card's SMs), and each CTA:
//
// 1. load: copies its rows (and nonces) into a tile in shared memory,
//    16-byte vectors, neighbouring threads on neighbouring words, and
//    zeroes its rows' uint32 accumulators there (transfer: debit |
//    required | credit | send count, 49 words a row; slot: debit |
//    credit, 32);
// 2. sums: reads every tx's mask and two row columns (sender and
//    recipient, or the two slots), a thread a tx, and lists the txs
//    that touch its range in shared memory, in chunks; then sums the
//    listed txs, one thread a (tx, limb), into the accumulators with
//    shared-memory atomics (debit = value + fee per tx, its carry chain
//    up to the limb, as the reference).  The transfer checks here each
//    tx whose sender's row (wrapped and clamped as a jnp gather) is in
//    its range against the tile's nonce.  The CTA that holds the
//    coinbase sums every tx's fee in registers, a thread a tx, reduces
//    them over each warp by shuffles and adds one partial a warp to the
//    coinbase row (the reference adds the fees there before any
//    normalize);
// 3. rows: a thread a row normalizes its sums (mod 2^256), checks
//    solvency (transfer: a row that sends against its required total;
//    slot: every row against its debit) and applies sub(add(v, credit),
//    debit) and the nonce bump in the tile; an untouched row's sums are
//    zero, so it comes out unchanged;
// 4. store: writes the tile out as in 1, and folds its checks with one
//    CTA vote; a CTA that found a failure clears `ok`, which the launch
//    set to 1 before the kernel (a one-byte memset on the stream).
//
// The accumulators and the tile stay in shared memory, so the only
// device-memory traffic is each table row read and written once and the
// tx columns read from L2 by every CTA.  A limb sum takes at most 2 * B
// adds of < 2^16 (values and fees at the coinbase row), which the wrapper
// keeps inside int32 (B <= 16384), as the reference's int32 segment sums
// need.
//
// Bound: bytes.  The function reads each input once and writes each
// output once; its integer work is ~120 operations a tx and ~250 a row.
// This design adds the tx columns' reads by every CTA (from L2) and the
// launch of the memset.

#include <cstdint>
#include <cuda_runtime.h>

#include "transfer_block.cuh"

namespace {

using tw::ACCW;
using tw::LIMBS;
using tw::SACC;

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;       // txs listed at a time
constexpr int TILE_W = LIMBS + 1; // a tile row: 16 limbs | nonce (odd)
constexpr int RPC_MIN = 16, RPC_MAX = 512;
constexpr int COUNT = 3 * LIMBS;  // the send-count word of an ACCW row

struct StepArgs {
  const int* tab;        // balances or slot values [rows][16]
  const int* non;        // transfer: nonces [rows]
  const int *c0, *c1;    // sender, recipient | from slot, to slot [B]
  const int* value;      // value | amount [B][16]
  const int *fee, *req;  // transfer: fee, required [B][16]
  const int *tx_nonce, *offset, *mask;  // [B] (mask 0/1)
  int coinbase;          // transfer: in [0, rows) or no fee credit
  int rows, B, rpc;      // table rows, txs, rows a CTA
  int *new_tab, *new_non;
  unsigned char* ok;
};

// the sum over a warp (every lane of the warp calls it); the host build
// runs a CTA as one thread, its own warp
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#ifdef __CUDACC__
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
#endif
  return v;
}

template <bool SLOT>
__global__ void __launch_bounds__(THREADS) step_kernel(StepArgs a) {
  extern __shared__ __align__(16) unsigned ss_smem[];
  constexpr int W = SLOT ? SACC : ACCW;  // accumulator words a row
  __shared__ int cnt;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lo = blockIdx.x * a.rpc;
  const int nr = a.rows - lo < a.rpc ? a.rows - lo : a.rpc;
  unsigned* acc = ss_smem;                     // (rpc, W)
  unsigned* tile = acc + (size_t)a.rpc * W;    // (rpc, TILE_W)
  int* list = (int*)(tile + (size_t)a.rpc * TILE_W);  // (CHUNK)
  int bad = 0;
  // @split begin

  // 1. load: the rows, 16-byte vectors; the accumulators zeroed
  const uint4* src = (const uint4*)(a.tab + (size_t)lo * LIMBS);
  for (int e = tid; e < nr * (LIMBS / 4); e += nt) {
    const uint4 v = src[e];
    unsigned* t = tile + (e >> 2) * TILE_W + (e & 3) * 4;
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
  if (!SLOT)
    for (int r = tid; r < nr; r += nt)
      tile[r * TILE_W + LIMBS] = (unsigned)a.non[lo + r];
  for (int e = tid; e < nr * W; e += nt) acc[e] = 0u;
  __syncthreads();
  // @split load

  // 2. sums: the txs that touch this range, listed, then summed
  for (int base = 0; base < a.B; base += CHUNK) {
    if (tid == 0) cnt = 0;
    __syncthreads();
    const int end = base + CHUNK < a.B ? base + CHUNK : a.B;
    for (int i = base + tid; i < end; i += nt) {
      if (a.mask[i] == 0) continue;  // a masked tx adds nothing
      const int s = a.c0[i], r = a.c1[i];
      const int roles = (s >= lo && s < lo + nr ? 1 : 0) |
                        (r >= lo && r < lo + nr ? 2 : 0);
      if (!SLOT) {
        const int w = tw::wrap_idx(s, a.rows) - lo;
        if (w >= 0 && w < nr &&
            (unsigned)a.tx_nonce[i] !=
                tile[w * TILE_W + LIMBS] + (unsigned)a.offset[i])
          bad = 1;
      }
      if (roles) list[atomicAdd(&cnt, 1)] = i << 2 | roles;
    }
    __syncthreads();
    for (int e = tid; e < cnt * LIMBS; e += nt) {
      const int item = list[e / LIMBS], j = e % LIMBS, i = item >> 2;
      const int* v = a.value + (size_t)i * LIMBS;
      if (SLOT) {
        if (item & 1) atomicAdd(acc + (a.c0[i] - lo) * W + j, (unsigned)v[j]);
        if (item & 2)
          atomicAdd(acc + (a.c1[i] - lo) * W + LIMBS + j, (unsigned)v[j]);
        continue;
      }
      if (item & 1) {
        // debit = add(value, fee) per tx: the carry chain up to limb j
        const int* f = a.fee + (size_t)i * LIMBS;
        int carry = 0;
#pragma unroll
        for (int q = 0; q < LIMBS - 1; ++q)
          if (q < j) carry = (v[q] + f[q] + carry) >> 16;
        unsigned* s = acc + (a.c0[i] - lo) * W;
        atomicAdd(s + j, (unsigned)((v[j] + f[j] + carry) & 0xFFFF));
        atomicAdd(s + LIMBS + j, (unsigned)a.req[(size_t)i * LIMBS + j]);
        if (j == 0) atomicAdd(s + COUNT, 1u);
      }
      if (item & 2)
        atomicAdd(acc + (a.c1[i] - lo) * W + 2 * LIMBS + j, (unsigned)v[j]);
    }
    __syncthreads();
  }
  // the fees at the coinbase row: a partial a thread, one add a warp
  if (!SLOT && a.coinbase >= lo && a.coinbase < lo + nr) {
    unsigned f[LIMBS] = {};
    for (int i = tid; i < a.B; i += nt)
      if (a.mask[i] != 0) {
        const int* fi = a.fee + (size_t)i * LIMBS;
#pragma unroll
        for (int j = 0; j < LIMBS; ++j) f[j] += (unsigned)fi[j];
      }
    unsigned* c = acc + (a.coinbase - lo) * W + 2 * LIMBS;
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) {
      const unsigned sum = warp_sum(f[j]);
      if ((tid & 31) == 0 && sum != 0) atomicAdd(c + j, sum);
    }
    __syncthreads();
  }
  // @split sums

  // 3. rows: normalize, solvency, the new values in the tile
  for (int r = tid; r < nr; r += nt) {
    const unsigned* s = acc + r * W;
    unsigned* t = tile + r * TILE_W;
    auto get = [&](int c) { return s[c]; };
    int row[LIMBS], debit[LIMBS], credit[LIMBS];
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) row[j] = (int)t[j];
    tw::normalize(get, 0, debit);
    if (SLOT) {
      tw::normalize(get, LIMBS, credit);
      if (!tw::gte(row, debit)) bad = 1;
    } else {
      int required[LIMBS];
      tw::normalize(get, LIMBS, required);
      tw::normalize(get, 2 * LIMBS, credit);
      const unsigned count = s[COUNT];
      if (count != 0 && !tw::gte(row, required)) bad = 1;
      t[LIMBS] += count;
    }
    tw::apply(row, credit, debit);
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) t[j] = (unsigned)row[j];
  }
  __syncthreads();
  // @split rows

  // 4. store, and this CTA's checks into ok
  uint4* dst = (uint4*)(a.new_tab + (size_t)lo * LIMBS);
  for (int e = tid; e < nr * (LIMBS / 4); e += nt) {
    const unsigned* t = tile + (e >> 2) * TILE_W + (e & 3) * 4;
    dst[e] = make_uint4(t[0], t[1], t[2], t[3]);
  }
  if (!SLOT)
    for (int r = tid; r < nr; r += nt)
      a.new_non[lo + r] = (int)tile[r * TILE_W + LIMBS];
  if (__syncthreads_or(bad) && tid == 0) *a.ok = 0;
  // @split store
}

// rows a CTA: about one range an SM, within the tile's bounds (each
// device's SM count read once)
int rows_per_cta(int rows) {
  static int sms_of[64] = {};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64) {
    if (sms_of[dev] <= 0)
      cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                             dev);
    if (sms_of[dev] > 0) sms = sms_of[dev];
  }
  int rpc = (rows + sms - 1) / sms;
  rpc = (rpc + RPC_MIN - 1) / RPC_MIN * RPC_MIN;
  return rpc < RPC_MIN ? RPC_MIN : (rpc > RPC_MAX ? RPC_MAX : rpc);
}

// dynamic shared memory a CTA of rpc rows
int smem_of(int rpc, bool slot) {
  return (rpc * ((slot ? SACC : ACCW) + TILE_W) + CHUNK) * 4;
}

// ok = 1, then the kernel over ceil(rows / rpc) CTAs on `stream`.
// Returns 0 or a cudaError.
template <bool SLOT>
int launch(StepArgs a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(a.ok, 1, 1, st);
  if (err != cudaSuccess || a.rows <= 0) return (int)err;
  a.rpc = rows_per_cta(a.rows);
  const int smem = smem_of(a.rpc, SLOT);
  if (smem > 48 * 1024) {  // past the default, opt in
    err = cudaFuncSetAttribute(step_kernel<SLOT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.rows + a.rpc - 1) / a.rpc, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, step_kernel<SLOT>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// The launch a table of `rows` rows gets (the same for every mesh
// width): out int32[3] = rows a CTA, CTAs, dynamic shared memory a CTA.
extern "C" int sharded_step_design(int rows, int slot, void* out) {
  int* o = (int*)out;
  o[0] = rows_per_cta(rows);
  o[1] = rows > 0 ? (rows + o[0] - 1) / o[0] : 0;
  o[2] = smem_of(o[0], slot != 0);
  return 0;
}

// The transfer step: bal [A][16], non [A], the tx columns [B] / [B][16]
// (int32; mask 0/1), coinbase already in [0, A) or out of range (no fee
// credit); the outputs new_bal [A][16], new_non [A] int32 and ok, one
// byte (a torch.bool).  The tables' base addresses are 16-byte aligned.
// Returns 0 or a cudaError.
extern "C" int sharded_transfer_step_launch(
    const void* bal, const void* non, const void* sender, const void* recip,
    const void* value, const void* fee, const void* req,
    const void* tx_nonce, const void* offset, const void* mask, int coinbase,
    int A, int B, void* new_bal, void* new_non, void* ok, void* stream) {
  StepArgs a = {(const int*)bal,      (const int*)non,    (const int*)sender,
                (const int*)recip,    (const int*)value,  (const int*)fee,
                (const int*)req,      (const int*)tx_nonce,
                (const int*)offset,   (const int*)mask,   coinbase,
                A,                    B,                  0,
                (int*)new_bal,        (int*)new_non,      (unsigned char*)ok};
  return launch<false>(a, stream);
}

// The slot step: vals [S][16], from_slot / to_slot [B], amount [B][16],
// mask [B] (int32); new_vals [S][16] int32 and ok, one byte.  Returns 0
// or a cudaError.
extern "C" int sharded_slot_step_launch(const void* vals,
                                        const void* from_slot,
                                        const void* to_slot,
                                        const void* amount, const void* mask,
                                        int S, int B, void* new_vals,
                                        void* ok, void* stream) {
  StepArgs a = {(const int*)vals, nullptr, (const int*)from_slot,
                (const int*)to_slot, (const int*)amount, nullptr, nullptr,
                nullptr, nullptr, (const int*)mask, -1, S, B, 0,
                (int*)new_vals, nullptr, (unsigned char*)ok};
  return launch<true>(a, stream);
}
