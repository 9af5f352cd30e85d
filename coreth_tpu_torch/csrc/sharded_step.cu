// One block's transfer step and token-slot step over n shards of state,
// each in one launch of one thread-block cluster, for Hopper (sm_90a).
//
// Replaces the reference's per-block mesh programs
//   coreth_tpu/parallel/mesh.py:93  sharded_transfer_step
//   coreth_tpu/parallel/mesh.py:166 sharded_slot_step
// (shard_map bodies over a "dp" axis).  Shard d owns tx rows
// [d*B/n, (d+1)*B/n) and state rows [d*A/n, (d+1)*A/n): contiguous blocks,
// as PS("dp") lays them out.  The plain PyTorch versions it is held
// against are parallel/mesh.sharded_transfer_step_plain and
// sharded_slot_step_plain; both follow the reference bit for bit.
//
// Design.  The n shards are the n CTAs of one cluster (CTA d = shard d,
// n <= 8, the portable cluster size), 1024 threads each.  The wrapper
// allocates one global slab per shard, the width of the whole table:
//
//   transfer: slabs [n][A][ACCW]  debit | required | credit | send count
//   slot:     slabs [n][S][SACC]  debit | credit
//
// (at A = 16384 a slab is ~3.2 MB, past distributed shared memory), and
// one flag word per shard.  Each CTA:
//
// 1. zeroes its slab and sums the effects of its own B/n txs into it with
//    atomics (the reference's full-width segment sums of the local tx
//    shard; the fee of its own txs at the coinbase row, before any
//    normalize, as mesh.py:123-124) and checks their nonces against the
//    whole nonce table (the reference's all_gather);
// 2. waits at a cluster barrier;
// 3. sums the n slabs over its own A/n rows in shard order, in place in
//    its own slab (no other CTA reads those rows of it): the reference's
//    psum_scatter(tiled=True), shard d keeping rows [d*A/n, (d+1)*A/n);
// 4. normalizes, checks solvency on its rows (a row that sends nothing is
//    solvent by its zero count) and writes its rows of the new tables;
// 5. writes its flag; after a second cluster barrier CTA 0 ANDs the n
//    flags into `ok` (the reference's psum of the local flags == n).
//
// One CTA's slab writes reach the others through L2: atomics before the
// barrier, __ldcg reads after it (the barrier orders them).  Every sum is
// an integer add, so any order gives the plain version's result.  A limb
// sum takes at most 2*B adds of < 2^16 (values and fees at the coinbase
// row), which the wrapper keeps inside int32 (B <= 16384), as the
// reference's int32 segment sums need.
//
// Bound: bytes.  The function reads each input once and writes each
// output once; its integer work is ~100 operations a tx and ~150 a row.
// This design adds the slab traffic (n zeroed slabs, n reads of every
// row) and two cluster barriers.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "transfer_block.cuh"

namespace cg = cooperative_groups;

namespace {

using tw::ACCW;
using tw::LIMBS;
using tw::SACC;

constexpr int MAX_SHARDS = 8;     // the portable cluster size
constexpr int COUNT = 3 * LIMBS;  // the send-count word of an ACCW row

// Sum the n slabs' words of rows [lo, hi) in shard order, in place in
// slab d (rows x w words each).
__device__ void reduce_rows(unsigned* __restrict__ slabs, int n, int d,
                            int rows, int w, int lo, int hi) {
  const int64_t stride = (int64_t)rows * w;
  unsigned* mine = slabs + d * stride;
  for (int64_t e = (int64_t)lo * w + threadIdx.x; e < (int64_t)hi * w;
       e += blockDim.x) {
    unsigned v = 0;
    for (int t = 0; t < n; ++t) v += __ldcg(slabs + t * stride + e);
    __stcg(mine + e, v);
  }
}

// CTA 0 ANDs the n shards' flags into *ok (called after the barrier that
// follows every shard's flag write).
__device__ void combine_flags(const int* __restrict__ flags, int n, int d,
                              int* __restrict__ ok) {
  if (d != 0 || threadIdx.x != 0) return;
  int good = 0;
  for (int t = 0; t < n; ++t) good += __ldcg(flags + t);
  *ok = good == n ? 1 : 0;
}

__global__ void __launch_bounds__(1024) sharded_transfer_step_kernel(
    const int* __restrict__ bal, const int* __restrict__ non,
    const int* __restrict__ sender, const int* __restrict__ recip,
    const int* __restrict__ value, const int* __restrict__ fee,
    const int* __restrict__ req, const int* __restrict__ tx_nonce,
    const int* __restrict__ offset, const int* __restrict__ mask,
    int coinbase, int A, int B, unsigned* __restrict__ slabs,
    int* __restrict__ flags, int* __restrict__ new_bal,
    int* __restrict__ new_non, int* __restrict__ ok) {
  __shared__ int bad;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int d = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned* slab = slabs + (int64_t)d * A * ACCW;
  if (tid == 0) bad = 0;
  for (int64_t e = tid; e < (int64_t)A * ACCW; e += nt) slab[e] = 0u;
  __syncthreads();

  // 1. this shard's txs: full-width segment sums, nonces
  const int b = B / n;
  for (int i = d * b + tid; i < (d + 1) * b; i += nt) {
    if (mask[i] == 0) continue;
    const int s = sender[i], r = recip[i];
    if (tx_nonce[i] != non[tw::clamp_idx(s, A)] + offset[i]) bad = 1;
    const int* v = value + (int64_t)i * LIMBS;
    const int* f = fee + (int64_t)i * LIMBS;
    const int* q = req + (int64_t)i * LIMBS;
    // debit = add(value, fee), normalized per tx like the reference
    int debit[LIMBS];
    int carry = 0;
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) {
      const int x = v[j] + f[j] + carry;
      debit[j] = x & 0xFFFF;
      carry = x >> 16;
    }
    if (tw::in_range(s, A)) {
      unsigned* a = slab + (int64_t)s * ACCW;
      for (int j = 0; j < LIMBS; ++j) {
        atomicAdd(a + j, (unsigned)debit[j]);
        atomicAdd(a + LIMBS + j, (unsigned)q[j]);
      }
      atomicAdd(a + COUNT, 1u);
    }
    if (tw::in_range(r, A)) {
      unsigned* a = slab + (int64_t)r * ACCW + 2 * LIMBS;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)v[j]);
    }
    if (tw::in_range(coinbase, A)) {
      unsigned* a = slab + (int64_t)coinbase * ACCW + 2 * LIMBS;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)f[j]);
    }
  }
  cluster.sync();

  // 3. the reduce-scatter onto this shard's rows
  const int rows = A / n, lo = d * rows, hi = lo + rows;
  reduce_rows(slabs, n, d, A, ACCW, lo, hi);
  __syncthreads();

  // 4. normalize, solvency, the new rows
  for (int r = lo + tid; r < hi; r += nt) {
    const unsigned* sum = slab + (int64_t)r * ACCW;
    auto get = [&](int c) { return __ldcg(sum + c); };
    int debit[LIMBS], required[LIMBS], credit[LIMBS], row[LIMBS];
    tw::normalize(get, 0, debit);
    tw::normalize(get, LIMBS, required);
    tw::normalize(get, 2 * LIMBS, credit);
    const unsigned count = get(COUNT);
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) row[j] = bal[(int64_t)r * LIMBS + j];
    if (count != 0 && !tw::gte(row, required)) bad = 1;
    tw::apply(row, credit, debit);
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) new_bal[(int64_t)r * LIMBS + j] = row[j];
    new_non[r] = non[r] + (int)count;
  }
  __syncthreads();

  // 5. ok over the cluster
  if (tid == 0) __stcg(flags + d, bad ? 0 : 1);
  cluster.sync();
  combine_flags(flags, n, d, ok);
}

__global__ void __launch_bounds__(1024) sharded_slot_step_kernel(
    const int* __restrict__ vals, const int* __restrict__ from_slot,
    const int* __restrict__ to_slot, const int* __restrict__ amount,
    const int* __restrict__ mask, int S, int B,
    unsigned* __restrict__ slabs, int* __restrict__ flags,
    int* __restrict__ new_vals, int* __restrict__ ok) {
  __shared__ int bad;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int d = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned* slab = slabs + (int64_t)d * S * SACC;
  if (tid == 0) bad = 0;
  for (int64_t e = tid; e < (int64_t)S * SACC; e += nt) slab[e] = 0u;
  __syncthreads();

  // 1. this shard's txs: the amount debited at from_slot, credited at
  // to_slot (masked rows add nothing)
  const int b = B / n;
  for (int i = d * b + tid; i < (d + 1) * b; i += nt) {
    if (mask[i] == 0) continue;
    const int* amt = amount + (int64_t)i * LIMBS;
    const int fs = from_slot[i], ts = to_slot[i];
    if (tw::in_range(fs, S)) {
      unsigned* a = slab + (int64_t)fs * SACC;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)amt[j]);
    }
    if (tw::in_range(ts, S)) {
      unsigned* a = slab + (int64_t)ts * SACC + LIMBS;
      for (int j = 0; j < LIMBS; ++j) atomicAdd(a + j, (unsigned)amt[j]);
    }
  }
  cluster.sync();

  // 3. the reduce-scatter onto this shard's rows
  const int rows = S / n, lo = d * rows, hi = lo + rows;
  reduce_rows(slabs, n, d, S, SACC, lo, hi);
  __syncthreads();

  // 4. normalize, solvency of every row, the new rows
  for (int r = lo + tid; r < hi; r += nt) {
    const unsigned* sum = slab + (int64_t)r * SACC;
    auto get = [&](int c) { return __ldcg(sum + c); };
    int debit[LIMBS], credit[LIMBS], row[LIMBS];
    tw::normalize(get, 0, debit);
    tw::normalize(get, LIMBS, credit);
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) row[j] = vals[(int64_t)r * LIMBS + j];
    if (!tw::gte(row, debit)) bad = 1;
    tw::apply(row, credit, debit);
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) new_vals[(int64_t)r * LIMBS + j] = row[j];
  }
  __syncthreads();

  // 5. ok over the cluster
  if (tid == 0) __stcg(flags + d, bad ? 0 : 1);
  cluster.sync();
  combine_flags(flags, n, d, ok);
}

// n CTAs of 1024 threads as one cluster of n on `stream`; -2 for a width
// past MAX_SHARDS, -1 when no such cluster fits on the card, else the
// launch's cudaError.
template <class Kernel, class... Args>
int launch_cluster(int n, void* stream, Kernel kernel, Args... args) {
  if (n < 1 || n > MAX_SHARDS) return -2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(1024, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The transfer step: bal [A][16], non [A], the tx columns [B] / [B][16]
// (int32; mask 0/1), coinbase already in [0, A) or out of range (no fee
// credit).  The wrapper allocates slabs [n][A][ACCW], flags [n], and the
// outputs new_bal [A][16], new_non [A], ok [1].
extern "C" int sharded_transfer_step_launch(
    int n, const void* bal, const void* non, const void* sender,
    const void* recip, const void* value, const void* fee, const void* req,
    const void* tx_nonce, const void* offset, const void* mask, int coinbase,
    int A, int B, void* slabs, void* flags, void* new_bal, void* new_non,
    void* ok, void* stream) {
  return launch_cluster(
      n, stream, sharded_transfer_step_kernel, (const int*)bal,
      (const int*)non, (const int*)sender, (const int*)recip,
      (const int*)value, (const int*)fee, (const int*)req,
      (const int*)tx_nonce, (const int*)offset, (const int*)mask, coinbase,
      A, B, (unsigned*)slabs, (int*)flags, (int*)new_bal, (int*)new_non,
      (int*)ok);
}

// The slot step: vals [S][16], from_slot / to_slot [B], amount [B][16],
// mask [B]; slabs [n][S][SACC], flags [n], new_vals [S][16], ok [1].
extern "C" int sharded_slot_step_launch(
    int n, const void* vals, const void* from_slot, const void* to_slot,
    const void* amount, const void* mask, int S, int B, void* slabs,
    void* flags, void* new_vals, void* ok, void* stream) {
  return launch_cluster(
      n, stream, sharded_slot_step_kernel, (const int*)vals,
      (const int*)from_slot, (const int*)to_slot, (const int*)amount,
      (const int*)mask, S, B, (unsigned*)slabs, (int*)flags,
      (int*)new_vals, (int*)ok);
}
