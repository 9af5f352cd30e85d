// One window of value-transfer blocks over n shards of state, in one
// launch of one thread-block cluster, for Hopper (sm_90a).
//
// Replaces the reference's jitted device program
//   coreth_tpu/replay/shard.py:85 _build_window
//   (with parallel/mesh.py:59 collective_reduce),
// the sharded twin of the transfer window (K1, transfer_window.cu): the
// balance, nonce and slot tables are shard-major (shard d owns rows
// [d*arena, (d+1)*arena), parallel/shard.py), the window's txs are
// interleaved round-robin over the shards (replay/shard.interleave_txs),
// and each block's cross-shard effects travel as one reduce of a packed
// effect tensor.  The plain PyTorch version it is held against is
// replay/shard._sharded_window_plain; both follow the reference bit for
// bit.
//
// Design.  The n shards are the n CTAs of one cluster (CTA d = shard d,
// n <= 8, the portable cluster size), 1024 threads each.  Every CTA keeps
// its own replicated working set of the window's L accounts and SL slots
// (the reference's "identical on every device") in device memory, and
// its own slab of a global exchange buffer the wrapper allocates:
//
//   xa [2][n][L][ACCW]  debit | required | credit | send count (uint32)
//   xs [2][n][SL][SACC] slot debit | slot credit
//   xn [2][n]           1 if the shard's lanes passed the nonce check
//
// and its reduced rows ra [n][L][ACCW], rs [n][SL][SACC] (its own).
//
// 1. Gather: CTA d writes the window rows it owns (zeros for the rest;
//    pad rows, row == capacity, belong to no shard) into its slab;
//    cluster barrier; every CTA sums the n slabs (the replicating
//    add-reduce: one owner per row, so the sum is the value).
// 2. Per block k, on slab buffer k & 1: CTA d zeroes the rows the block
//    touches in its slab, sums the effects of its own P/n lanes into it
//    (the coinbase fee of its own lanes only) and checks their nonces;
//    cluster barrier; then every CTA sums the n slabs of each touched
//    row in the mode's order (psum: shard order; ppermute: the ring
//    from d, d, d-1, d-2, ...) into its reduced rows, one thread per
//    word so that the L2 reads overlap, and from them normalizes,
//    validates solvency on its replicated rows and applies the block
//    (transfer_block.cuh, as K1).  CTA 0 writes the fetch rows.  Buffers alternate, so block k+1 never overwrites a slab that
//    a slower CTA still reads for block k: the one barrier of block k+1
//    orders every read of block k-1's buffer before its reuse.
// 3. Scatter: each CTA writes the rows it owns back into its arena.
//
// The slabs (~0.8 MB per shard at L = 4096) do not fit shared memory, so
// they live in global memory; the cluster barrier's release/acquire
// order makes one CTA's slab writes visible to the others, which read
// them through L2 (__ldcg).  The sums are the K1 sums split over
// shards: the same uint32 headroom (2 * pad adds of < 2^16 per limb).
//
// Bound: bytes, as K1's: on one card the sharded function computes K1's
// result, and no exchange is necessary work.  This design adds to K1's
// chain of dependent phases one cluster barrier, one CTA barrier and the
// slab traffic per block (n L2 reads of each touched row's words per
// CTA).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "transfer_block.cuh"

namespace cg = cooperative_groups;

namespace {

using tw::ACCW;
using tw::COLS;
using tw::FW;
using tw::LIMBS;
using tw::SACC;

constexpr int MAX_SHARDS = 8;  // the portable cluster size

__global__ void __launch_bounds__(1024) sharded_window_kernel(
    int* __restrict__ bal, int* __restrict__ non, int* __restrict__ sv,
    int arena, int sarena, const int* __restrict__ acct_rows, int L,
    const int* __restrict__ slot_rows, int SL, const int* __restrict__ txds,
    int K, int pad, const int* __restrict__ t_idxs, int t_pad,
    const int* __restrict__ s_idxs, int s_pad, int ring,
    int* __restrict__ lb_all, int* __restrict__ ln_all,
    int* __restrict__ ls_all, int* __restrict__ stamp_all,
    int* __restrict__ sstamp_all, unsigned* __restrict__ xa,
    unsigned* __restrict__ xs, int* __restrict__ xn,
    unsigned* __restrict__ ra_all, unsigned* __restrict__ rs_all,
    int* __restrict__ fetches) {
  __shared__ int bad, bad_nonce;
  __shared__ int order[MAX_SHARDS];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int d = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  int* lb = lb_all + (int64_t)d * L * LIMBS;
  int* ln = ln_all + (int64_t)d * L;
  int* ls = ls_all + (int64_t)d * SL * LIMBS;
  int* stamp = stamp_all + (int64_t)d * L;
  int* sstamp = sstamp_all + (int64_t)d * SL;
  unsigned* ra = ra_all + (int64_t)d * L * ACCW;
  unsigned* rs = rs_all + (int64_t)d * SL * SACC;
  auto slab_a = [&](int buf, int s) {
    return xa + ((int64_t)buf * n + s) * L * ACCW;
  };
  auto slab_s = [&](int buf, int s) {
    return xs + ((int64_t)buf * n + s) * SL * SACC;
  };
  // the slabs this shard adds, in order: shard order, or the ring from d
  for (int t = tid; t < n; t += nt) order[t] = ring ? (d - t + n) % n : t;
  __syncthreads();
  auto src = [&](int t) { return order[t]; };

  // 1. gather the owned rows into buffer 1, then replicate
  const int lo = d * arena, slo = d * sarena;
  unsigned* ga = slab_a(1, d);
  for (int e = tid; e < L * FW; e += nt) {
    const int l = e / FW, j = e % FW, g = acct_rows[l];
    const bool own = g >= lo && g < lo + arena;
    int v = 0;
    if (own) v = j < LIMBS ? bal[(int64_t)g * LIMBS + j] : non[g];
    __stcg(ga + (int64_t)l * ACCW + j, (unsigned)v);
  }
  unsigned* gs = slab_s(1, d);
  for (int e = tid; e < SL * LIMBS; e += nt) {
    const int l = e / LIMBS, j = e % LIMBS, g = slot_rows[l];
    const bool own = g >= slo && g < slo + sarena;
    __stcg(gs + (int64_t)l * SACC + j,
           own ? (unsigned)sv[(int64_t)g * LIMBS + j] : 0u);
  }
  for (int l = tid; l < L; l += nt) stamp[l] = -1;
  for (int l = tid; l < SL; l += nt) sstamp[l] = -1;
  cluster.sync();
  for (int e = tid; e < L * FW; e += nt) {
    const int l = e / FW, j = e % FW;
    unsigned v = 0;
    for (int t = 0; t < n; ++t)
      v += __ldcg(slab_a(1, src(t)) + (int64_t)l * ACCW + j);
    if (j < LIMBS)
      lb[(int64_t)l * LIMBS + j] = (int)v;
    else
      ln[l] = (int)v;
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    const int l = e / LIMBS, j = e % LIMBS;
    unsigned v = 0;
    for (int t = 0; t < n; ++t)
      v += __ldcg(slab_s(1, src(t)) + (int64_t)l * SACC + j);
    ls[e] = (int)v;
  }
  __syncthreads();

  // 2. the blocks
  const int lanes = pad / n;
  const int frows = t_pad + s_pad + 1;
  for (int k = 0; k < K; ++k) {
    const int buf = k & 1;
    const int* txd = txds + (int64_t)k * pad * COLS;
    unsigned* my_a = slab_a(buf, d);
    unsigned* my_s = slab_s(buf, d);
    if (tid == 0) bad = bad_nonce = 0;
    tw::zero_touched(txd, pad, L, SL, my_a, my_s);
    __syncthreads();
    tw::accumulate(txd, d * lanes, (d + 1) * lanes, L, SL, ln, my_a, my_s,
                   &bad_nonce);
    __syncthreads();
    if (tid == 0) __stcg(xn + buf * n + d, bad_nonce ? 0 : 1);
    cluster.sync();
    // the exchange's reduce: every word of every touched row is one
    // thread's sum over the n slabs, so the L2 reads of a block overlap
    // (a row several lanes touch is summed by each of them, to the same
    // value)
    for (int e = tid; e < (pad + 1) * 2 * ACCW; e += nt) {
      const int i = e / (2 * ACCW), c = e % ACCW;
      const int r = i == pad ? ((e / ACCW) & 1 ? -1 : txd[5])
                             : txd[(int64_t)i * COLS + (e / ACCW) % 2];
      if (!tw::in_range(r, L)) continue;
      unsigned v = 0;
      for (int t = 0; t < n; ++t)
        v += __ldcg(slab_a(buf, src(t)) + (int64_t)r * ACCW + c);
      ra[(int64_t)r * ACCW + c] = v;
    }
    for (int e = tid; e < pad * 2 * SACC; e += nt) {
      const int i = e / (2 * SACC), c = e % SACC;
      const int r = txd[(int64_t)i * COLS + 54 + (e / SACC) % 2];
      if (!tw::in_range(r, SL)) continue;
      unsigned v = 0;
      for (int t = 0; t < n; ++t)
        v += __ldcg(slab_s(buf, src(t)) + (int64_t)r * SACC + c);
      rs[(int64_t)r * SACC + c] = v;
    }
    __syncthreads();
    auto sum_a = [&](int r, int c) { return ra[(int64_t)r * ACCW + c]; };
    auto sum_s = [&](int r, int c) { return rs[(int64_t)r * SACC + c]; };
    tw::apply_touched(txd, pad, k, L, SL, lb, ln, ls, stamp, sstamp, sum_a,
                      sum_s, &bad);
    __syncthreads();
    if (d == 0) {
      int nonce_n = 0;
      for (int t = 0; t < n; ++t) nonce_n += __ldcg(xn + buf * n + src(t));
      tw::write_fetch(fetches + (int64_t)k * frows * FW,
                      t_idxs + (int64_t)k * t_pad, t_pad,
                      s_idxs + (int64_t)k * s_pad, s_pad, lb, ln, ls, L, SL,
                      bad == 0 && nonce_n == n);
    }
    __syncthreads();
  }

  // 3. scatter the owned rows back into this shard's arena
  for (int e = tid; e < L * LIMBS; e += nt) {
    const int g = acct_rows[e / LIMBS];
    if (g >= lo && g < lo + arena)
      bal[(int64_t)g * LIMBS + e % LIMBS] = lb[e];
  }
  for (int l = tid; l < L; l += nt) {
    const int g = acct_rows[l];
    if (g >= lo && g < lo + arena) non[g] = ln[l];
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    const int g = slot_rows[e / LIMBS];
    if (g >= slo && g < slo + sarena)
      sv[(int64_t)g * LIMBS + e % LIMBS] = ls[e];
  }
}

}  // namespace

// Launch n CTAs of 1024 threads as one cluster of n on `stream`
// (PyTorch's current stream).  bal/non/sv are the shard-major tables
// (n * arena and n * sarena rows), updated in place; the wrapper hands in
// clones of the engine's tables.  The working sets (lb/ln/ls [n][...]),
// stamps, exchange slabs and reduced rows (ra [n][L][ACCW], rs
// [n][SL][SACC]) are allocated by the wrapper.  Returns -2 for a width
// past MAX_SHARDS, -1 when no cluster of n such CTAs fits on the card,
// else the launch's cudaError.
extern "C" int sharded_window_launch(
    int n, void* bal, void* non, void* sv, int arena, int sarena,
    const void* acct_rows, int L, const void* slot_rows, int SL,
    const void* txds, int K, int pad, const void* t_idxs, int t_pad,
    const void* s_idxs, int s_pad, int ring, void* lb, void* ln, void* ls,
    void* stamp, void* sstamp, void* xa, void* xs, void* xn, void* ra,
    void* rs, void* fetches, void* stream) {
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
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)sharded_window_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, sharded_window_kernel, (int*)bal, (int*)non, (int*)sv, arena,
      sarena, (const int*)acct_rows, L, (const int*)slot_rows, SL,
      (const int*)txds, K, pad, (const int*)t_idxs, t_pad,
      (const int*)s_idxs, s_pad, ring, (int*)lb, (int*)ln, (int*)ls,
      (int*)stamp, (int*)sstamp, (unsigned*)xa, (unsigned*)xs, (int*)xn,
      (unsigned*)ra, (unsigned*)rs, (int*)fetches);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
