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
// (the reference's "identical on every device") in device memory.
//
// 1. Gather: CTA d writes the window rows it owns (zeros for the rest;
//    pad rows, row == capacity, belong to no shard) into its slab of ga /
//    gs (device memory); cluster barrier; every CTA sums the n slabs (the
//    replicating add-reduce: one owner per row, so the sum is the value).
// 2. Per block k, on slab buffer k & 1:
//    a. map: every CTA gives each row the block touches the first of its
//       positions (lane i's sender 2i, recipient 2i + 1, the coinbase
//       2 pad; slots: lane i's from 2i, to 2i + 1) by an atomicMax of
//       k << 17 | (2^17 - 1 - position) into its own amap / smap, so the
//       maps agree across CTAs and need no reset between blocks;
//       CTA barrier;
//    b. accumulate: CTA d adds the effects of its own pad/n lanes (the
//       coinbase fee of its own lanes only) into its compact slab, one
//       row a touched row, one thread a (lane, limb), flags a nonce
//       mismatch in CTA 0's nfail through DSMEM, and marks each
//       position that is its row's first; cluster barrier;
//    c. reduce and apply: one warp a touched row (its first position):
//       the lanes sum the row's 49 (account) or 32 (slot) words over the
//       n slabs in the mode's order (psum: shard order; ppermute: the
//       ring from d, d, d-1, d-2, ...) through DSMEM, coalesced; three
//       lanes normalize debit / required / credit, one checks solvency
//       on the replicated row and applies (transfer_block.cuh's
//       chains).  The other buffer, which no CTA reads any more, is
//       zeroed for block k + 1.  CTA barrier;
//    d. fetch: every CTA writes its share of the block's fetch rows
//       (rows i = d mod n), CTA 0 the ok flag (no solvency failure, no
//       nonce flag).
//    One cluster barrier and two CTA barriers a block.  A slab is read
//    by its peers only between block k's and block k+1's cluster
//    barriers, so the next block's accumulate, into the other buffer,
//    never overwrites one a slower CTA still reads.
// 3. Scatter: each CTA writes the rows it owns back into its arena.
//
// Layout: the slabs take 2 x ((2 pad + 1) x 49 + 2 pad x 32) words, 165 KB
// at pad 128, in each CTA's shared memory ("dsmem") when that fits the
// card's opt-in limit, else in device memory ("global": xa [2][n][2 pad +
// 1][49], xs [2][n][2 pad][32], read through L2); the nonce flags always
// cross through DSMEM.  The sums are the K1 sums split over shards: the
// same uint32 headroom (2 * pad adds of < 2^16 per limb).
//
// Bound: bytes, as K1's: on one card the sharded function computes K1's
// result, and no exchange is necessary work.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "transfer_block.cuh"

#ifndef SW_LANES
#define SW_LANES 32  // threads a warp of the reduce (1 in the host build)
#endif

namespace cg = cooperative_groups;

namespace {

using tw::ACCW;
using tw::COLS;
using tw::FW;
using tw::LIMBS;
using tw::SACC;
using tw::in_range;

constexpr int MAX_SHARDS = 8;  // the portable cluster size
constexpr int THREADS = 1024;
constexpr int POS_BITS = 17;   // map entries: k << 17 | (2^17 - 1 - pos)
constexpr int POS_MASK = (1 << POS_BITS) - 1;
constexpr int MAX_K = 1 << (31 - POS_BITS);
constexpr int HEAD = 16;       // ints: nfail[2], bad[2], order[8], next
// words of the row scratch of the one-thread (host build) path
constexpr int SCR = SW_LANES == 1 ? 52 : 0;

__host__ __device__ inline int64_t slab_a_words(int pad) {
  return (int64_t)(2 * pad + 1) * ACCW;
}
__host__ __device__ inline int64_t slab_s_words(int pad) {
  return (int64_t)(2 * pad) * SACC;
}

// words of the block's first-position flags (one byte a position)
__host__ __device__ inline int64_t flag_words(int pad) {
  return ((int64_t)4 * pad + 1 + 15) / 16 * 4;
}

// dynamic shared memory a CTA: head, scratch, the first-position flags,
// and with the dsmem layout the two slab buffers
inline int64_t smem_bytes(int pad, bool dsmem) {
  int64_t b = 4 * (HEAD + SCR + flag_words(pad));
  if (dsmem) b += 4 * 2 * (slab_a_words(pad) + slab_s_words(pad));
  return b;
}

template <bool DSMEM>
__global__ void __launch_bounds__(THREADS) sharded_window_kernel(
    int* __restrict__ bal, int* __restrict__ non, int* __restrict__ sv,
    int arena, int sarena, const int* __restrict__ acct_rows, int L,
    const int* __restrict__ slot_rows, int SL, const int* __restrict__ txds,
    int K, int pad, const int* __restrict__ t_idxs, int t_pad,
    const int* __restrict__ s_idxs, int s_pad, int ring,
    int* __restrict__ lb_all, int* __restrict__ ln_all,
    int* __restrict__ ls_all, int* __restrict__ amap_all,
    int* __restrict__ smap_all, unsigned* __restrict__ ga,
    unsigned* __restrict__ gs, unsigned* __restrict__ xa,
    unsigned* __restrict__ xs, int* __restrict__ fetches) {
  extern __shared__ __align__(16) uint8_t sw_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int d = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % SW_LANES, warp = tid / SW_LANES;
  const int nwarps = nt / SW_LANES;
  int* nfail = (int*)sw_smem;  // [2] (CTA 0's): a lane failed its nonce check
  int* bad = nfail + 2;        // [2]: a touched row failed solvency
  int* order = nfail + 4;      // the slabs this shard adds, in order
  int* next = nfail + 12;      // the next chunk of positions to reduce
  unsigned* scratch = (unsigned*)sw_smem + HEAD;
  uint8_t* isfirst = (uint8_t*)((unsigned*)sw_smem + HEAD + SCR);
  unsigned* sm_slabs = (unsigned*)sw_smem + HEAD + SCR + flag_words(pad);
  const int64_t SA = slab_a_words(pad), SS = slab_s_words(pad);
  int* lb = lb_all + (int64_t)d * L * LIMBS;
  int* ln = ln_all + (int64_t)d * L;
  int* ls = ls_all + (int64_t)d * SL * LIMBS;
  int* amap = amap_all + (int64_t)d * L;
  int* smap = smap_all + (int64_t)d * SL;
  // @split begin

  auto own_a = [&](int buf) -> unsigned* {
    if constexpr (DSMEM)
      return sm_slabs + buf * SA;
    else
      return xa + ((int64_t)buf * n + d) * SA;
  };
  auto own_s = [&](int buf) -> unsigned* {
    if constexpr (DSMEM)
      return sm_slabs + 2 * SA + buf * SS;
    else
      return xs + ((int64_t)buf * n + d) * SS;
  };
  // word w of shard s's slab whose own copy is at base (global slabs lie
  // `stride` words apart), after the cluster barrier that ends its writes
  auto peer = [&](unsigned* base, int64_t stride, int s,
                  int64_t w) -> unsigned {
    if constexpr (DSMEM)
      return *cluster.map_shared_rank(base + w, s);
    else
      return __ldcg(base + (int64_t)(s - d) * stride + w);
  };

  for (int t = tid; t < n; t += nt) order[t] = ring ? (d - t + n) % n : t;
  if (tid == 0) nfail[0] = nfail[1] = bad[0] = bad[1] = 0;  // before the
                                                           // gather's barrier
  for (int l = tid; l < L; l += nt) amap[l] = -1;
  for (int l = tid; l < SL; l += nt) smap[l] = -1;
  for (int64_t e = tid; e < SA; e += nt) own_a(0)[e] = 0u;
  for (int64_t e = tid; e < SS; e += nt) own_s(0)[e] = 0u;

  // 1. gather the owned rows, then replicate
  const int lo = d * arena, slo = d * sarena;
  unsigned* my_ga = ga + (int64_t)d * L * FW;
  for (int e = tid; e < L * FW; e += nt) {
    const int l = e / FW, j = e % FW, g = acct_rows[l];
    const bool own = g >= lo && g < lo + arena;
    int v = 0;
    if (own) v = j < LIMBS ? bal[(int64_t)g * LIMBS + j] : non[g];
    __stcg(my_ga + e, (unsigned)v);
  }
  unsigned* my_gs = gs + (int64_t)d * SL * LIMBS;
  for (int e = tid; e < SL * LIMBS; e += nt) {
    const int g = slot_rows[e / LIMBS];
    const bool own = g >= slo && g < slo + sarena;
    __stcg(my_gs + e, own ? (unsigned)sv[(int64_t)g * LIMBS + e % LIMBS] : 0u);
  }
  cluster.sync();
  for (int e = tid; e < L * FW; e += nt) {
    unsigned v = 0;
    for (int t = 0; t < n; ++t) v += __ldcg(ga + (int64_t)order[t] * L * FW + e);
    const int l = e / FW, j = e % FW;
    if (j < LIMBS)
      lb[(int64_t)l * LIMBS + j] = (int)v;
    else
      ln[l] = (int)v;
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    unsigned v = 0;
    for (int t = 0; t < n; ++t)
      v += __ldcg(gs + (int64_t)order[t] * SL * LIMBS + e);
    ls[e] = (int)v;
  }
  // @split gather

  // 2. the blocks
  const int lanes = pad / n;
  const int frows = t_pad + s_pad + 1;
  const int PA = 2 * pad + 1, PS = 2 * pad;
  for (int k = 0; k < K; ++k) {
    const int buf = k & 1;
    const int* txd = txds + (int64_t)k * pad * COLS;
    const int cb = txd[5];
    const int enc = k << POS_BITS;
    auto acct_at = [&](int p) {
      return p == 2 * pad ? cb : txd[(int64_t)(p >> 1) * COLS + (p & 1)];
    };
    auto slot_at = [&](int p) {
      return txd[(int64_t)(p >> 1) * COLS + 54 + (p & 1)];
    };
    // a. the block's row map
    for (int p = tid; p < PA; p += nt) {
      const int r = acct_at(p);
      if (in_range(r, L)) atomicMax(amap + r, enc | (POS_MASK - p));
    }
    for (int p = tid; p < PS; p += nt) {
      const int r = slot_at(p);
      if (in_range(r, SL)) atomicMax(smap + r, enc | (POS_MASK - p));
    }
    // CTA 0's flag of block k + 1 (its last reader, block k - 1's ok,
    // is behind; the writers of block k + 1 are past block k's cluster
    // barrier, ahead)
    if (tid == 0) {
      bad[buf] = *next = 0;
      if (d == 0) nfail[buf ^ 1] = 0;
    }
    __syncthreads();
    // @split map

    // b. this shard's lanes into its slab
    unsigned* sa = own_a(buf);
    unsigned* ss = own_s(buf);
    auto arow = [&](int r) {
      return sa + (int64_t)(POS_MASK - (__ldcg(amap + r) & POS_MASK)) * ACCW;
    };
    auto srow = [&](int r) {
      return ss + (int64_t)(POS_MASK - (__ldcg(smap + r) & POS_MASK)) * SACC;
    };
    // a nonce mismatch is flagged in CTA 0's shared memory (DSMEM)
    tw::accumulate_limbs(txd, d * lanes, (d + 1) * lanes, L, SL, ln, arow,
                         srow, cluster.map_shared_rank(&nfail[buf], 0));
    // each touched row is reduced once, at its first position
    for (int p = tid; p < PA + PS; p += nt) {
      const bool acct = p < PA;
      const int q = acct ? p : p - PA;
      const int r = acct ? acct_at(q) : slot_at(q);
      isfirst[p] = in_range(r, acct ? L : SL) &&
                   __ldcg((acct ? amap : smap) + r) == (enc | (POS_MASK - q));
    }
    // @split accumulate
    cluster.sync();
    // @split exchange

    // c. the exchange's reduce and the apply, one warp a touched row
    auto row_at = [&](int p) {
      return p < PA ? acct_at(p) : slot_at(p - PA);
    };
#if SW_LANES == 1
    // one thread: each first position in turn, the row's sums and chains
    // serial
    for (int p = 0; p < PA + PS; ++p) {
      if (!isfirst[p]) continue;
      const int r = row_at(p);
      const bool acct = p < PA;
      const int q = acct ? p : p - PA;
      const int words = acct ? ACCW : SACC;
      for (int c = 0; c < words; ++c) {
        unsigned v = 0;
        for (int t = 0; t < n; ++t)
          v += peer(acct ? sa : ss, acct ? SA : SS, order[t],
                    (int64_t)q * words + c);
        scratch[c] = v;
      }
      int* si = (int*)scratch;
      for (int c = 0; c < words / LIMBS; ++c)
        tw::normalize([&](int w) { return scratch[w]; }, c * LIMBS,
                      si + c * LIMBS);
      if (acct) {
        int* b = lb + (int64_t)r * LIMBS;
        const int cnt = (int)scratch[3 * LIMBS];
        if (cnt != 0 && !tw::gte(b, si + LIMBS)) bad[buf] = 1;
        tw::apply(b, si + 2 * LIMBS, si);
        ln[r] += cnt;
      } else {
        int* v = ls + (int64_t)r * LIMBS;
        if (!tw::gte(v, si)) bad[buf] = 1;
        tw::apply(v, si + LIMBS, si);
      }
    }
#else
    // warps take chunks of 16 positions and their first positions one by
    // one: the lanes read a row's words over the slabs (coalesced), the
    // limb chains run across 16-lane halves (tw::hw_*)
    for (;;) {
      int c0 = lane == 0 ? atomicAdd(next, 16) : 0;
      c0 = __shfl_sync(tw::FULL, c0, 0);
      if (c0 >= PA + PS) break;
      const int p = c0 + (lane & 15);
      for (unsigned m = __ballot_sync(tw::FULL, lane < 16 && p < PA + PS &&
                                                    isfirst[p]);
           m; m &= m - 1) {
        const int pos = c0 + __ffs(m) - 1;
        const bool acct = pos < PA;
        const int q = acct ? pos : pos - PA;
        const int words = acct ? ACCW : SACC;
        const int row = row_at(pos);
        unsigned v1 = 0, v2 = 0;
        for (int t = 0; t < n; ++t) {
          v1 += peer(acct ? sa : ss, acct ? SA : SS, order[t],
                     (int64_t)q * words + lane);
          if (lane + 32 < words)
            v2 += peer(sa, SA, order[t], (int64_t)q * words + 32 + lane);
        }
        int* cur = (acct ? lb : ls) + (int64_t)row * LIMBS;
        const unsigned b = (unsigned)cur[lane & 15];
        const unsigned cnt = __shfl_sync(tw::FULL, v2, 16);
        // accounts: debit | required in v1, credit | count in v2; slots:
        // debit | credit in v1
        v1 = tw::hw_normalize(v1, lane);
        v2 = tw::hw_normalize(v2, lane);
        const unsigned gt = __ballot_sync(tw::FULL, b > v1);
        const unsigned lt = __ballot_sync(tw::FULL, b < v1);
        const unsigned down = __shfl_down_sync(tw::FULL, v1, 16);
        unsigned nv = tw::hw_add(b, acct ? v2 : down, lane);
        nv = tw::hw_sub(nv, v1, lane);
        // solvency: accounts against the required sum (upper half) when
        // the row sends, slots against the debit (lower half)
        const bool short_ = acct ? cnt != 0 && (gt >> 16) < (lt >> 16)
                                 : (gt & 0xFFFFu) < (lt & 0xFFFFu);
        if (lane == 0 && short_) bad[buf] = 1;
        if (lane == 0 && acct) ln[row] += (int)cnt;
        if (lane < 16) cur[lane] = (int)nv;
      }
    }
#endif
    // @split reduce
    // the other buffer: no CTA reads it after this block's cluster barrier
    unsigned* za = own_a(buf ^ 1);
    unsigned* zs = own_s(buf ^ 1);
    for (int64_t e = tid; e < SA; e += nt) za[e] = 0u;
    for (int64_t e = tid; e < SS; e += nt) zs[e] = 0u;
    __syncthreads();
    // @split zero

    // d. this shard's share of the fetch rows; CTA 0 the ok flag
    int* f = fetches + (int64_t)k * frows * FW;
    const int* ti = t_idxs + (int64_t)k * t_pad;
    const int* sx = s_idxs + (int64_t)k * s_pad;
    const int tn = (t_pad + n - 1) / n, sn = (s_pad + n - 1) / n;
    for (int e = tid; e < (tn + sn) * FW; e += nt) {
      const int j = e % FW, i = (e / FW < tn ? e / FW : e / FW - tn) * n + d;
      if (e / FW < tn) {
        if (i >= t_pad) continue;
        const int l = tw::wrap_idx(ti[i], L);
        f[i * FW + j] = j < LIMBS ? lb[(int64_t)l * LIMBS + j] : ln[l];
      } else {
        if (i >= s_pad) continue;
        const int l = tw::wrap_idx(sx[i], SL);
        f[(t_pad + i) * FW + j] = j < LIMBS ? ls[(int64_t)l * LIMBS + j] : 0;
      }
    }
    // @split rows
    if (d == 0 && tid == 0) {
      f[(t_pad + s_pad) * FW] = bad[buf] || nfail[buf] ? 0 : 1;
      for (int j = 1; j < FW; ++j) f[(t_pad + s_pad) * FW + j] = 0;
    }
    // @split fetch
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
  // @split scatter
  // a peer may still read this CTA's slab (the last block's reduce)
  cluster.sync();
}

template <bool DSMEM>
int launch(int n, void* bal, void* non, void* sv, int arena, int sarena,
           const void* acct_rows, int L, const void* slot_rows, int SL,
           const void* txds, int K, int pad, const void* t_idxs, int t_pad,
           const void* s_idxs, int s_pad, int ring, void* lb, void* ln,
           void* ls, void* amap, void* smap, void* ga, void* gs, void* xa,
           void* xs, void* fetches, void* stream) {
  const int64_t bytes = smem_bytes(pad, DSMEM);
  cudaError_t err = cudaFuncSetAttribute(
      sharded_window_kernel<DSMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)sharded_window_kernel<DSMEM>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, sharded_window_kernel<DSMEM>, (int*)bal, (int*)non, (int*)sv,
      arena, sarena, (const int*)acct_rows, L, (const int*)slot_rows, SL,
      (const int*)txds, K, pad, (const int*)t_idxs, t_pad,
      (const int*)s_idxs, s_pad, ring, (int*)lb, (int*)ln, (int*)ls,
      (int*)amap, (int*)smap, (unsigned*)ga, (unsigned*)gs, (unsigned*)xa,
      (unsigned*)xs, (int*)fetches);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The slab layout a window of `pad` lanes takes: 1 (dsmem) when the
// slabs fit the card's opt-in shared memory a block, else 0 (global);
// *bytes is the dynamic shared memory a CTA of that layout.
extern "C" int sharded_window_layout(int pad, int* bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int dsmem = smem_bytes(pad, true) <= optin ? 1 : 0;
  *bytes = (int)smem_bytes(pad, dsmem != 0);
  return dsmem;
}

// Launch n CTAs of 1024 threads as one cluster of n on `stream`
// (PyTorch's current stream), in slab layout `layout` (1 dsmem, 0 global:
// then xa [2][n][2 pad + 1][49] and xs [2][n][2 pad][32]).  bal/non/sv are
// the shard-major tables (n * arena and n * sarena rows), updated in
// place; the wrapper hands in clones of the engine's tables.  The working
// sets (lb/ln/ls [n][...]), row maps (amap [n][L], smap [n][SL]) and
// gather slabs (ga [n][L][17], gs [n][SL][16]) are allocated by the
// wrapper.  Returns -2 for a width past MAX_SHARDS, -3 for K >= 16384
// blocks or pad > 16384 (the row map's fields), -1 when no cluster of n
// such CTAs fits on the card, else the launch's cudaError.
extern "C" int sharded_window_launch(
    int n, int layout, void* bal, void* non, void* sv, int arena,
    int sarena, const void* acct_rows, int L, const void* slot_rows, int SL,
    const void* txds, int K, int pad, const void* t_idxs, int t_pad,
    const void* s_idxs, int s_pad, int ring, void* lb, void* ln, void* ls,
    void* amap, void* smap, void* ga, void* gs, void* xa, void* xs,
    void* fetches, void* stream) {
  if (n < 1 || n > MAX_SHARDS) return -2;
  if (K >= MAX_K || pad > 16384) return -3;
  auto go = layout ? launch<true> : launch<false>;
  return go(n, bal, non, sv, arena, sarena, acct_rows, L, slot_rows, SL, txds,
            K, pad, t_idxs, t_pad, s_idxs, s_pad, ring, lb, ln, ls, amap,
            smap, ga, gs, xa, xs, fetches, stream);
}
