// The fused, device-resident OCC window (K6) for Hopper (sm_90a).
//
// Replaces the reference's jitted device program
//   coreth_tpu/evm/device/machine.py:948 build_occ_machine
//   (:1024 occ_run, with the generic interpreter as its exec step),
// which scanned the W machine blocks of a window and, per block, ran
// the Block-STM round loop (exec the pending lanes, validate every
// lane's reads in tx order against the block-start table plus the
// writes of the valid lanes before it, re-run the stale ones) inside
// one XLA program, against a global slot-value table that stays on the
// device.
//
// Design: one launch per window attempt.  The W blocks stay sequential
// (block w's base table is block w-1's result), but each block's B lanes
// are spread over a group of c CTAs, one thread-block cluster (c <= 16,
// non-portable above 8; the launch takes the largest c <= B / 16 whose
// cluster the card can hold, so the group is co-resident whatever else
// runs, and K2's streams keep the rest of the card).  CTA m of the group
// owns lanes [m*B/c, (m+1)*B/c).  Per block:
//   init   — each CTA writes its lanes' rows (SKIP, then zeros), seeds
//            (the table's values of the premapped entries), key counts
//            and pending flags, neighbouring threads on neighbouring
//            words; the group's first CTA (the leader) builds the
//            block-local key index: the block's premapped entries sorted
//            by table row in shared memory (bitonic), each distinct row
//            one key k, each entry's k in `kof`;
//   exec   — each CTA seeds the rows of its pending lanes (all threads,
//            coalesced), then each slot thread runs one lane to
//            completion: the lane's stack, memory and transient cache
//            live in the slot's dynamic shared memory (memory zeroed
//            only as far as msize grows).  prog_id < 0 runs K5's lane
//            interpreter (step_machine.cuh sm_run_lane, with K4 u256x.cuh
//            and K3 keccak.cuh inside); prog_id = k runs traced program k
//            (K7) through spec_dispatch.  The generic build (this file
//            alone) has no program; the specialised build is a generated
//            translation unit that defines OCC_SPEC, the programs and
//            spec_dispatch (coreth_tpu_torch/evm/device/specialize.py
//            cuda_source) and then includes this file;
//   sweep  — the leader validates the round, bit-identical to the
//            reference's sequential sweep: a parallel pre-pass (a thread
//            a lane) marks the potential writers (status STOP, neither
//            skipped nor host-bound, an F_WRITTEN premapped entry) and
//            each key's first one (a shared-memory atomicMin, whose
//            result no order changes); a lane none of whose premapped
//            keys (all S, read or not: a re-pending lane is seeded with
//            all of them) has an earlier potential writer is independent
//            and is validated in parallel against the block-start table.
//            A dependent lane is checked in the same parallel pass on
//            the speculation that each entry's last earlier potential
//            writer (`spw`, found in the key's run of the sorted index)
//            is valid; then one warp walks the dependent lanes only, in
//            tx order (ballots over the lane flags skip the others),
//            and keeps a lane's speculative result when its writers
//            all turned out valid (shared-memory reads), else checks it
//            again against each entry's last valid writer (its row, or
//            the table) and re-seeds it.  Each key's last valid writer
//            (`klw`, an atomicMax) is what the block writes back;
//   write-back — after the block's last round the leader copies each
//            key's last valid write into the table and writes the rows'
//            trailing columns.
// Barriers a window: two cluster barriers a round (after exec: the rows
// are whole; after the sweep: flags, seeds and the go flag are), one a
// block (the table is whole before the next block seeds from it), two
// more a block and two at the start with a K9 sync set, and CTA barriers
// inside each phase (by this formula, occ_split.barriers, 40 cluster
// barriers for the main path's window of 8 blocks and 16 rounds).  A
// cluster barrier is a hardware arrive/wait pair with release/acquire
// at cluster scope; what it costs is the wait for the group's slowest
// CTA (the longest lane of an exec, the leader's sweep), not the
// barrier itself.  The data it orders crosses through L2
// (__stcg/__ldcg), so no CTA reads a stale L1 line of another's writes.
//
// Asynchronous staging: while block w runs, one warp of each CTA stages
// block w+1's inputs of its lanes by bulk copies (cp.async.bulk with an
// mbarrier, double-buffered by block parity): the calldata up to
// data_len and the key words of the premapped entries.  Staging takes
// what shared memory the lane slots and the sweep leave, so a CTA stages
// its first `nstage` lanes (most of them at the main path's shapes;
// chip_smoke.py phase k6 prints how many); the others, and every lane's
// scalar inputs, bytecode and jump table, are read from device memory.
// The bytecode is an int32 a byte in rows of code_cap + 33 words, which
// are not 16-byte aligned as a bulk copy needs, and at the main path's
// shapes a CTA's 16 rows would take the room of ~12 staged lanes.
//
// The `// @split` lines mark the phase boundaries at which occ_split.py
// (repo root) inserts clock counters into a copy of this file; the
// kernel itself carries none.
//
// Bound: a lane is a latency-bound chain (fetch, dispatch, stack in
// shared memory) on one thread; the group runs c CTAs' lanes at once, and
// a block's rounds are what its conflicts make them.  The bytes (inputs
// read once, table and packed rows written once) and the integer
// operations (lane-steps x machine.OPS_PER_STEP plus the sweeps' entry
// compares) are far below what the launch takes.  The wrapper
// (coreth_tpu_torch/evm/device/machine.py run_occ_window) allocates the
// outputs and every scratch buffer; the kernel allocates nothing.
//
// Outputs: table (G, 16) int32 updated in place (the wrapper passes a
// copy of the input table), packed (W, B, width + 4) int32 rows in the
// reference layout with the committed / escape / pending / rounds
// columns, and steps (W, B) int32, the lane-steps each lane executed
// over all rounds (a traced lane counts its leaf's traced steps), for
// the roofline.
//
// The sharded window (K9) with its flags reduce (K9x in the reference),
// for a mesh engine.
//
// Replace the reference's jitted device programs
//   coreth_tpu/evm/device/shard.py:151 build_sharded_occ_machine
//   (:197 run_kr, its key-range variant) and :267 get_shard_exchange.
// K9 runs K6's body per shard: shard d is CTAs [d*c, (d+1)*c) of one
// cluster of n*c <= 16 (c = 16/n at the main path's shapes), over lanes
// [d*B, (d+1)*B) of every block row (the lane tensors are n*B wide, so a
// block row's stride is n*B) and over table rows [d*G, (d+1)*G) (the
// tables are shard-major); its seeds and flags are its own slices of the
// wrapper's buffers.  The cluster barriers are the whole cluster's, so a
// shard that has converged waits out the others' rounds.  Without a sync
// set the shards never talk.  With one (the key-range variant: X keys
// with copies on several shards, sync_rows (X, n + 1) = the key's local
// row on each shard, G where it has none, then its owner shard), the
// window first gives every copy its owner's value, and after each block
// every shard's leader offers the copies its block changed: the writer
// is elected by a max over the shards' (d + 1) candidates and its value
// broadcast by an add over their contributions, the reference's two
// collectives, summed in shard order (integer adds and maxes: on one
// card the mode's order cannot be observed, so both modes run the same
// code).  A shard's offers travel through global slabs the wrapper
// allocates, double-buffered by block parity, between cluster barriers,
// read through L2 as in K8 (sharded_window.cu).  The reference's
// separate flags program (K9x) is K9's epilogue here: after a block's
// write-back each shard's leader folds its lanes' flags, still in its
// shared memory, into (all active lanes committed, any active lane
// escaped or pending) with two CTA votes and stores the pair in a
// (W, n, 2) slot; after the last block CTA 0 sums the pairs in shard
// order into the window's (W, 2) flags.
//
// Bound of K9: K6's, over the union of the shards' lanes; the copies'
// sync is no necessary work on one card.

#include <cuda_runtime.h>

#include "step_machine.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
#endif

// threads of a warp in the warp-wide loops (the sweep's walk)
#ifndef OCC_WARP
#define OCC_WARP 32
#endif

#ifndef OCC_SPEC
// The generic build has no traced program: the window runner gives
// every lane prog_id -1 (machine.run_occ_window picks this build only
// for an empty program set), so a lane that came here anyway is a
// caller's fault and traps (the launch fails; it does not escape).
__device__ __forceinline__ int spec_dispatch(int, const MachineIn&,
                                             const MachineDims&, int,
                                             int32_t*, const int32_t*) {
  __trap();
  return 0;
}
#endif

#ifdef __CUDACC__
// The group (one cluster of all the launch's CTAs), and the bulk copies
// that stage a block's inputs.  A host build of this file defines these
// helpers itself.
__device__ __forceinline__ int grp_rank() {
  return (int)cg::this_cluster().block_rank();
}
__device__ __forceinline__ void grp_sync() { cg::this_cluster().sync(); }
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void stage_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// orders this thread's earlier generic accesses of shared memory before
// the bulk copies it issues next
__device__ __forceinline__ void stage_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void stage_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void stage_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kKdigCap = 8;    // specialize.KDIG_CAP digest slots per lane
constexpr int kMaxShards = 8;  // the portable cluster size
constexpr int kMaxGroup = 16;  // CTAs of one cluster (non-portable > 8)
constexpr int kLanesPerCta = 16;  // the group's target lanes a CTA

// the sweep's lane flags (lfl)
constexpr int L_SKIP = 1, L_HOSTY = 2, L_PW = 4, L_DEP = 8, L_OK = 16,
              L_PEND = 32, L_ESC = 64, L_ACT = 128, L_SPEC = 256,
              L_WALK = 512;

struct OccDims {
  int W, G, R;
  int LS;  // lanes of one block row of the lane tensors (B; n*B sharded)
};

struct OccBuf {
  const int32_t *sgid, *active, *prog_id, *kdig, *env, *scal, *key_tab;
  int32_t *table, *packed, *steps, *seeds, *lanes;
  uint8_t* sweep;  // the sweep area's home when it is not in shared memory
};

// The group's layout (occ_layout): shards, CTAs a shard, lanes a CTA,
// lane-state slots and staged lanes a CTA, and the byte offsets of
// dynamic shared memory and of the sweep area.
struct OccGrp {
  int n, c, lpc, nslot, nstage, lstride, stage_lane, sweep_shared, wide;
  int o_stage, o_bar, o_own, o_sweep, smem;
  int s_kof, s_pos, s_spw, s_ent, s_kg, s_kfw, s_klw, s_lfl, s_wm, s_rm,
      s_cnt, s_misc,
      s_sort, sort_bytes, sweep_bytes;
};

// A column of the sweep's entry index: one value (-1, or a key, place or
// entry, each below B*S) an entry, int16 while B*S <= 32768 (the main
// path's shapes, at half the bytes), else int32 (sweep_layout's
// `wide`), so every batch x scache_cap has a layout.
struct EntCol {
  uint8_t* p;
  int wide;
  __device__ __forceinline__ int operator[](int i) const {
    return wide ? ((const int32_t*)p)[i] : ((const int16_t*)p)[i];
  }
  __device__ __forceinline__ void set(int i, int v) const {
    if (wide)
      ((int32_t*)p)[i] = v;
    else
      ((int16_t*)p)[i] = (int16_t)v;
  }
};

// The sweep area of a shard's leader.
struct Sweep {
  uint64_t* sort;  // (B*S): (table row << 32 | entry) of the block
  EntCol kof;      // (B*S): each entry's key, -1 if not premapped
  EntCol pos;      // (B*S): a premapped entry's place in `sort`
  EntCol spw;      // (B*S): the entry's earlier potential writer entry
                   // (the last before its lane), -1 if none
  EntCol ent;      // (B*S): the entry at each place of the sorted index
                   // (the sort buffer itself is lane-slot memory)
  int32_t *kg, *kfw, *klw;  // (K): table row, first potential writer
                            // lane, last valid writer entry
  int32_t* lfl;    // (B) lane flags
  uint32_t *wm, *rm;  // (B, SW) written / read premapped entries
  int32_t *cnt, *misc;  // scan scratch; [0] keys, [1] last dependent lane
};

__device__ __forceinline__ bool premapped(int g, int G) {
  return (unsigned)g < (unsigned)G;
}

__device__ __forceinline__ Sweep sweep_at(const OccGrp& g, uint8_t* area,
                                          uint8_t* sort) {
  Sweep w;
  w.sort = (uint64_t*)sort;
  w.kof = EntCol{area + g.s_kof, g.wide};
  w.kg = (int32_t*)(area + g.s_kg);
  w.kfw = (int32_t*)(area + g.s_kfw);
  w.pos = EntCol{area + g.s_pos, g.wide};
  w.spw = EntCol{area + g.s_spw, g.wide};
  w.ent = EntCol{area + g.s_ent, g.wide};
  w.klw = (int32_t*)(area + g.s_klw);
  w.lfl = (int32_t*)(area + g.s_lfl);
  w.wm = (uint32_t*)(area + g.s_wm);
  w.rm = (uint32_t*)(area + g.s_rm);
  w.cnt = (int32_t*)(area + g.s_cnt);
  w.misc = (int32_t*)(area + g.s_misc);
  return w;
}

// An exclusive prefix sum over the CTA's threads' values ``v`` (in
// ``cnt``, one int a thread); returns this thread's, and the total in
// ``*total`` on every thread.
__device__ int cta_scan(int32_t* cnt, int v, int* total) {
  const int tid = threadIdx.x, nt = blockDim.x;
  cnt[tid] = v;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int add = tid >= off ? cnt[tid - off] : 0;
    __syncthreads();
    cnt[tid] += add;
    __syncthreads();
  }
  *total = cnt[nt - 1];
  const int incl = cnt[tid];
  __syncthreads();
  return incl - v;
}

// The leader's block-local key index over the block's ``N`` entries:
// the premapped ones, compacted in entry order, sorted by (table row,
// entry) in shared memory (bitonic, padded to a power of two), each
// distinct row one key.
__device__ void blk_index(const Sweep& w, const int32_t* sgid, int N, int G) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int chunk = (N + nt - 1) / nt;
  const int lo = tid * chunk < N ? tid * chunk : N;
  const int hi = lo + chunk < N ? lo + chunk : N;
  int mine = 0, M = 0;
  for (int i = lo; i < hi; ++i) mine += premapped(sgid[i], G);
  int at = cta_scan(w.cnt, mine, &M);
  for (int i = lo; i < hi; ++i) {
    const int g = sgid[i];
    w.kof.set(i, -1);
    if (premapped(g, G)) w.sort[at++] = ((uint64_t)(uint32_t)g << 32) | i;
  }
  int M2 = 1;
  while (M2 < M) M2 <<= 1;
  for (int i = M + tid; i < M2; i += nt) w.sort[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= M2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < M2; i += nt) {
        const int p = i ^ j;
        if (p > i) {
          const uint64_t a = w.sort[i], b = w.sort[p];
          if ((a > b) == ((i & k) == 0)) {
            w.sort[i] = b;
            w.sort[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int mc = (M + nt - 1) / nt;
  const int mlo = tid * mc < M ? tid * mc : M;
  const int mhi = mlo + mc < M ? mlo + mc : M;
  auto key = [&](int i) { return (uint32_t)(w.sort[i] >> 32); };
  int fresh = 0;
  for (int i = mlo; i < mhi; ++i) fresh += i == 0 || key(i) != key(i - 1);
  int K = 0;
  int k = cta_scan(w.cnt, fresh, &K) - 1;
  for (int i = mlo; i < mhi; ++i) {
    if (i == 0 || key(i) != key(i - 1)) w.kg[++k] = (int32_t)key(i);
    w.kof.set((int)(uint32_t)w.sort[i], k);
    w.pos.set((int)(uint32_t)w.sort[i], i);
    w.ent.set(i, (int)(uint32_t)w.sort[i]);
  }
  if (tid == 0) w.misc[0] = K;
  __syncthreads();
}

__device__ __forceinline__ bool bit_of(const uint32_t* m, int e) {
  return m[e / 32] >> (e % 32) & 1;
}

// The last entry before sorted place ``p`` of the same key whose lane is
// earlier than ``j`` and a potential writer of it (``valid``: and valid
// this round); -1 if none.
__device__ int prev_writer(const Sweep& w, int S, int SW, int p, int j,
                           bool valid) {
  const int k = w.kof[w.ent[p]];
  for (int q = p - 1; q >= 0 && w.kof[w.ent[q]] == k; --q) {
    const int f = w.ent[q], l = f / S;
    const int lf = w.lfl[l];
    if (l < j && (lf & L_PW) && bit_of(w.wm + l * SW, f % S) &&
        (!valid || (lf & L_OK)))
      return f;
  }
  return -1;
}

// One round's validation of a shard's block (the reference occ_body's
// val_body, :1109-1129, in the order the file header describes); the
// leader's threads.  Returns, on every thread, whether some lane is
// pending and none escaping.
__device__ bool sweep_round(const Sweep& w, const MachineDims& d, int G,
                            const int32_t* pk, const int32_t* table,
                            const int32_t* active0, int32_t* seeds,
                            int32_t* pend_g) {
  const int B = d.B, S = d.S, PW = d.width + 4, SW = (S + 31) / 32;
  const int O_SFLAG = 5, O_SVAL = O_SFLAG + S + 16 * S,
            O_SORIG = O_SVAL + 16 * S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nK = w.misc[0];
  for (int k = tid; k < nK; k += nt) {
    w.kfw[k] = B;
    w.klw[k] = -1;
  }
  if (tid == 0) w.misc[1] = -1;
  __syncthreads();
  // pre-pass: each lane's status, its read and written premapped
  // entries, and each key's first potential writer
  for (int j = tid; j < B; j += nt) {
    const int32_t* row = pk + (size_t)j * PW;
    const int status = __ldcg(row), scnt = __ldcg(row + 4);
    bool miss = false, wany = false;
    for (int u = 0; u < SW; ++u) {
      uint32_t wm = 0, rm = 0;
      for (int b0 = 0; b0 < 32 && u * 32 + b0 < S; b0 += 8) {
        int32_t fl[8];  // eight flags in flight at once
#pragma unroll
        for (int q = 0; q < 8; ++q)
          fl[q] = u * 32 + b0 + q < S ? __ldcg(row + O_SFLAG + u * 32 + b0 + q)
                                      : 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int e = u * 32 + b0 + q;
          const bool ent = e < scnt && e < S && w.kof[j * S + e] >= 0;
          miss |= e < scnt && e < S && (fl[q] & F_MISS);
          if (ent && (fl[q] & F_READ)) rm |= 1u << (b0 + q);
          if (ent && (fl[q] & F_WRITTEN)) wm |= 1u << (b0 + q);
        }
      }
      w.wm[j * SW + u] = wm;
      w.rm[j * SW + u] = rm;
      wany |= wm != 0;
    }
    const bool hosty = status == SM_HOST || miss;
    const bool pw = status == SM_STOP && !hosty && wany;
    w.lfl[j] = (status == SM_SKIP ? L_SKIP : 0) | (hosty ? L_HOSTY : 0) |
               (pw ? L_PW : 0) | (active0[j] ? L_ACT : 0);
    if (pw)
      for (int e = 0; e < S; ++e)
        if (bit_of(w.wm + j * SW, e)) atomicMin(&w.kfw[w.kof[j * S + e]], j);
  }
  __syncthreads();
  // every lane against the table plus the writes of the lanes before it
  // on the speculation that each potential writer is valid: exact for an
  // independent lane (it has no earlier writer), and for a dependent
  // lane whose entries' last earlier potential writers (`spw`) all turn
  // out valid
  for (int j = tid; j < B; j += nt) {
    int lf = w.lfl[j];
    bool dep = false;
    for (int e = 0; e < S && !dep; ++e) {
      const int k = w.kof[j * S + e];
      dep = k >= 0 && w.kfw[k] < j;
    }
    if (dep) {
      lf |= L_DEP;
      atomicMax(&w.misc[1], j);
    }
    if (!(lf & (L_SKIP | L_HOSTY))) {
      const int32_t* row = pk + (size_t)j * PW;
      bool ok = true;
      for (int e = 0; e < S; ++e) {
        const int k = w.kof[j * S + e];
        if (k < 0) continue;  // (its seed stays 0)
        const int f = dep ? prev_writer(w, S, SW, w.pos[j * S + e], j, false)
                          : -1;
        if (dep) w.spw.set(j * S + e, f);
        const int32_t* cur =
            f >= 0 ? pk + (size_t)(f / S) * PW + O_SVAL + (f % S) * 16
                   : table + (size_t)w.kg[k] * 16;
        int32_t cv[16];
#pragma unroll
        for (int l = 0; l < 16; ++l) cv[l] = __ldcg(cur + l);
        if (bit_of(w.rm + j * SW, e)) {
          int32_t ov[16];
#pragma unroll
          for (int l = 0; l < 16; ++l) ov[l] = __ldcg(row + O_SORIG + e * 16 + l);
#pragma unroll
          for (int l = 0; l < 16; ++l) ok &= ov[l] == cv[l];
        }
#pragma unroll
        for (int l = 0; l < 16; ++l)
          __stcg(seeds + ((size_t)j * S + e) * 16 + l, cv[l]);
      }
      lf |= dep ? (ok ? L_SPEC : 0) : (ok ? L_OK : L_PEND);
    }
    w.lfl[j] = lf;
  }
  __syncthreads();
  // a dependent lane whose speculated writers are all independent is
  // settled now (their validity is known); the walk takes the others
  for (int j = tid; j < B; j += nt) {
    int lf = w.lfl[j];
    if (!(lf & L_DEP) || (lf & (L_SKIP | L_HOSTY))) continue;
    bool walk = false;
    for (int e = 0; e < S && !walk; ++e) {
      if (w.kof[j * S + e] < 0) continue;
      const int f = w.spw[j * S + e];
      if (f < 0) continue;
      const int wl = w.lfl[f / S];
      walk = (wl & L_DEP) || !(wl & L_OK);
    }
    w.lfl[j] = lf | (walk ? L_WALK : ((lf & L_SPEC) ? L_OK : L_PEND));
  }
  __syncthreads();
  // the walk: one warp, those dependent lanes in tx order.  A lane whose
  // speculated writers are all valid keeps its speculative result (a
  // few shared-memory reads); else it is checked again against the last
  // valid writer of each entry, and re-seeded
  const int last = w.misc[1];
  if (tid < OCC_WARP) {
    const int lane = tid;
    for (int base = 0; base <= last; base += OCC_WARP) {
      const int jj = base + lane;
      unsigned todo =
          __ballot_sync(0xffffffffu, jj <= last && (w.lfl[jj] & L_WALK));
      while (todo) {
        const int j = base + __ffs(todo) - 1;
        todo &= todo - 1;
        int lf = w.lfl[j];
        bool stale = false;
        for (int e = lane; e < S; e += OCC_WARP) {
          const int f = w.kof[j * S + e] >= 0 ? w.spw[j * S + e] : -1;
          stale |= f >= 0 && !(w.lfl[f / S] & L_OK);
        }
        if (__any_sync(0xffffffffu, stale)) {
          const int32_t* row = pk + (size_t)j * PW;
          bool bad = false;
          for (int x = lane; x < S * 16; x += OCC_WARP) {
            const int e = x >> 4, l = x & 15;
            const int k = w.kof[j * S + e];
            if (k < 0) continue;
            const int f = prev_writer(w, S, SW, w.pos[j * S + e], j, true);
            const int32_t cur =
                f >= 0 ? __ldcg(pk + (size_t)(f / S) * PW + O_SVAL +
                                (f % S) * 16 + l)
                       : __ldcg(table + (size_t)w.kg[k] * 16 + l);
            if (bit_of(w.rm + j * SW, e))
              bad |= __ldcg(row + O_SORIG + x) != cur;
            __stcg(seeds + (size_t)j * S * 16 + x, cur);
          }
          bad = __any_sync(0xffffffffu, bad);
          lf = (lf & ~L_SPEC) | (bad ? 0 : L_SPEC);
        }
        lf |= (lf & L_SPEC) ? L_OK : L_PEND;
        if (lane == 0) w.lfl[j] = lf;
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // each key's last valid writer, and the lanes' flags of the round
  int anyp = 0, anye = 0;
  for (int j = tid; j < B; j += nt) {
    int lf = w.lfl[j];
    if ((lf & L_OK) && (lf & L_PW))
      for (int e = 0; e < S; ++e)
        if (w.wm[j * SW + e / 32] >> (e % 32) & 1)
          atomicMax(&w.klw[w.kof[j * S + e]], j * S + e);
    if ((lf & L_HOSTY) && (lf & L_ACT)) {
      lf |= L_ESC;
      w.lfl[j] = lf;
    }
    __stcg(pend_g + j, (lf & L_PEND) ? 1 : 0);
    anyp |= (lf & L_PEND) != 0;
    anye |= (lf & L_ESC) != 0;
  }
  const bool more = __syncthreads_or(anyp) != 0;
  const bool esc = __syncthreads_or(anye) != 0;
  return more && !esc;
}

// The leader after a block's last round: each key's last valid write
// into the table, and the rows' trailing columns.
__device__ void blk_writeback(const Sweep& w, const MachineDims& d,
                              int32_t* pk, int32_t* table, int rnd) {
  const int B = d.B, S = d.S, PW = d.width + 4;
  const int O_SVAL = 5 + S + 16 * S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nK = rnd > 0 ? w.misc[0] : 0;
  for (int x = tid; x < nK * 16; x += nt) {
    const int f = w.klw[x >> 4];
    if (f >= 0)
      __stcg(table + (size_t)w.kg[x >> 4] * 16 + (x & 15),
             __ldcg(pk + (size_t)(f / S) * PW + O_SVAL + (f % S) * 16 +
                    (x & 15)));
  }
  for (int j = tid; j < B; j += nt) {
    const int lf = w.lfl[j];
    int32_t* row = pk + (size_t)j * PW + d.width;
    row[0] = (lf & L_OK) != 0;
    row[1] = (lf & L_ESC) != 0;
    row[2] = (lf & L_PEND) != 0;
    row[3] = rnd;
  }
}

// K9's epilogue, in a shard's leader after the block's write-back: the
// shard's flags of the block, as the trailing columns it just wrote
// (every thread of the CTA takes part in the votes).
__device__ void blk_flags(const Sweep& w, int B, const int32_t* active0,
                          int32_t* pair) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int clean = 1, dirty = 0;
  for (int j = tid; j < B; j += nt) {
    const int lf = w.lfl[j];
    if (!active0[j]) continue;
    clean &= (lf & L_OK) != 0;
    dirty |= (lf & (L_ESC | L_PEND)) != 0;
  }
  clean = __syncthreads_and(clean);
  dirty = __syncthreads_or(dirty);
  if (tid == 0) {
    __stcg(pair, clean ? 1 : 0);
    __stcg(pair + 1, dirty ? 1 : 0);
  }
}

// Warp 0 of a CTA issues the bulk copies of block ``w2``'s staged inputs
// of its first nstage lanes into buffer w2 & 1: the calldata up to
// data_len, and the key words of each premapped entry.
__device__ void stage_issue(const MachineIn& in, const MachineDims& d,
                            const OccDims& o, const OccBuf& b,
                            const OccGrp& g, int w2, size_t l0, int lo,
                            int nl, int32_t* stage, uint64_t* bar) {
  const int tid = threadIdx.x;
  if (tid >= OCC_WARP) return;
  const int S = d.S, DC = d.data_cap;
  const size_t wb = (size_t)w2 * o.LS + l0;
  int32_t* buf = stage + (size_t)(w2 & 1) * g.nstage * g.stage_lane;
  const int ns = g.nstage < nl ? g.nstage : nl;
  stage_fence();
  uint32_t bytes = 0;
  for (int q = tid; q < ns; q += OCC_WARP) {
    const size_t i = wb + lo + q;
    if (!b.active[i]) continue;
    const int len = in.data_len[i] < DC ? in.data_len[i] : DC;
    bytes += (uint32_t)((len * 4 + 15) / 16 * 16);
    for (int e = 0; e < S; ++e) bytes += premapped(b.sgid[i * S + e], o.G) * 64;
  }
  stage_expect(bar + (w2 & 1), bytes);
  for (int q = tid; q < ns; q += OCC_WARP) {
    const size_t i = wb + lo + q;
    if (!b.active[i]) continue;
    int32_t* dst = buf + (size_t)q * g.stage_lane;
    const int len = in.data_len[i] < DC ? in.data_len[i] : DC;
    const uint32_t cb = (uint32_t)((len * 4 + 15) / 16 * 16);
    if (cb) stage_copy(dst, in.calldata + i * DC, cb, bar + (w2 & 1));
    for (int e = 0; e < S; ++e) {
      const int gg = b.sgid[i * S + e];
      if (premapped(gg, o.G))
        stage_copy(dst + DC + e * 16, b.key_tab + (size_t)gg * 16, 64,
                   bar + (w2 & 1));
    }
  }
}

// K6's and K9's body: the launch's CTAs are one cluster of n shards x c.
// K9 passes ``flags``: (W, 2) the window's flags, then the (W, n, 2)
// slot of the shards' pairs; K6 passes null and folds no flags.
__device__ void occ_group(const MachineIn& in, const MachineDims& d,
                          OccDims o, OccBuf b, const OccGrp& g,
                          int X, const int32_t* xrows, int32_t* xpre,
                          int32_t* xxc, int32_t* xxv, int32_t* flags) {
  extern __shared__ __align__(16) uint8_t occ_smem[];
  const int rank = grp_rank();
  const int n = g.n, c = g.c, s = rank / c, m = rank % c;
  const bool leader = m == 0;
  const int B = d.B, S = d.S, G = o.G, PW = d.width + 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t CW = (size_t)d.code_cap + 33;
  const size_t l0 = (size_t)s * B;
  const int lo = m * g.lpc < B ? m * g.lpc : B;
  const int nl = (lo + g.lpc < B ? lo + g.lpc : B) - lo;
  // this shard's table rows, seeds, flags and sweep area
  b.table += (size_t)s * G * 16;
  b.key_tab += (size_t)s * G * 16;
  b.seeds += (size_t)s * B * S * 16;
  int32_t* pend_g = b.lanes + (size_t)s * (B + 32);
  int32_t* go_g = b.lanes + (size_t)n * (B + 32);
  uint8_t* area = g.sweep_shared ? occ_smem + g.o_sweep
                                 : b.sweep + (size_t)s * g.sweep_bytes;
  const Sweep w = sweep_at(g, area, g.sweep_shared ? occ_smem : area + g.s_sort);
  int32_t* stage = (int32_t*)(occ_smem + g.o_stage);
  uint64_t* bar = (uint64_t*)(occ_smem + g.o_bar);
  int32_t* own_nk = (int32_t*)(occ_smem + g.o_own);
  int32_t* own_pend = own_nk + g.lpc;
  int32_t* own_logc = own_pend + g.lpc;
  __shared__ int s_flag;
  const int slot = sm_lane_slot(tid, nt);
  const int nslot = g.nslot < nt ? g.nslot : nt;
  uint8_t* lane_mem = occ_smem + (size_t)slot * g.lstride;

  if (g.nstage) {
    if (tid == 0) {
      stage_init(bar, OCC_WARP);
      stage_init(bar + 1, OCC_WARP);
    }
    __syncthreads();
    if (o.W > 0) stage_issue(in, d, o, b, g, 0, l0, lo, nl, stage, bar);
  }
  // @split kernel-start
  const int R1 = n + 1;
  int32_t* pre = xpre + (size_t)s * X * 16;
  auto xc = [&](int buf, int t) { return xxc + ((size_t)buf * n + t) * X; };
  auto xv = [&](int buf, int t) {
    return xxv + ((size_t)buf * n + t) * X * 16;
  };
  if (X > 0) {
    // the window-start seed: every copy takes its owner's value (a copy
    // made while the previous window ran was seeded from the host mirror)
    if (leader)
      for (int e = tid; e < X * 16; e += nt) {
        const int j = e / 16, k = e % 16, r = xrows[j * R1 + s];
        const bool mine = xrows[j * R1 + n] == s && r < G;
        __stcg(xv(1, s) + e, mine ? __ldcg(b.table + (size_t)r * 16 + k) : 0);
      }
    grp_sync();
    if (leader)
      for (int e = tid; e < X * 16; e += nt) {
        const int j = e / 16, k = e % 16, r = xrows[j * R1 + s];
        if (r >= G) continue;
        unsigned v = 0;
        for (int t = 0; t < n; ++t) v += (unsigned)__ldcg(xv(1, t) + e);
        __stcg(b.table + (size_t)r * 16 + k, (int32_t)v);
      }
    grp_sync();
  }

  for (int wi = 0; wi < o.W; ++wi) {
    // @split block-start
    const size_t wb = (size_t)wi * o.LS + l0;
    const int32_t* sgid = b.sgid + wb * S;
    const int32_t* active0 = b.active + wb;
    int32_t* pk = b.packed + wb * PW;
    MachineIn bi = in;
    bi.code = in.code + wb * CW;
    bi.jdest = in.jdest + wb * d.code_cap;
    bi.code_len = in.code_len + wb;
    bi.calldata = in.calldata + wb * d.data_cap;
    bi.data_len = in.data_len + wb;
    bi.start_gas = in.start_gas + wb;
    bi.callvalue = in.callvalue + wb * 16;
    bi.caller = in.caller + wb * 16;
    bi.address = in.address + wb * 16;
    bi.origin = in.origin + wb * 16;
    bi.gasprice = in.gasprice + wb * 16;
    bi.env = b.env + (size_t)wi * 48;
    bi.skey = bi.sval = bi.sorig = bi.sflag = nullptr;
    MachineDims bd = d;
    bd.timestamp = b.scal[wi];
    bd.number = b.scal[o.W + wi];
    bd.gaslimit = b.scal[2 * o.W + wi];
    const int32_t* staged =
        stage + (size_t)(wi & 1) * g.nstage * g.stage_lane;
    if (g.nstage) {
      // block wi's staged inputs have landed; block wi+1's start
      if (tid == 0) stage_wait(bar + (wi & 1), (wi >> 1) & 1);
      __syncthreads();
      if (wi + 1 < o.W)
        stage_issue(in, d, o, b, g, wi + 1, l0, lo, nl, stage, bar);
    }
    if (leader && X > 0)
      for (int e = tid; e < X * 16; e += nt) {
        const int j = e / 16, k = e % 16, r = xrows[j * R1 + s];
        pre[e] = r < G ? __ldcg(b.table + (size_t)r * 16 + k) : 0;
      }
    // init: this CTA's rows, key counts, pending flags, steps and seeds
    for (int li = 0; li < nl; ++li) {
      int32_t* row = pk + (size_t)(lo + li) * PW;
      for (int col = tid; col < PW; col += nt) row[col] = col ? 0 : SM_SKIP;
    }
    for (int x0 = tid; x0 < nl * S * 16; x0 += 4 * nt) {
      int32_t v[4];  // four loads in flight a thread
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = x0 + q * nt;
        const int r = x < nl * S * 16 ? sgid[(size_t)lo * S + (x >> 4)] : -1;
        v[q] = premapped(r, G) ? __ldcg(b.table + (size_t)r * 16 + (x & 15))
                               : 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (x0 + q * nt < nl * S * 16)
          __stcg(b.seeds + (size_t)lo * S * 16 + x0 + q * nt, v[q]);
    }
    for (int li = tid; li < nl; li += nt) {
      const int i = lo + li;
      int nk = 0;
      for (int e = 0; e < S; ++e) nk += premapped(sgid[i * S + e], G);
      own_nk[li] = nk;
      __stcg(pend_g + i, active0[i] != 0 ? 1 : 0);
      b.steps[wb + i] = 0;
    }
    if (leader) {
      blk_index(w, sgid, B * S, G);
      for (int j = tid; j < B; j += nt) w.lfl[j] = 0;
      if (tid == 0) __stcg(go_g + s, 0);
    }
    int act = 0, act_all = 0;
    for (int j = tid; j < n * B; j += nt) {
      const int a = b.active[(size_t)wi * o.LS + j] != 0;
      act_all |= a;
      act |= a && j / B == s;
    }
    bool my_go = __syncthreads_or(act) != 0;
    bool any_go = __syncthreads_or(act_all) != 0;
    // @split init-end
    int rnd = 0;
    while (any_go) {
      // @split round-start
      if (my_go) {
        // exec: seed the rows of this CTA's pending lanes (the storage
        // cache, and the log slots the lane's last run filled: the rest
        // of the pool is still zero), then run them
        const RowLayout L = sm_row_layout(d);
        for (int li = tid; li < nl; li += nt) {
          own_pend[li] = __ldcg(pend_g + lo + li);
          own_logc[li] = own_pend[li]
                             ? pk[(size_t)(lo + li) * PW + L.LOGCNT] : 0;
        }
        __syncthreads();
        const int O_SKEY = L.SKEY, O_SVAL = L.SVAL, O_SORIG = L.SORIG;
        for (int li = 0; li < nl; ++li) {
          if (!own_pend[li]) continue;
          const int i = lo + li;
          int32_t* row = pk + (size_t)i * PW;
          const int32_t* sg = sgid + (size_t)i * S;
          const int32_t* sd = b.seeds + (size_t)i * S * 16;
          const int32_t* kw =
              li < g.nstage ? staged + (size_t)li * g.stage_lane + d.data_cap
                            : nullptr;
          for (int col = 5 + tid; col < L.LOGNT; col += nt) {
            int32_t v;
            if (col < O_SKEY) {
              v = premapped(sg[col - 5], G) ? F_VALID : 0;
            } else if (col < O_SVAL) {
              const int x = col - O_SKEY, r = sg[x >> 4];
              v = !premapped(r, G) ? 0
                  : kw ? kw[x] : b.key_tab[(size_t)r * 16 + (x & 15)];
            } else {
              v = __ldcg(sd + (col < O_SORIG ? col - O_SVAL : col - O_SORIG));
            }
            row[col] = v;
          }
          const int c = sm_clamp(own_logc[li], 0, d.LC);
          for (int x = tid; x < c; x += nt) {
            row[L.LOGNT + x] = 0;
            row[L.LOGDLEN + x] = 0;
          }
          for (int x = tid; x < c * 64; x += nt) row[L.LOGTOP + x] = 0;
          for (int x = tid; x < c * d.LD; x += nt) row[L.LOGDATA + x] = 0;
        }
        __syncthreads();
        if (slot < nslot)
          for (int li = slot; li < nl; li += nslot) {
            if (!own_pend[li]) continue;
            const int i = lo + li;
            MachineIn v = bi;
            v.code = bi.code + (size_t)i * CW;
            v.jdest = bi.jdest + (size_t)i * d.code_cap;
            v.code_len = bi.code_len + i;
            v.calldata = li < g.nstage ? staged + (size_t)li * g.stage_lane
                                       : bi.calldata + (size_t)i * d.data_cap;
            v.data_len = bi.data_len + i;
            v.start_gas = bi.start_gas + i;
            v.active = own_pend + li;
            v.scnt = own_nk + li;
            v.callvalue = bi.callvalue + (size_t)i * 16;
            v.caller = bi.caller + (size_t)i * 16;
            v.address = bi.address + (size_t)i * 16;
            v.origin = bi.origin + (size_t)i * 16;
            v.gasprice = bi.gasprice + (size_t)i * 16;
            int32_t* row = pk + (size_t)i * PW;
            const int pid = b.prog_id[wb + i];
            b.steps[wb + i] +=
                pid < 0 ? sm_run_lane(v, bd, 0, row, lane_mem)
                        : spec_dispatch(pid, v, bd, 0, row,
                                        b.kdig + (wb + i) * kKdigCap * 16);
          }
      }
      grp_sync();
      // @split exec-end
      if (my_go && leader) {
        const bool more = sweep_round(w, d, G, pk, b.table, active0,
                                      b.seeds, pend_g);
        if (tid == 0) __stcg(go_g + s, more && rnd + 1 < o.R ? 1 : 0);
      }
      grp_sync();
      // @split sweep-end
      if (my_go) ++rnd;
      if (tid == 0) {
        int any = 0;
        for (int t = 0; t < n; ++t) any |= __ldcg(go_g + t);
        s_flag = (__ldcg(go_g + s) ? 1 : 0) | (any ? 2 : 0);
      }
      __syncthreads();
      my_go = my_go && (s_flag & 1);
      any_go = (s_flag & 2) != 0;
      __syncthreads();
    }
    // @split writeback-start
    if (leader) blk_writeback(w, d, pk, b.table, rnd);
    if (leader && flags)
      blk_flags(w, B, active0, flags + 2 * o.W + ((size_t)wi * n + s) * 2);
    if (X > 0) {
      const int buf = wi & 1;
      __syncthreads();
      // elect: the shard whose block changed a copy offers s + 1
      if (leader)
        for (int j = tid; j < X; j += nt) {
          const int r = xrows[j * R1 + s];
          bool changed = false;
          if (r < G)
            for (int k = 0; k < 16; ++k)
              changed |= __ldcg(b.table + (size_t)r * 16 + k) != pre[j * 16 + k];
          __stcg(xc(buf, s) + j, changed ? s + 1 : 0);
        }
      grp_sync();
      // offer: the winner's value (it changed the copy, so it has one)
      if (leader)
        for (int e = tid; e < X * 16; e += nt) {
          const int j = e / 16, k = e % 16;
          int win = 0;
          for (int t = 0; t < n; ++t) win = max(win, __ldcg(xc(buf, t) + j));
          const int cs = __ldcg(xc(buf, s) + j);
          const int r = xrows[j * R1 + s];
          __stcg(xv(buf, s) + e,
                 cs != 0 && cs == win ? __ldcg(b.table + (size_t)r * 16 + k)
                                      : 0);
        }
      grp_sync();
      // broadcast: every copy takes the winner's value
      if (leader)
        for (int e = tid; e < X * 16; e += nt) {
          const int j = e / 16, k = e % 16, r = xrows[j * R1 + s];
          if (r >= G) continue;
          int win = 0;
          for (int t = 0; t < n; ++t) win = max(win, __ldcg(xc(buf, t) + j));
          if (win == 0) continue;
          unsigned v = 0;
          for (int t = 0; t < n; ++t) v += (unsigned)__ldcg(xv(buf, t) + e);
          __stcg(b.table + (size_t)r * 16 + k, (int32_t)v);
        }
    }
    grp_sync();
    // @split writeback-end
  }
  // the shards' pairs, summed in shard order (the last block's cluster
  // barrier ordered every leader's slot stores before these loads)
  if (flags && rank == 0)
    for (int e = tid; e < 2 * o.W; e += nt) {
      const int32_t* pair = flags + 2 * o.W + (size_t)(e >> 1) * n * 2;
      int v = 0;
      for (int t = 0; t < n; ++t) v += __ldcg(pair + 2 * t + (e & 1));
      flags[e] = v;
    }
  // @split kernel-end
}

__global__ void __launch_bounds__(kThreads, 1)
    occ_window_kernel(MachineIn in, MachineDims d, OccDims o, OccBuf b,
                      OccGrp g) {
  occ_group(in, d, o, b, g, 0, nullptr, nullptr, nullptr, nullptr, nullptr);
}

// The key-range sync's inputs and slabs: rows (X, n + 1) int32; pre
// (n, X, 16) each shard's copies before the block; xc (2, n, X) the
// shards' writer candidates and xv (2, n, X, 16) their contributions,
// by block parity; and the window's flags with their slot (occ_group).
struct OccXchg {
  int X;
  const int32_t* rows;
  int32_t *pre, *xc, *xv, *flags;
};

// K9: one cluster of n shards x c CTAs per window.
__global__ void __launch_bounds__(kThreads, 1)
    occ_sharded_kernel(MachineIn in, MachineDims d, OccDims o, OccBuf b,
                       OccGrp g, OccXchg x) {
  occ_group(in, d, o, b, g, x.X, x.rows, x.pre, x.xc, x.xv, x.flags);
}

// The flags of a window whose blocks have no lane: every shard clean.
__global__ void flags_fill_kernel(int32_t* __restrict__ flags, int W,
                                  int n) {
  for (int e = threadIdx.x; e < 2 * W; e += blockDim.x)
    flags[e] = e & 1 ? 0 : n;
}

}  // namespace

// The launch arguments of a window (the K6 entry's, but the stream).
#define OCC_PARAMS                                                          \
  const void *code, const void *jdest, const void *code_len,               \
      const void *calldata, const void *data_len, const void *start_gas,   \
      const void *active, const void *sgid, const void *prog_id,           \
      const void *kdig, const void *callvalue, const void *caller,         \
      const void *address, const void *origin, const void *gasprice,       \
      const void *env, const void *scal, const void *tables,               \
      const void *key_tab, const void *dims, void *table, void *packed,    \
      void *steps, void *seeds, void *lanes, void *sweep
#define OCC_ARGS                                                            \
  code, jdest, code_len, calldata, data_len, start_gas, active, sgid,      \
      prog_id, kdig, callvalue, caller, address, origin, gasprice, env,    \
      scal, tables, key_tab, dims, table, packed, steps, seeds, lanes,     \
      sweep

namespace {

int round16(int v) { return (v + 15) / 16 * 16; }

// The sweep area's offsets (the sort buffer last) for B lanes of S
// entries; returns its bytes without the sort buffer.
int sweep_layout(int B, int S, OccGrp* g) {
  const int N = B * S, SW = (S + 31) / 32;
  g->wide = N > 32768;
  const int col = g->wide ? 4 : 2;  // an EntCol's bytes an entry
  int at = 0;
  g->s_kof = at; at += round16(N * col);
  g->s_kg = at; at += round16(N * 4);
  g->s_kfw = at; at += round16(N * 4);
  g->s_pos = at; at += round16(N * col);
  g->s_spw = at; at += round16(N * col);
  g->s_ent = at; at += round16(N * col);
  g->s_klw = at; at += round16(N * 4);
  g->s_lfl = at; at += round16(B * 4);
  g->s_wm = at; at += round16(B * SW * 4);
  g->s_rm = at; at += round16(B * SW * 4);
  g->s_cnt = at; at += round16(kThreads * 4);
  g->s_misc = at; at += 64;
  int N2 = 1;
  while (N2 < N) N2 <<= 1;
  g->s_sort = at;
  g->sort_bytes = N2 * 8;
  g->sweep_bytes = at + g->sort_bytes;
  return at;
}

// The group's layout for n shards of c CTAs within ``avail`` bytes of
// shared memory a CTA: the sweep area in shared memory when it fits
// beside a slot for every lane of the CTA, else in device memory; then
// as many lane slots as fit, then staged lanes with what is left.
// Returns 0, or -3 when not one lane slot fits.
int occ_layout(const MachineDims& d, int n, int c, int avail, bool can_stage,
               OccGrp* g) {
  const int B = d.B, S = d.S;
  g->n = n;
  g->c = c;
  g->lpc = (B + c - 1) / c;
  g->lstride = sm_lane_stride(d.arena_w);
  g->stage_lane = d.data_cap + 16 * S;           // int32 words
  const int sweep = sweep_layout(B, S, g);
  const int sort = g->sort_bytes;
  const int fixed = 16 + round16(3 * g->lpc * 4);  // barriers, own lanes
  auto lanes_bytes = [&](int slots, bool shared_sort) {
    const int l = round16(slots * g->lstride);
    return shared_sort && l < sort ? sort : l;
  };
  g->sweep_shared =
      fixed + lanes_bytes(g->lpc, true) + sweep <= avail ? 1 : 0;
  if (g->sweep_shared) {
    g->nslot = g->lpc;
  } else {
    g->nslot = (avail - fixed) / g->lstride;
    if (g->nslot > g->lpc) g->nslot = g->lpc;
    if (g->nslot < 1) return -3;
  }
  const int lanes = lanes_bytes(g->nslot, g->sweep_shared);
  const int used = lanes + fixed + (g->sweep_shared ? sweep : 0);
  const int per = 2 * g->stage_lane * 4;
  g->nstage = can_stage ? (avail - used) / per : 0;
  if (g->nstage > g->lpc) g->nstage = g->lpc;
  if (g->nstage < 0) g->nstage = 0;
  g->o_stage = lanes;
  g->o_bar = g->o_stage + g->nstage * per;
  g->o_own = g->o_bar + 16;
  g->o_sweep = g->o_own + round16(3 * g->lpc * 4);
  g->smem = g->o_sweep + (g->sweep_shared ? sweep : 0);
  return 0;
}

// The kernels' structs from the launch arguments; false for an empty
// window (no lane or no block).
bool occ_fill(OCC_PARAMS, MachineIn* in, MachineDims* d, OccDims* o,
              OccBuf* b, int* sweep_cap) {
  const int32_t* dm = (const int32_t*)dims;
  int* f = &d->B;
  for (int k = 0; k < 18; ++k) f[k] = dm[k];
  *o = OccDims{dm[18], dm[19], dm[20], d->B};
  *sweep_cap = dm[21];
  if (d->B <= 0 || o->W <= 0) return false;
  in->code = (const int32_t*)code;
  in->jdest = (const int32_t*)jdest;
  in->code_len = (const int32_t*)code_len;
  in->calldata = (const int32_t*)calldata;
  in->data_len = (const int32_t*)data_len;
  in->start_gas = (const int32_t*)start_gas;
  in->callvalue = (const int32_t*)callvalue;
  in->caller = (const int32_t*)caller;
  in->address = (const int32_t*)address;
  in->origin = (const int32_t*)origin;
  in->gasprice = (const int32_t*)gasprice;
  in->tables = (const int32_t*)tables;
  b->sgid = (const int32_t*)sgid;
  b->active = (const int32_t*)active;
  b->prog_id = (const int32_t*)prog_id;
  b->kdig = (const int32_t*)kdig;
  b->env = (const int32_t*)env;
  b->scal = (const int32_t*)scal;
  b->key_tab = (const int32_t*)key_tab;
  b->table = (int32_t*)table;
  b->packed = (int32_t*)packed;
  b->steps = (int32_t*)steps;
  b->seeds = (int32_t*)seeds;
  b->lanes = (int32_t*)lanes;
  b->sweep = (uint8_t*)sweep;
  return true;
}

// The launch of ``kernel`` as one cluster of n shards x c CTAs: the
// largest c (a power of two, at most kMaxGroup / n and B /
// kLanesPerCta) whose layout fits and whose cluster the card can hold.
// Fills ``g`` and ``cfg`` (``attr`` its cluster attribute).  Returns 0,
// -1 when no cluster fits, -3 when no layout fits, else a cudaError.
template <class K>
int occ_pick(K kernel, int n, const MachineDims& d, bool can_stage,
             cudaStream_t stream, OccGrp* g, cudaLaunchConfig_t* cfg,
             cudaLaunchAttribute* attr) {
  int dev = 0, avail = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(
      &avail, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  avail -= 1024;  // the kernel's static shared memory, with room
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  int c = 1;
  while (2 * c * n <= kMaxGroup && 2 * c * kLanesPerCta <= d.B) c *= 2;
  int rc = -1;
  for (; c >= 1; c /= 2) {
    if (occ_layout(d, n, c, avail, can_stage, g) != 0) {
      rc = -3;
      continue;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
    if (err != cudaSuccess) return (int)err;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(n * c, 1, 1);
    cfg->blockDim = dim3(kThreads, 1, 1);
    cfg->dynamicSmemBytes = g->smem;
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = n * c;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel,
                                         cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters >= 1) return 0;
    rc = -1;
  }
  return rc;
}

// Launch ``kernel`` on the group occ_pick chose.  Returns occ_pick's
// codes, -4 when the wrapper's sweep buffer is too small, else the
// launch's cudaError.
template <class K, class... A>
int occ_group_launch(K kernel, int n, const MachineIn& in,
                     const MachineDims& d, OccDims o, const OccBuf& b,
                     int sweep_cap, cudaStream_t stream, A... extra) {
  o.LS = n * d.B;
  const bool can_stage = d.data_cap % 4 == 0 &&
                         (uintptr_t)in.calldata % 16 == 0 &&
                         (uintptr_t)b.key_tab % 16 == 0;
  OccGrp g;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int rc = occ_pick(kernel, n, d, can_stage, stream, &g, &cfg, attr);
  if (rc != 0) return rc;
  if (!g.sweep_shared && g.sweep_bytes > sweep_cap) return -4;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, in, d, o, b, g, extra...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dims: host int32[22] = the 18 MachineDims fields (B, stack_cap,
// mem_cap, code_cap, data_cap, S, TC, LC, LD, keccak_cap, copy_cap,
// max_steps, refunds, timestamp, number, gaslimit, width, arena_w; the
// three block words are per block, in `scal`), then W, G, R and the
// bytes of `sweep` a shard.  prog_id (W, B) int32 selects each lane's
// traced program (-1: the interpreter), kdig (W, B, 8, 16) int32 holds
// its host-evaluated keccak digests.  seeds (B, S, 16), lanes (B + 32 +
// 1) and sweep are the kernel's scratch.  Returns as occ_group_launch.
extern "C" int occ_window_launch(OCC_PARAMS, void* stream) {
  MachineIn in;
  MachineDims d;
  OccDims o;
  OccBuf b;
  int cap = 0;
  if (!occ_fill(OCC_ARGS, &in, &d, &o, &b, &cap)) return 0;
  return occ_group_launch(occ_window_kernel, 1, in, d, o, b, cap,
                          (cudaStream_t)stream);
}

// K9: n shards as one cluster on `stream`.  The arguments are K6's with
// every lane tensor n*B wide (dims still hold the per-shard B and G),
// the tables n*G rows, and the scratch (seeds, lanes, sweep) n times
// K6's (lanes n*(B + 32) + n); before them the sync set: X rows of
// `rows` (X, n + 1) int32 and the slabs pre (n, X, 16), xc (2, n, X), xv
// (2, n, X, 16) int32 (unused when X = 0), and flags, int32[2W(n + 1)]:
// the window's (W, 2) flags (per block the shards whose active lanes
// all committed, and the shards with an active lane that escaped or is
// pending), then their (W, n, 2) slot.  Returns -2 for a width past
// kMaxShards, else as occ_group_launch.
extern "C" int occ_sharded_launch(int n, int X, const void* rows,
                                  void* pre, void* xc, void* xv,
                                  void* flags, OCC_PARAMS, void* stream) {
  if (n < 1 || n > kMaxShards) return -2;
  MachineIn in;
  MachineDims d;
  OccDims o;
  OccBuf b;
  int cap = 0;
  if (!occ_fill(OCC_ARGS, &in, &d, &o, &b, &cap)) {
    if (o.W <= 0) return 0;
    flags_fill_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (int32_t*)flags, o.W, n);
    return (int)cudaGetLastError();
  }
  OccXchg x{X, (const int32_t*)rows, (int32_t*)pre, (int32_t*)xc,
            (int32_t*)xv, (int32_t*)flags};
  return occ_group_launch(occ_sharded_kernel, n, in, d, o, b, cap,
                          (cudaStream_t)stream, x);
}

// The group a window of ``dims`` (as occ_window_launch takes them) runs
// on with n shards (K6 for n = 1, else K9), aligned inputs assumed:
// out int32[6] = c, lanes a CTA, lane slots, staged lanes, dynamic
// shared memory a CTA, whether the sweep area is in shared memory.
// Returns as occ_pick.
extern "C" int occ_group_info(int n, const void* dims, void* out) {
  MachineDims d;
  const int32_t* dm = (const int32_t*)dims;
  int* f = &d.B;
  for (int k = 0; k < 18; ++k) f[k] = dm[k];
  OccGrp g;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int rc =
      n == 1 ? occ_pick(occ_window_kernel, 1, d, true, nullptr, &g, &cfg,
                        attr)
             : occ_pick(occ_sharded_kernel, n, d, true, nullptr, &g, &cfg,
                        attr);
  if (rc != 0) return rc;
  int32_t* o = (int32_t*)out;
  o[0] = g.c;
  o[1] = g.lpc;
  o[2] = g.nslot;
  o[3] = g.nstage;
  o[4] = g.smem;
  o[5] = g.sweep_shared;
  return 0;
}
