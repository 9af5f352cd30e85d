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
// Design: one launch per window attempt, one CTA per window.  The W
// blocks are sequential (block w's base table is block w-1's result), so
// the CTA walks them in a loop; lanes are strided over the CTA's
// threads.  Per round:
//   exec   — every thread runs its pending lanes to completion, writing
//            straight into the lane's row of the window's packed output,
//            so rows of lanes that are not pending keep their last
//            result.  A lane with prog_id < 0 runs K5's lane interpreter
//            (step_machine.cuh sm_run_lane, with K4 u256x.cuh and K3
//            keccak.cuh inside); a lane with prog_id = k runs traced
//            program k (K7) through spec_dispatch.  The generic build
//            (this file alone) has no program; the specialised build is
//            a generated translation unit that defines OCC_SPEC, the
//            programs and spec_dispatch (coreth_tpu_torch/evm/device/
//            specialize.py cuda_source) and then includes this file;
//   sweep  — warp 0 validates the lanes one at a time in tx order, a
//            lane's cache entries across the warp's threads: the exact
//            sequential sweep of the reference (its disjoint fast path
//            is an equal shortcut, so the kernel does not take it).
// The sweep restarts from the block-start table every round, so the
// valid writes of round r go to a per-row overlay (values + the stamp of
// the sweep that wrote them) instead of the table; when a block's loop
// ends, the writes of its final sweep are copied into the table.
//
// Bound: the reference's exec and sweep are both latency-bound chains
// here.  A whole window runs on one of the card's 132 SMs (a cooperative
// grid is later work), the sweep is B dependent steps per round on one
// warp, and every interpreter step reaches the lane's stack and memory in
// device memory.  The bytes (inputs read once, table and packed rows
// written once) and the integer operations (lane-steps x
// machine.OPS_PER_STEP plus the sweep's entry compares) are both far
// below what the launch takes.  The wrapper
// (coreth_tpu_torch/evm/device/machine.py run_occ_window) allocates the
// outputs, the lane arena and every scratch buffer; the kernel allocates
// nothing.
//
// Outputs: table (G, 16) int32 updated in place (the wrapper passes a
// copy of the input table), packed (W, B, width + 4) int32 rows in the
// reference layout with the committed / escape / pending / rounds
// columns, and steps (W, B) int32, the lane-steps each lane executed
// over all rounds (a traced lane counts its leaf's traced steps), for
// the roofline.
//
// The sharded window (K9) and its flags reduce (K9x), for a mesh engine.
//
// Replace the reference's jitted device programs
//   coreth_tpu/evm/device/shard.py:151 build_sharded_occ_machine
//   (:197 run_kr, its key-range variant) and :267 get_shard_exchange.
// K9 runs the per-block body of K6 (occ_block) once per shard: shard d is
// CTA d of one thread-block cluster of n (n <= 8, the portable cluster
// size), over lanes [d*B, (d+1)*B) of every block row (the lane tensors
// are n*B wide, so a block row's stride is n*B) and over table rows
// [d*G, (d+1)*G) (the tables are shard-major); its lane scratch and its
// overlay are its own slices of the wrapper's buffers.  Without a sync
// set the shards never talk.  With one (the key-range variant: X keys
// with copies on several shards, sync_rows (X, n + 1) = the key's local
// row on each shard, G where it has none, then its owner shard), the
// window first gives every copy its owner's value, and after each block
// every shard offers the copies its block changed: the writer is elected
// by a max over the shards' (d + 1) candidates and its value broadcast by
// an add over their contributions, the reference's two collectives,
// summed in shard order (integer adds and maxes: on one card the mode's
// order cannot be observed, so both modes run the same code).  A shard's
// offers travel through global slabs the wrapper allocates,
// double-buffered by block parity, between cluster
// barriers (release/acquire at cluster scope), read through L2 as in
// K8 (sharded_window.cu).  K9x reduces each shard's per-block (all active
// lanes committed, any escape or pending) flags into (W, 2) int32.
//
// Bound of K9: K6's, over the union of the shards' lanes and arenas; the
// copies' sync is no necessary work on one card.

#include <cuda_runtime.h>

#include "step_machine.cuh"

// The cluster entries (K9, K9x) use the CUDA runtime's cluster launch; a
// plain C++ host build of K6 leaves them out, a host build of K9 defines
// OCC_HOST_CLUSTER and shims them.
#if defined(__CUDACC__) || defined(OCC_HOST_CLUSTER)
#define OCC_CLUSTER 1
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
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

namespace {

constexpr int kMaxThreads = 256;
constexpr int kKdigCap = 8;  // specialize.KDIG_CAP digest slots per lane
constexpr int kMaxShards = 8;  // the portable cluster size

struct OccDims {
  int W, G, R;
  int LS;  // lanes of one block row of the lane tensors (B; n*B sharded)
  int l0;  // this CTA's first lane of a block row (0; d*B sharded)
};

struct OccBuf {
  const int32_t *sgid, *active, *prog_id, *kdig, *env, *scal, *key_tab;
  int32_t *table, *packed, *steps, *skey0, *seeds, *sflag0, *lanes, *ov,
      *stamp;
  uint8_t* arena;
};

__device__ __forceinline__ bool premapped(int g, int G) {
  return (unsigned)g < (unsigned)G;
}

// Warp 0's sequential validation sweep of one round over the B lanes of
// a block (reference occ_body's val_body, :1109-1129).  Returns, on
// every thread of the warp, whether another round is needed (some lane
// pending, none escaping).
__device__ bool occ_sweep(const MachineDims& d, const OccDims& o,
                          const OccBuf& b, const int32_t* sgid,
                          const int32_t* active0, int32_t* pk, int sweep,
                          int32_t* cur_sh) {
  const int B = d.B, S = d.S, G = o.G, PW = d.width + 4;
  const int O_SFLAG = 5, O_SVAL = O_SFLAG + S + 16 * S,
            O_SORIG = O_SVAL + 16 * S;
  const int lane = threadIdx.x;
  int32_t* pend = b.lanes + B;
  int32_t* okv = b.lanes + 2 * B;
  int32_t* esc = b.lanes + 3 * B;
  bool any_pend = false, any_esc = false;
  for (int j = 0; j < B; ++j) {
    const int32_t* row = pk + (size_t)j * PW;
    const int status = row[0], scnt = row[4];
    const bool skip = status == SM_SKIP;
    bool miss = false, bad = false;
    // cur: the prefix state at lane j's rows, before its own writes
    for (int e = lane; e < S; e += 32) {
      const int flag = row[O_SFLAG + e];
      const int g = sgid[j * S + e];
      const bool ent = e < scnt, pm = premapped(g, G);
      miss |= ent && (flag & F_MISS);
      const bool rf = ent && (flag & F_READ) && pm;
      const int32_t* src =
          pm ? (b.stamp[g] == sweep ? b.ov : b.table) + (size_t)g * 16
             : nullptr;
      for (int k = 0; k < 16; ++k) {
        const int32_t c = src ? src[k] : 0;
        cur_sh[e * 16 + k] = c;
        bad |= rf && row[O_SORIG + e * 16 + k] != c;
      }
    }
    const bool any_miss = __any_sync(0xffffffffu, miss);
    const bool reads_ok = !__any_sync(0xffffffffu, bad);
    const bool hosty = status == SM_HOST || any_miss;
    const bool valid = !skip && !hosty && reads_ok;
    const bool repend = !skip && !hosty && !reads_ok;
    for (int e = lane; e < S; e += 32) {
      if (valid && status == SM_STOP) {
        const int g = sgid[j * S + e];
        if (e < scnt && (row[O_SFLAG + e] & F_WRITTEN) && premapped(g, G)) {
          for (int k = 0; k < 16; ++k)
            b.ov[(size_t)g * 16 + k] = row[O_SVAL + e * 16 + k];
          b.stamp[g] = sweep;
        }
      }
      if (repend)
        for (int k = 0; k < 16; ++k)
          b.seeds[((size_t)j * S + e) * 16 + k] = cur_sh[e * 16 + k];
    }
    const bool e_j = hosty && active0[j] != 0;
    if (lane == 0) {
      okv[j] = valid;
      pend[j] = repend;
      esc[j] = e_j;
    }
    any_pend |= repend;
    any_esc |= e_j;
    __syncwarp();
  }
  return any_pend && !any_esc;
}

// Block w of a window: the Block-STM round loop over the B lanes
// [l0, l0 + B) of its block row, against the table rows of ``b``.
// ``sweep`` numbers the sweeps of the window (the overlay's stamps).
__device__ void occ_block(const MachineIn& in, const MachineDims& d,
                          const OccDims& o, const OccBuf& b, int w,
                          int& sweep, int32_t* cur_sh, int* s_go) {
  const int B = d.B, S = d.S, G = o.G, PW = d.width + 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t CW = (size_t)d.code_cap + 33;
  int32_t* nkeys = b.lanes;
  int32_t* pend = b.lanes + B;
  int32_t* okv = b.lanes + 2 * B;
  int32_t* esc = b.lanes + 3 * B;
  const size_t wb = (size_t)w * o.LS + o.l0;
  const int32_t* sgid = b.sgid + wb * S;
  const int32_t* active0 = b.active + wb;
  int32_t* pk = b.packed + wb * PW;
  // block w's exec inputs: its lane rows, its block words, and the
  // lanes' storage caches seeded from the table
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
  bi.env = b.env + (size_t)w * 48;
  bi.active = pend;
  bi.skey = b.skey0;
  bi.sval = b.seeds;
  bi.sorig = b.seeds;
  bi.sflag = b.sflag0;
  bi.scnt = nkeys;
  MachineDims bd = d;
  bd.timestamp = b.scal[w];
  bd.number = b.scal[o.W + w];
  bd.gaslimit = b.scal[2 * o.W + w];

  int act = 0;
  for (int i = tid; i < B; i += nt) {
    int nk = 0;
    for (int e = 0; e < S; ++e) {
      const int g = sgid[i * S + e];
      const bool pm = premapped(g, G);
      nk += pm;
      b.sflag0[i * S + e] = pm ? F_VALID : 0;
      const size_t at = ((size_t)i * S + e) * 16;
      for (int k = 0; k < 16; ++k) {
        b.skey0[at + k] = pm ? b.key_tab[(size_t)g * 16 + k] : 0;
        b.seeds[at + k] = pm ? b.table[(size_t)g * 16 + k] : 0;
      }
    }
    nkeys[i] = nk;
    pend[i] = active0[i] != 0;
    act |= pend[i];
    okv[i] = 0;
    esc[i] = 0;
    b.steps[wb + i] = 0;
    int32_t* row = pk + (size_t)i * PW;
    row[0] = SM_SKIP;
    for (int k = 1; k < PW; ++k) row[k] = 0;
  }
  bool go = __syncthreads_or(act) != 0;
  int rnd = 0;
  while (go) {
    for (int i = tid; i < B; i += nt) {
      if (!pend[i]) continue;
      const int pid = b.prog_id[wb + i];
      int32_t* row = pk + (size_t)i * PW;
      b.steps[wb + i] +=
          pid < 0 ? sm_run_lane(bi, bd, i, row,
                                b.arena + (size_t)i * d.arena_w)
                  : spec_dispatch(pid, bi, bd, i, row,
                                  b.kdig + (wb + i) * kKdigCap * 16);
    }
    __syncthreads();
    ++sweep;
    if (tid < 32) {
      const bool more = occ_sweep(d, o, b, sgid, active0, pk, sweep, cur_sh);
      if (tid == 0) *s_go = more;
    }
    __syncthreads();
    ++rnd;
    go = *s_go && rnd < o.R;
  }
  // the trailing columns, and the final sweep's writes into the table
  // (every writer of a row copies the same overlay value)
  for (int i = tid; i < B; i += nt) {
    int32_t* row = pk + (size_t)i * PW;
    row[d.width] = okv[i];
    row[d.width + 1] = esc[i];
    row[d.width + 2] = pend[i];
    row[d.width + 3] = rnd;
    if (okv[i] && row[0] == SM_STOP) {
      const int scnt = row[4];
      for (int e = 0; e < S && e < scnt; ++e) {
        const int g = sgid[i * S + e];
        if ((row[5 + e] & F_WRITTEN) && premapped(g, G))
          for (int k = 0; k < 16; ++k)
            b.table[(size_t)g * 16 + k] = b.ov[(size_t)g * 16 + k];
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
    occ_window_kernel(MachineIn in, MachineDims d, OccDims o, OccBuf b) {
  extern __shared__ int32_t cur_sh[];  // (S, 16): the sweep's prefix rows
  __shared__ int s_go;
  int sweep = 0;
  for (int w = 0; w < o.W; ++w) occ_block(in, d, o, b, w, sweep, cur_sh, &s_go);
}

#ifdef OCC_CLUSTER
// The key-range sync's inputs and slabs: rows (X, n + 1) int32; pre
// (n, X, 16) each shard's copies before the block; xc (2, n, X) the
// shards' writer candidates and xv (2, n, X, 16) their contributions,
// by block parity.
struct OccXchg {
  int X;
  const int32_t* rows;
  int32_t *pre, *xc, *xv;
};

// K9: one cluster of n CTAs per window, CTA d = shard d.
__global__ void __launch_bounds__(kMaxThreads)
    occ_sharded_kernel(MachineIn in, MachineDims d, OccDims o, OccBuf b,
                       OccXchg x) {
  extern __shared__ int32_t cur_sh[];  // (S, 16): the sweep's prefix rows
  __shared__ int s_go;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const int B = d.B, S = d.S, G = o.G, X = x.X;
  const int tid = threadIdx.x, nt = blockDim.x;
  // this shard's lanes of every block row, its arena and its scratch
  o.l0 = s * B;
  o.LS = n * B;
  b.table += (size_t)s * G * 16;
  b.key_tab += (size_t)s * G * 16;
  b.ov += (size_t)s * G * 16;
  b.stamp += (size_t)s * G;
  b.arena += (size_t)s * B * d.arena_w;
  b.skey0 += (size_t)s * B * S * 16;
  b.seeds += (size_t)s * B * S * 16;
  b.sflag0 += (size_t)s * B * S;
  b.lanes += (size_t)s * 4 * B;
  int sweep = 0;
  if (X == 0) {
    for (int w = 0; w < o.W; ++w)
      occ_block(in, d, o, b, w, sweep, cur_sh, &s_go);
    return;
  }
  const int R1 = n + 1;
  int32_t* pre = x.pre + (size_t)s * X * 16;
  auto xc = [&](int buf, int t) { return x.xc + ((size_t)buf * n + t) * X; };
  auto xv = [&](int buf, int t) {
    return x.xv + ((size_t)buf * n + t) * X * 16;
  };
  // the window-start seed: every copy takes its owner's value (a copy
  // made while the previous window ran was seeded from the host mirror)
  for (int e = tid; e < X * 16; e += nt) {
    const int j = e / 16, k = e % 16, g = x.rows[j * R1 + s];
    const bool mine = x.rows[j * R1 + n] == s && g < G;
    __stcg(xv(1, s) + e, mine ? b.table[(size_t)g * 16 + k] : 0);
  }
  cluster.sync();
  for (int e = tid; e < X * 16; e += nt) {
    const int j = e / 16, k = e % 16, g = x.rows[j * R1 + s];
    if (g >= G) continue;
    unsigned v = 0;
    for (int t = 0; t < n; ++t) v += (unsigned)__ldcg(xv(1, t) + e);
    b.table[(size_t)g * 16 + k] = (int32_t)v;
  }
  __syncthreads();
  for (int w = 0; w < o.W; ++w) {
    const int buf = w & 1;
    for (int e = tid; e < X * 16; e += nt) {
      const int j = e / 16, k = e % 16, g = x.rows[j * R1 + s];
      pre[e] = g < G ? b.table[(size_t)g * 16 + k] : 0;
    }
    __syncthreads();
    occ_block(in, d, o, b, w, sweep, cur_sh, &s_go);
    // elect: the shard whose block changed a copy offers s + 1
    for (int j = tid; j < X; j += nt) {
      const int g = x.rows[j * R1 + s];
      bool changed = false;
      if (g < G)
        for (int k = 0; k < 16; ++k)
          changed |= b.table[(size_t)g * 16 + k] != pre[j * 16 + k];
      __stcg(xc(buf, s) + j, changed ? s + 1 : 0);
    }
    cluster.sync();
    // offer: the winner's value (it changed the copy, so it has one)
    for (int e = tid; e < X * 16; e += nt) {
      const int j = e / 16, k = e % 16;
      int win = 0;
      for (int t = 0; t < n; ++t) win = max(win, __ldcg(xc(buf, t) + j));
      const int c = __ldcg(xc(buf, s) + j);
      const int g = x.rows[j * R1 + s];
      __stcg(xv(buf, s) + e,
             c != 0 && c == win ? b.table[(size_t)g * 16 + k] : 0);
    }
    cluster.sync();
    // broadcast: every copy takes the winner's value
    for (int e = tid; e < X * 16; e += nt) {
      const int j = e / 16, k = e % 16, g = x.rows[j * R1 + s];
      if (g >= G) continue;
      int win = 0;
      for (int t = 0; t < n; ++t) win = max(win, __ldcg(xc(buf, t) + j));
      if (win == 0) continue;
      unsigned v = 0;
      for (int t = 0; t < n; ++t) v += (unsigned)__ldcg(xv(buf, t) + e);
      b.table[(size_t)g * 16 + k] = (int32_t)v;
    }
    __syncthreads();
  }
}

// K9x: block w's flags, one CTA per block: (shards whose active lanes all
// committed, shards with an active lane that escaped or is pending).
__global__ void shard_flags_kernel(const int32_t* __restrict__ packed,
                                   const int32_t* __restrict__ active,
                                   int NB, int B, int PW,
                                   int32_t* __restrict__ flags) {
  __shared__ int dirty[kMaxShards], esc[kMaxShards];
  const int n = NB / B, w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int t = tid; t < n; t += nt) dirty[t] = esc[t] = 0;
  __syncthreads();
  for (int i = tid; i < NB; i += nt) {
    if (!active[(size_t)w * NB + i]) continue;
    const int32_t* row = packed + ((size_t)w * NB + i) * PW;
    if (row[PW - 4] == 0) atomicOr(&dirty[i / B], 1);
    if (row[PW - 3] != 0 || row[PW - 2] != 0) atomicOr(&esc[i / B], 1);
  }
  __syncthreads();
  if (tid == 0) {
    // the replicated sum, in shard order
    int c = 0, e = 0;
    for (int t = 0; t < n; ++t) {
      c += !dirty[t];
      e += esc[t];
    }
    flags[2 * w] = c;
    flags[2 * w + 1] = e;
  }
}
#endif  // OCC_CLUSTER

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
      void *steps, void *arena, void *skey0, void *seeds, void *sflag0,    \
      void *lanes, void *ov, void *stamp
#define OCC_ARGS                                                            \
  code, jdest, code_len, calldata, data_len, start_gas, active, sgid,      \
      prog_id, kdig, callvalue, caller, address, origin, gasprice, env,    \
      scal, tables, key_tab, dims, table, packed, steps, arena, skey0,     \
      seeds, sflag0, lanes, ov, stamp

namespace {

// The kernels' structs from the launch arguments; false for an empty
// window (no lane or no block).
bool occ_fill(OCC_PARAMS, MachineIn* in, MachineDims* d, OccDims* o,
              OccBuf* b) {
  const int32_t* dm = (const int32_t*)dims;
  int* f = &d->B;
  for (int k = 0; k < 18; ++k) f[k] = dm[k];
  *o = OccDims{dm[18], dm[19], dm[20], d->B, 0};
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
  b->arena = (uint8_t*)arena;
  b->skey0 = (int32_t*)skey0;
  b->seeds = (int32_t*)seeds;
  b->sflag0 = (int32_t*)sflag0;
  b->lanes = (int32_t*)lanes;
  b->ov = (int32_t*)ov;
  b->stamp = (int32_t*)stamp;
  return true;
}

int occ_threads(const MachineDims& d) {
  const int threads = (d.B + 31) / 32 * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace

// dims: host int32[21] = the 18 MachineDims fields (B, stack_cap,
// mem_cap, code_cap, data_cap, S, TC, LC, LD, keccak_cap, copy_cap,
// max_steps, refunds, timestamp, number, gaslimit, width, arena_w; the
// three block words are per block, in `scal`), then W, G, R.  prog_id
// (W, B) int32 selects each lane's traced program (-1: the interpreter),
// kdig (W, B, 8, 16) int32 holds its host-evaluated keccak digests.
extern "C" int occ_window_launch(OCC_PARAMS, void* stream) {
  MachineIn in;
  MachineDims d;
  OccDims o;
  OccBuf b;
  if (!occ_fill(OCC_ARGS, &in, &d, &o, &b)) return 0;
  const size_t shmem = (size_t)d.S * 16 * sizeof(int32_t);
  occ_window_kernel<<<1, occ_threads(d), shmem, (cudaStream_t)stream>>>(
      in, d, o, b);
  return (int)cudaGetLastError();
}

#ifdef OCC_CLUSTER
// K9: n CTAs as one cluster of n on `stream`.  The arguments are K6's
// with every lane tensor n*B wide (dims still hold the per-shard B and
// G), the tables n*G rows, and the lane scratch (arena, skey0, seeds,
// sflag0, lanes) and the overlay (ov, stamp) n times K6's; then the sync
// set: X rows of `rows` (X, n + 1) int32 and the slabs pre (n, X, 16), xc (2, n, X), xv (2, n, X, 16)
// int32 (unused when X = 0).  Returns -2 for a width past kMaxShards,
// -1 when no cluster of n such CTAs fits on the card, else the launch's
// cudaError.
extern "C" int occ_sharded_launch(int n, int X, const void* rows,
                                  void* pre, void* xc, void* xv, OCC_PARAMS,
                                  void* stream) {
  if (n < 1 || n > kMaxShards) return -2;
  MachineIn in;
  MachineDims d;
  OccDims o;
  OccBuf b;
  if (!occ_fill(OCC_ARGS, &in, &d, &o, &b)) return 0;
  OccXchg x{X, (const int32_t*)rows, (int32_t*)pre, (int32_t*)xc,
            (int32_t*)xv};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(occ_threads(d), 1, 1);
  cfg.dynamicSmemBytes = (size_t)d.S * 16 * sizeof(int32_t);
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
      &clusters, (const void*)occ_sharded_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -1;
  err = cudaLaunchKernelEx(&cfg, occ_sharded_kernel, in, d, o, b, x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K9x: packed (W, NB, PW) and active (W, NB) int32, NB = n*B lanes a
// block row; flags (W, 2) int32.  Returns -2 for NB not n*B with
// 1 <= n <= kMaxShards.
extern "C" int shard_flags_launch(const void* packed, const void* active,
                                  int W, int NB, int B, int PW,
                                  void* flags, void* stream) {
  if (B < 1 || NB % B || NB / B < 1 || NB / B > kMaxShards) return -2;
  if (W <= 0) return 0;
  shard_flags_kernel<<<W, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const int32_t*)active, NB, B, PW,
      (int32_t*)flags);
  return (int)cudaGetLastError();
}
#endif  // OCC_CLUSTER
