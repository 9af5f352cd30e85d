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

#include <cuda_runtime.h>

#include "step_machine.cuh"

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

struct OccDims {
  int W, G, R;
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

__global__ void __launch_bounds__(kMaxThreads)
    occ_window_kernel(MachineIn in, MachineDims d, OccDims o, OccBuf b) {
  extern __shared__ int32_t cur_sh[];  // (S, 16): the sweep's prefix rows
  __shared__ int s_go;
  const int B = d.B, S = d.S, G = o.G, PW = d.width + 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t CW = (size_t)d.code_cap + 33;
  int32_t* nkeys = b.lanes;
  int32_t* pend = b.lanes + B;
  int32_t* okv = b.lanes + 2 * B;
  int32_t* esc = b.lanes + 3 * B;
  int sweep = 0;
  for (int w = 0; w < o.W; ++w) {
    const size_t wb = (size_t)w * B;
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
        if (tid == 0) s_go = more;
      }
      __syncthreads();
      ++rnd;
      go = s_go && rnd < o.R;
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
}

}  // namespace

// dims: host int32[21] = the 18 MachineDims fields (B, stack_cap,
// mem_cap, code_cap, data_cap, S, TC, LC, LD, keccak_cap, copy_cap,
// max_steps, refunds, timestamp, number, gaslimit, width, arena_w; the
// three block words are per block, in `scal`), then W, G, R.  prog_id
// (W, B) int32 selects each lane's traced program (-1: the interpreter),
// kdig (W, B, 8, 16) int32 holds its host-evaluated keccak digests.
extern "C" int occ_window_launch(
    const void* code, const void* jdest, const void* code_len,
    const void* calldata, const void* data_len, const void* start_gas,
    const void* active, const void* sgid, const void* prog_id,
    const void* kdig, const void* callvalue,
    const void* caller, const void* address, const void* origin,
    const void* gasprice, const void* env, const void* scal,
    const void* tables, const void* key_tab, const void* dims, void* table,
    void* packed, void* steps, void* arena, void* skey0, void* seeds,
    void* sflag0, void* lanes, void* ov, void* stamp, void* stream) {
  const int32_t* dm = (const int32_t*)dims;
  MachineDims d;
  int* f = &d.B;
  for (int k = 0; k < 18; ++k) f[k] = dm[k];
  OccDims o{dm[18], dm[19], dm[20]};
  if (d.B <= 0 || o.W <= 0) return 0;
  MachineIn in;
  in.code = (const int32_t*)code;
  in.jdest = (const int32_t*)jdest;
  in.code_len = (const int32_t*)code_len;
  in.calldata = (const int32_t*)calldata;
  in.data_len = (const int32_t*)data_len;
  in.start_gas = (const int32_t*)start_gas;
  in.callvalue = (const int32_t*)callvalue;
  in.caller = (const int32_t*)caller;
  in.address = (const int32_t*)address;
  in.origin = (const int32_t*)origin;
  in.gasprice = (const int32_t*)gasprice;
  in.tables = (const int32_t*)tables;
  OccBuf b;
  b.sgid = (const int32_t*)sgid;
  b.active = (const int32_t*)active;
  b.prog_id = (const int32_t*)prog_id;
  b.kdig = (const int32_t*)kdig;
  b.env = (const int32_t*)env;
  b.scal = (const int32_t*)scal;
  b.key_tab = (const int32_t*)key_tab;
  b.table = (int32_t*)table;
  b.packed = (int32_t*)packed;
  b.steps = (int32_t*)steps;
  b.arena = (uint8_t*)arena;
  b.skey0 = (int32_t*)skey0;
  b.seeds = (int32_t*)seeds;
  b.sflag0 = (int32_t*)sflag0;
  b.lanes = (int32_t*)lanes;
  b.ov = (int32_t*)ov;
  b.stamp = (int32_t*)stamp;
  int threads = (d.B + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shmem = (size_t)d.S * 16 * sizeof(int32_t);
  occ_window_kernel<<<1, threads, shmem, (cudaStream_t)stream>>>(in, d, o, b);
  return (int)cudaGetLastError();
}
