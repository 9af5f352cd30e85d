// The batched EVM step machine (K5) for Hopper (sm_90a): kernel entry.
//
// Replaces the reference's jitted device program
//   coreth_tpu/evm/device/machine.py:884 build_machine
//   (:175 _build_exec, :868 pack_result),
// which stepped every lane of the batch one opcode at a time in
// lockstep, masking each op family across the batch.  Here each lane
// thread runs one lane to completion with a switch interpreter
// (step_machine.cuh sm_run_lane, the lane interpreter of K6's fused
// window too): lanes of one contract follow the same path, so a warp
// stays near lockstep and divergence is modest.
//
// Design: lanes are spread as K6's group spreads them, one a warp.  A CTA
// takes lpc lanes (kLanes, fewer when the batch is smaller or fewer
// slots fit the card's shared memory), so the grid is ceil(B / lpc)
// CTAs: a 256-lane batch runs on 64 SMs.  The CTA's threads first seed
// its lanes' packed rows together (the storage cache copied in, the log
// pool cleared: neighbouring threads on neighbouring words), then each
// slot thread runs its lane with the stack, memory and transient cache
// in a slot of the CTA's dynamic shared memory (step_machine.cuh
// sm_lane_stride / sm_lane_slot, K6's slots: an odd word count apart,
// lanes spread over the warps).  A lane whose arena does not fit a CTA's
// shared memory runs the same kernel with its arena in device memory
// (layout 0, which the wrapper allocates); step_machine_group says which
// layout a shape takes.  The block's env words (coinbase, chain id, base
// fee) are copied into shared memory by the CTA; the op tables, the env
// words and the dims come from the wrapper as they are (no per-launch
// stacking).
//
// Bound: neither bytes nor arithmetic, at the batch sizes replay sees.
// The inputs (code rows, calldata, storage seeds) are read once and the
// packed rows written once; a lane is a latency-bound chain (fetch,
// dispatch, stack in shared memory) on one thread.
//
// Outputs: packed (B, width) int32 rows in the reference layout, and
// steps (B,) int32, the steps each lane executed (for the roofline).

#include <cuda_runtime.h>

#include "step_machine.cuh"

namespace {

// lanes a CTA, one a warp: lanes that take different paths never share
// a warp, and a 256-lane batch spreads over 64 SMs
constexpr int kLanes = 4;
constexpr int kThreads = 32 * kLanes;

struct EnvWords {
  const int32_t *coinbase, *chainid, *basefee;  // 16 limbs each
};

struct Group {
  int lpc, ctas, smem, layout;  // lanes a CTA, CTAs, bytes, 1: shared slots
};

__global__ void __launch_bounds__(kThreads)
    step_machine_kernel(MachineIn in, MachineDims d, EnvWords env,
                        int32_t* packed, int32_t* steps, uint8_t* arena,
                        int lpc, int shared_slots) {
  extern __shared__ __align__(16) uint8_t sm_smem[];
  __shared__ int32_t env_w[48];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lo = blockIdx.x * lpc;
  const int nl = (lo + lpc < d.B ? lo + lpc : d.B) - lo;
  for (int e = tid; e < 48; e += nt)
    env_w[e] = e < 16 ? env.coinbase[e]
                      : (e < 32 ? env.chainid[e - 16] : env.basefee[e - 32]);
  in.env = env_w;
  for (int li = 0; li < nl; ++li)
    sm_seed_row(in, d, lo + li, packed + (size_t)(lo + li) * d.width, tid,
                nt);
  __syncthreads();
  const int slot = sm_lane_slot(tid, nt);
  const int nslot = lpc < nt ? lpc : nt;
  if (slot >= nslot) return;
  const int lstride = sm_lane_stride(d.arena_w);
  for (int li = slot; li < nl; li += nslot) {
    const int i = lo + li;
    uint8_t* lane_mem = shared_slots ? sm_smem + (size_t)slot * lstride
                                     : arena + (size_t)i * d.arena_w;
    steps[i] = sm_run_lane(in, d, i, packed + (size_t)i * d.width, lane_mem);
  }
}

void dims_of(const void* dims, MachineDims* d) {
  const int32_t* dm = (const int32_t*)dims;
  int* f = &d->B;
  for (int k = 0; k < 18; ++k) f[k] = dm[k];
}

// The group of a batch: lpc lanes a CTA, each in a shared-memory slot
// when one fits the card's opt-in shared memory a block (layout 1), else
// with its arena in device memory (layout 0).
int group_of(const MachineDims& d, Group* g) {
  int dev = 0, avail = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &avail, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  avail -= 1024;  // the kernel's static shared memory, with room
  const int lstride = sm_lane_stride(d.arena_w);
  const int fit = avail / lstride;
  g->lpc = kLanes < d.B ? kLanes : (d.B > 0 ? d.B : 1);
  g->layout = fit >= 1 ? 1 : 0;
  if (g->layout && fit < g->lpc) g->lpc = fit;
  g->ctas = (d.B + g->lpc - 1) / g->lpc;
  g->smem = g->layout ? g->lpc * lstride : 0;
  return 0;
}

}  // namespace

// The group a batch of ``dims`` (as step_machine_launch takes them)
// runs on: out int32[4] = lanes a CTA, CTAs, dynamic shared memory a CTA,
// layout (1: lane slots in shared memory, 0: arenas in device memory).
// Returns a cudaError.
extern "C" int step_machine_group(const void* dims, void* out) {
  MachineDims d;
  dims_of(dims, &d);
  Group g;
  const int rc = group_of(d, &g);
  int32_t* o = (int32_t*)out;
  o[0] = g.lpc;
  o[1] = g.ctas;
  o[2] = g.smem;
  o[3] = g.layout;
  return rc;
}

// dims: host int32[18] = B, stack_cap, mem_cap, code_cap, data_cap, S,
// TC, LC, LD, keccak_cap, copy_cap, max_steps, refunds, timestamp,
// number, gaslimit, width, arena_w.  coinbase / chainid / basefee: the
// block's env words (16 limbs each); tables (4, 256): const gas, nin,
// nout, supported.  ``arena`` (B, arena_w) bytes is read only in layout
// 0.  Returns 0, -3 when ``layout`` is not the one step_machine_group
// gives, else a cudaError.
extern "C" int step_machine_launch(
    const void* code, const void* jdest, const void* code_len,
    const void* calldata, const void* data_len, const void* start_gas,
    const void* active, const void* skey, const void* sval,
    const void* sorig, const void* sflag, const void* scnt,
    const void* callvalue, const void* caller, const void* address,
    const void* origin, const void* gasprice, const void* coinbase,
    const void* chainid, const void* basefee, const void* tables,
    const void* dims, int layout, void* packed, void* steps, void* arena,
    void* stream) {
  MachineDims d;
  dims_of(dims, &d);
  if (d.B <= 0) return 0;
  Group g;
  int rc = group_of(d, &g);
  if (rc != 0) return rc;
  if (layout != g.layout) return -3;
  MachineIn in;
  in.code = (const int32_t*)code;
  in.jdest = (const int32_t*)jdest;
  in.code_len = (const int32_t*)code_len;
  in.calldata = (const int32_t*)calldata;
  in.data_len = (const int32_t*)data_len;
  in.start_gas = (const int32_t*)start_gas;
  in.active = (const int32_t*)active;
  in.skey = (const int32_t*)skey;
  in.sval = (const int32_t*)sval;
  in.sorig = (const int32_t*)sorig;
  in.sflag = (const int32_t*)sflag;
  in.scnt = (const int32_t*)scnt;
  in.callvalue = (const int32_t*)callvalue;
  in.caller = (const int32_t*)caller;
  in.address = (const int32_t*)address;
  in.origin = (const int32_t*)origin;
  in.gasprice = (const int32_t*)gasprice;
  in.env = nullptr;  // the kernel's shared copy of the env words
  in.tables = (const int32_t*)tables;
  const EnvWords env{(const int32_t*)coinbase, (const int32_t*)chainid,
                     (const int32_t*)basefee};
  cudaError_t err = cudaSuccess;
  if (g.smem > 48 * 1024)  // past the default a block may take
    err = cudaFuncSetAttribute(step_machine_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, step_machine_kernel, in, d, env,
                           (int32_t*)packed, (int32_t*)steps,
                           (uint8_t*)arena, g.lpc, g.layout);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
