// The batched EVM step machine (K5) for Hopper (sm_90a): kernel entry.
//
// Replaces the reference's jitted device program
//   coreth_tpu/evm/device/machine.py:884 build_machine
//   (:175 _build_exec, :868 pack_result),
// which stepped every lane of the batch one opcode at a time in
// lockstep, masking each op family across the batch.  Here each thread
// runs one lane to completion with a switch interpreter
// (step_machine.cuh): lanes of one contract follow the same path, so a
// warp stays near lockstep and divergence is modest.
//
// Bound: neither bytes nor arithmetic, at the batch sizes replay sees.
// The inputs (code rows, calldata, storage seeds) are read once and the
// packed rows written once, but a tx batch of 256 lanes is 8 warps on a
// 132-SM card; each lane zeroes its arena and fills its row before the
// first step, and every step reaches the lane's stack and memory in
// device memory.  The wrapper
// (coreth_tpu_torch/evm/device/machine.py run_machine) allocates the
// arena and the outputs; the kernel allocates nothing.
//
// Outputs: packed (B, width) int32 rows in the reference layout, and
// steps (B,) int32, the steps each lane executed (for the roofline).

#include <cuda_runtime.h>

#include "step_machine.cuh"

namespace {

__global__ void step_machine_kernel(MachineIn in, MachineDims d,
                                    int32_t* packed, int32_t* steps,
                                    uint8_t* arena) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.B) return;
  steps[i] = sm_run_lane(in, d, i, packed + (size_t)i * d.width,
                         arena + (size_t)i * d.arena_w, false);
}

}  // namespace

// dims: host int32[18] = B, stack_cap, mem_cap, code_cap, data_cap, S,
// TC, LC, LD, keccak_cap, copy_cap, max_steps, refunds, timestamp,
// number, gaslimit, width, arena_w.
extern "C" int step_machine_launch(
    const void* code, const void* jdest, const void* code_len,
    const void* calldata, const void* data_len, const void* start_gas,
    const void* active, const void* skey, const void* sval,
    const void* sorig, const void* sflag, const void* scnt,
    const void* callvalue, const void* caller, const void* address,
    const void* origin, const void* gasprice, const void* env,
    const void* tables, const void* dims, void* packed, void* steps,
    void* arena, void* stream) {
  const int32_t* dm = (const int32_t*)dims;
  MachineDims d;
  int* f = &d.B;
  for (int k = 0; k < 18; ++k) f[k] = dm[k];
  if (d.B <= 0) return 0;
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
  in.env = (const int32_t*)env;
  in.tables = (const int32_t*)tables;
  const int threads = 32;  // one warp per block: B / 32 SMs busy
  const int blocks = (d.B + threads - 1) / threads;
  step_machine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      in, d, (int32_t*)packed, (int32_t*)steps, (uint8_t*)arena);
  return (int)cudaGetLastError();
}
