// Standalone launch entry of the 256-bit EVM ALU (K4), for Hopper
// (sm_90a): one thread per operand row applies one op of u256x.cuh.
//
// Replaces, for checking on its own, the reference's
//   coreth_tpu/ops/u256x.py (the ALU the step machine calls; the device
//   functions themselves run inside step_machine.cu).
// Operands and results are (n, 16) int32 rows of 16-bit limbs, the
// reference's layout; op codes follow OPS in coreth_tpu_torch/ops/
// u256x.py.  Bound: integer operations for DIV/MOD/ADDMOD/MULMOD/EXP
// (bit-serial loops), bytes for the rest.

#include <cuda_runtime.h>

#include "u256x.cuh"

namespace {

__global__ void u256x_eval_kernel(int op, const int32_t* a, const int32_t* b,
                                  const int32_t* c, int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u256 x = u256_from_limbs(a + 16 * i);
  const u256 y = u256_from_limbs(b + 16 * i);
  const u256 z = u256_from_limbs(c + 16 * i);
  u256 r = u256_zero(), q;
  uint32_t wide[16];
  switch (op) {
    case 0: r = u256_add(x, y); break;
    case 1: r = u256_sub(x, y); break;
    case 2: r = u256_mul(x, y); break;
    case 3: u256_divmod(x, y, &r, &q); break;
    case 4: u256_divmod(x, y, &q, &r); break;
    case 5: r = u256_sdiv(x, y); break;
    case 6: r = u256_smod(x, y); break;
    case 7: r = u256_addmod(x, y, z); break;
    case 8: r = u256_mulmod(x, y, z); break;
    case 9: r = u256_exp(x, y); break;
    case 10: r = u256_shl(y, x); break;
    case 11: r = u256_shr(y, x); break;
    case 12: r = u256_sar(y, x); break;
    case 13: r = u256_byte(x, y); break;
    case 14: r = u256_signextend(x, y); break;
    case 15: r = u256_small(u256_lt(x, y)); break;
    case 16: r = u256_small(u256_lt(y, x)); break;
    case 17: r = u256_small(u256_slt(x, y)); break;
    case 18: r = u256_small(u256_slt(y, x)); break;
    case 19: r = u256_small(u256_eq(x, y)); break;
    case 20: r = u256_not(x); break;
    case 21: r = u256_small((uint32_t)u256_bit_length(x)); break;
    case 22:
    case 23:
      u256_mul_wide(x, y, wide);
      for (int k = 0; k < 8; ++k) r.w[k] = wide[k + (op == 23 ? 8 : 0)];
      break;
    default: break;
  }
  u256_to_limbs(r, out + 16 * i);
}

}  // namespace

extern "C" int u256x_eval_launch(int op, const void* a, const void* b,
                                 const void* c, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  u256x_eval_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      op, (const int32_t*)a, (const int32_t*)b, (const int32_t*)c,
      (int32_t*)out, n);
  return (int)cudaGetLastError();
}
