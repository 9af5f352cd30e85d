// Standalone launch entry of the 256-bit EVM ALU (K4), for Hopper
// (sm_90a): one thread per operand row applies one op of u256x.cuh.
//
// Replaces, for checking on its own, the reference's
//   coreth_tpu/ops/u256x.py (the ALU the step machine calls; the device
//   functions themselves run inside step_machine.cuh and spec_lane.cuh).
// Operands and results are (n, 16) int32 rows of 16-bit limbs, the
// reference's layout; op codes follow OPS in coreth_tpu_torch/ops/
// u256x.py.  A row's words stay in registers (no stack frame).  Each
// op reads only its operands: c for ADDMOD and MULMOD alone, a alone
// for NOT and the bit length.  Bound: bytes (the operand rows read,
// one written) for every op but EXP, whose squarings and multiplies
// on a random exponent weigh more.

#include <cuda_runtime.h>

#include "u256x.cuh"

namespace {

__global__ void u256x_eval_kernel(int op, const int32_t* a, const int32_t* b,
                                  const int32_t* c, int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u256 x = u256_from_limbs(a + 16 * i);
  const u256 y = op == 20 || op == 21 ? u256_zero()
                                      : u256_from_limbs(b + 16 * i);
  const u256 z = op == 7 || op == 8 ? u256_from_limbs(c + 16 * i)
                                    : u256_zero();
  u256 r = u256_zero();
  uint32_t wide[16];
  switch (op) {
    case 0: r = u256_add(x, y); break;
    case 1: r = u256_sub(x, y); break;
    case 2: r = u256_mul(x, y); break;
    case 3: r = u256_divmod_op(0x04, x, y); break;
    case 4: r = u256_divmod_op(0x06, x, y); break;
    case 5: r = u256_divmod_op(0x05, x, y); break;
    case 6: r = u256_divmod_op(0x07, x, y); break;
    case 7: r = u256_modop(false, x, y, z); break;
    case 8: r = u256_modop(true, x, y, z); break;
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
#pragma unroll
      for (int k = 0; k < 8; ++k) r.w[k] = op == 23 ? wide[k + 8] : wide[k];
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
  const int threads = 64;
  const int blocks = (n + threads - 1) / threads;
  u256x_eval_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      op, (const int32_t*)a, (const int32_t*)b, (const int32_t*)c,
      (int32_t*)out, n);
  return (int)cudaGetLastError();
}
