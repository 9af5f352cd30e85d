// Standalone launch entry of batched keccak-256 (K3), for Hopper
// (sm_90a): one thread per host-padded message.
//
// Replaces the reference's jitted device program
//   coreth_tpu/ops/keccak.py:186 keccak256_blocks (:133 keccak_f1600).
// Input blocks (B, nb, 34) uint32 words with pad10*1 already applied,
// nblocks (B,) real block counts; output (B, 8) uint32 digest words.
// The permutation is keccak.cuh's, on native 64-bit lanes in registers.
// Bound: operations (24 rounds of ~150 64-bit ops per absorbed block
// against 136 bytes read).

#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

__global__ void keccak256_blocks_kernel(const uint32_t* blocks,
                                        const int32_t* nblocks,
                                        uint32_t* out, int n, int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = 0;
  const uint32_t* w = blocks + (size_t)i * nb * 34;
  const int count = nblocks[i] < nb ? nblocks[i] : nb;
  for (int blk = 0; blk < count; ++blk) {
#pragma unroll
    for (int lane = 0; lane < 17; ++lane)
      st[lane] ^= (uint64_t)w[blk * 34 + 2 * lane] |
                  ((uint64_t)w[blk * 34 + 2 * lane + 1] << 32);
    keccak_f1600(st);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[8 * i + 2 * k] = (uint32_t)st[k];
    out[8 * i + 2 * k + 1] = (uint32_t)(st[k] >> 32);
  }
}

}  // namespace

extern "C" int keccak256_blocks_launch(const void* blocks,
                                       const void* nblocks, void* out, int n,
                                       int nb, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks_n = (n + threads - 1) / threads;
  keccak256_blocks_kernel<<<blocks_n, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const int32_t*)nblocks, (uint32_t*)out, n,
      nb);
  return (int)cudaGetLastError();
}
