// Standalone launch entry of batched keccak-256 (K3), for Hopper
// (sm_90a): two threads per host-padded message.
//
// Replaces the reference's jitted device program
//   coreth_tpu/ops/keccak.py:186 keccak256_blocks (:133 keccak_f1600).
// Input blocks (B, nb, 34) uint32 words with pad10*1 already applied,
// nblocks (B,) real block counts; output (B, 8) uint32 digest words.
// One thread a message would be 128 warps for 4096 messages: one on
// each of 128 of the card's 528 schedulers, each bound by its 16-lane
// integer pipe (a round is ~200 LOP3/SHF).  Here the two threads of a
// pair each hold one 32-bit half (lo or hi) of every lane, as the
// reference holds (lo, hi) pairs: theta and chi run on half the words,
// and each 64-bit rotation takes the partner's half by one shuffle (29 a
// round).  The rounds run as a loop unrolled by 4, in CTAs of 32
// threads (kBlock): 4096 messages are 256 CTAs over the SMs.
// Bound: operations (24 rounds of ~155 64-bit ops per absorbed block
// against 136 bytes read).

#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlock = 32;

// this thread's half (lo or hi word) of a lane rotated left by R, from
// its own half and the partner's (the other half of the same lane)
template <int R>
__device__ __forceinline__ uint32_t pair_rotl(uint32_t own, uint32_t other) {
  if constexpr (R == 0)
    return own;
  else if constexpr (R < 32)
    return keccak_fshl(other, own, R);
  else if constexpr (R == 32)
    return other;
  else
    return keccak_fshl(own, other, R - 32);
}

// the partner's value of v (the thread beside it in its pair)
__device__ __forceinline__ uint32_t partner(uint32_t v, int h) {
  return __shfl_sync(kFull, v, h ^ 1, 2);
}

// One round on this thread's halves a[x + 5 y] of the 25 lanes (h: 0
// the low words, 1 the high), the pair's other thread holding the rest;
// rc this half's round constant.  Every rotation takes the partner's
// half through one shuffle (5 for theta, 24 for rho), the rest is the
// one-thread round on half the words.
__device__ __forceinline__ void pair_round(uint32_t* a, int h, uint32_t rc) {
  uint32_t c[5], oc[5];
#pragma unroll
  for (int x = 0; x < 5; ++x)
    c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
  for (int x = 0; x < 5; ++x) oc[x] = partner(c[x], h);
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    const uint32_t d = c[(x + 4) % 5] ^ pair_rotl<1>(c[(x + 1) % 5],
                                                      oc[(x + 1) % 5]);
#pragma unroll
    for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
  }
  uint32_t t = a[1];
#define KECCAK_PI(dst, r)                          \
  {                                                \
    const uint32_t u = a[dst];                     \
    a[dst] = pair_rotl<r>(t, partner(t, h));       \
    t = u;                                         \
  }
  KECCAK_PI(10, 1);
  KECCAK_PI(7, 3);
  KECCAK_PI(11, 6);
  KECCAK_PI(17, 10);
  KECCAK_PI(18, 15);
  KECCAK_PI(3, 21);
  KECCAK_PI(5, 28);
  KECCAK_PI(16, 36);
  KECCAK_PI(8, 45);
  KECCAK_PI(21, 55);
  KECCAK_PI(24, 2);
  KECCAK_PI(4, 14);
  KECCAK_PI(15, 27);
  KECCAK_PI(23, 41);
  KECCAK_PI(19, 56);
  KECCAK_PI(13, 8);
  KECCAK_PI(12, 25);
  KECCAK_PI(2, 43);
  KECCAK_PI(20, 62);
  KECCAK_PI(14, 18);
  KECCAK_PI(22, 39);
  KECCAK_PI(9, 61);
  KECCAK_PI(6, 20);
  KECCAK_PI(1, 44);
#undef KECCAK_PI
#pragma unroll
  for (int y = 0; y < 25; y += 5) {
    uint32_t r[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) r[x] = a[x + y];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      a[x + y] = r[x] ^ (~r[(x + 1) % 5] & r[(x + 2) % 5]);
  }
  a[0] ^= rc;
}

// Two threads a message: thread 2i + h holds the half h of message i's
// lanes.  A warp's threads all run its longest message's blocks, so its
// shuffles are warp-wide: a thread past its message's blocks absorbs
// nothing and keeps the digest words it took after its last block.
__global__ void __launch_bounds__(kBlock)
    keccak256_blocks_kernel(const uint32_t* blocks, const int32_t* nblocks,
                            uint32_t* out, int n, int nb) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = g >> 1, h = g & 1;
  const int count = i < n ? (nblocks[i] < nb ? nblocks[i] : nb) : 0;
  int most = 0;
  while (__any_sync(kFull, count > most)) ++most;
  uint32_t a[25], dg[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 25; ++k) a[k] = 0;
  const uint32_t* w = blocks + (size_t)(i < n ? i : 0) * nb * 34 + h;
  for (int blk = 0; blk < most; ++blk) {
    if (blk < count) {
#pragma unroll
      for (int k = 0; k < 17; ++k) a[k] ^= w[blk * 34 + 2 * k];
    }
#pragma unroll 4
    for (int r = 0; r < 24; ++r)
      pair_round(a, h, h ? kKeccakRCHi[r] : kKeccakRCLo[r]);
    if (blk == count - 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dg[k] = a[k];
    }
  }
  if (i < n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[8 * (size_t)i + 2 * k + h] = dg[k];
  }
}

}  // namespace

extern "C" int keccak256_blocks_launch(const void* blocks,
                                       const void* nblocks, void* out, int n,
                                       int nb, void* stream) {
  if (n <= 0) return 0;
  const int threads = 2 * n;
  const int blocks_n = (threads + kBlock - 1) / kBlock;
  keccak256_blocks_kernel<<<blocks_n, kBlock, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const int32_t*)nblocks, (uint32_t*)out, n,
      nb);
  return (int)cudaGetLastError();
}
