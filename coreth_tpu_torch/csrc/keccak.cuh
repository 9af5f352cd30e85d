// Keccak-256 (K3) as CUDA device functions for Hopper (sm_90a).
//
// Replaces the reference's batched jnp keccak
//   coreth_tpu/ops/keccak.py:133 keccak_f1600 and :186 keccak256_blocks.
// The reference holds each 64-bit lane as a (lo, hi) uint32 pair because
// the TPU has no 64-bit integer datapath; here lanes are native uint64_t
// (the rotates compile to funnel shifts), the 24 rounds are unrolled,
// and the state stays in registers.  The round constants and rho/pi
// schedule are the standard Keccak-f[1600] tables, equal to the ones the
// reference derives by LFSR.
//
// Callers: the step-machine kernel's SHA3 (step_machine.cu, messages of
// up to 271 bytes read straight from the lane's memory) and the
// standalone launch entry keccak256_blocks.cu (host-padded blocks, one
// thread per message), which holds the permutation against the plain
// PyTorch version (coreth_tpu_torch/ops/keccak.py).
//
// Cost: per absorbed 136-byte block, 24 rounds of about 150 64-bit
// XOR/AND/NOT/rotate operations (theta 50, rho+pi 25 rotates, chi 75,
// iota 1); the block's 17 lane XORs on top.

#pragma once

#include <cstdint>

__constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ uint64_t keccak_rotl(uint64_t x, int r) {
  return r ? (x << r) | (x >> (64 - r)) : x;
}

// The permutation over lanes st[x + 5 * y].
__device__ __forceinline__ void keccak_f1600(uint64_t st[25]) {
  // rho offsets and pi order of the in-place lane walk
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    uint64_t bc[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ keccak_rotl(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      int j = piln[i];
      uint64_t tmp = st[j];
      st[j] = keccak_rotl(t, rotc[i]);
      t = tmp;
    }
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
#pragma unroll
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
    }
    st[0] ^= kKeccakRC[round];
  }
}

// keccak-256 of len bytes at msg (any length), digest as 32 bytes.
__device__ __forceinline__ void keccak256_bytes(const uint8_t* msg, int len,
                                                uint8_t out[32]) {
  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;
  int nblocks = len / 136 + 1;
  for (int blk = 0; blk < nblocks; ++blk) {
    int base = blk * 136;
    for (int lane = 0; lane < 17; ++lane) {
      uint64_t v = 0;
      for (int k = 0; k < 8; ++k) {
        int pos = base + lane * 8 + k;
        uint64_t byte = pos < len ? msg[pos] : 0;
        if (pos == len) byte ^= 0x01;
        if (pos == nblocks * 136 - 1) byte ^= 0x80;
        v |= byte << (8 * k);
      }
      st[lane] ^= v;
    }
    keccak_f1600(st);
  }
  for (int k = 0; k < 32; ++k) out[k] = (uint8_t)(st[k >> 3] >> (8 * (k & 7)));
}
