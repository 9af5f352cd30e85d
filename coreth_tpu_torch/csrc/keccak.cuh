// Keccak-256 (K3) as CUDA device functions for Hopper (sm_90a).
//
// Replaces the reference's batched jnp keccak
//   coreth_tpu/ops/keccak.py:133 keccak_f1600 and :186 keccak256_blocks.
// The state is 25 lanes of 64 bits held as 50 32-bit registers (lo[],
// hi[]), as the reference holds them as (lo, hi) uint32 pairs.  Every
// lane index is a compile-time constant: theta's five-way XORs and chi's
// a ^ (~b & c) compile to LOP3s, each 64-bit rotate to two funnel shifts
// (none for rotates by 0 or 32); rho and pi walk pi's cycle in place
// and chi goes a row at a time, so a round needs ~14 registers beside
// the state.  The 24 rounds run as a loop (the round constant from
// constant memory), so the code is one round long.  The round constants
// and rho/pi schedule are the standard Keccak-f[1600] tables, equal to
// the ones the reference derives by LFSR.
//
// Absorbing (keccak256_stream) reads the message as 32-bit words: a
// message that starts at byte `off` (0..3) of a word-aligned stream is
// funnel-shifted out of two neighbouring words, the bytes past its end
// masked off and the pad10*1 bits applied to the words that hold them;
// only words that hold a message byte are read.
//
// Callers: the lane interpreter's SHA3 (step_machine.cuh, from the
// lane's memory: keccak256_mem), K7's device SHA3 (spec_lane.cuh, from
// the memory-model words: keccak256_be_words); the standalone launch
// entry keccak256_blocks.cu (host-padded blocks, two threads a message)
// runs the same round on half the words, and holds it against the plain
// PyTorch version (coreth_tpu_torch/ops/keccak.py).
//
// Cost: per absorbed 136-byte block, 24 rounds of about 155 64-bit
// operations (theta 55, rho+pi 24 rotates, chi 75, iota 1), each two
// 32-bit ones; the block's 34 word loads and XORs on top.
//
// Portable C++ as in u256x.cuh: off the card (the g++ host builds of
// the tests) or with KECCAK_HOST_BUILD, the intrinsics in plain C++.

#pragma once

#include <cstdint>

#if !defined(__CUDA_ARCH__) && !defined(KECCAK_HOST_BUILD)
#define KECCAK_HOST_BUILD 1
#endif

__constant__ uint32_t kKeccakRCLo[24] = {
    0x00000001u, 0x00008082u, 0x0000808Au, 0x80008000u, 0x0000808Bu,
    0x80000001u, 0x80008081u, 0x00008009u, 0x0000008Au, 0x00000088u,
    0x80008009u, 0x8000000Au, 0x8000808Bu, 0x0000008Bu, 0x00008089u,
    0x00008003u, 0x00008002u, 0x00000080u, 0x0000800Au, 0x8000000Au,
    0x80008081u, 0x00008080u, 0x80000001u, 0x80008008u};
__constant__ uint32_t kKeccakRCHi[24] = {
    0x00000000u, 0x00000000u, 0x80000000u, 0x80000000u, 0x00000000u,
    0x00000000u, 0x80000000u, 0x80000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x80000000u, 0x80000000u,
    0x80000000u, 0x80000000u, 0x80000000u, 0x00000000u, 0x80000000u,
    0x80000000u, 0x80000000u, 0x00000000u, 0x80000000u};

#ifdef KECCAK_HOST_BUILD
// (hi:lo) << s, high word; (hi:lo) >> s, low word; s in [0, 31]
__device__ __forceinline__ uint32_t keccak_fshl(uint32_t lo, uint32_t hi,
                                                int s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << s) >> 32);
}
__device__ __forceinline__ uint32_t keccak_fshr(uint32_t lo, uint32_t hi,
                                                int s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
}
__device__ __forceinline__ uint32_t keccak_bswap32(uint32_t x) {
  return __builtin_bswap32(x);
}
#else
__device__ __forceinline__ uint32_t keccak_fshl(uint32_t lo, uint32_t hi,
                                                int s) {
  return __funnelshift_l(lo, hi, s);
}
__device__ __forceinline__ uint32_t keccak_fshr(uint32_t lo, uint32_t hi,
                                                int s) {
  return __funnelshift_r(lo, hi, s);
}
__device__ __forceinline__ uint32_t keccak_bswap32(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123u);
}
#endif

// the lane (lo, hi) rotated left by R bits
template <int R>
__device__ __forceinline__ void keccak_rotl(uint32_t lo, uint32_t hi,
                                            uint32_t& olo, uint32_t& ohi) {
  if constexpr (R == 0) {
    olo = lo;
    ohi = hi;
  } else if constexpr (R < 32) {
    olo = keccak_fshl(hi, lo, R);
    ohi = keccak_fshl(lo, hi, R);
  } else if constexpr (R == 32) {
    olo = hi;
    ohi = lo;
  } else {
    olo = keccak_fshl(lo, hi, R - 32);
    ohi = keccak_fshl(hi, lo, R - 32);
  }
}

// One round over lanes x + 5 * y.
__device__ __forceinline__ void keccak_round(uint32_t* lo, uint32_t* hi,
                                             uint32_t rc_lo,
                                             uint32_t rc_hi) {
  // theta
  uint32_t cl[5], ch[5];
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    cl[x] = lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20];
    ch[x] = hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20];
  }
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    uint32_t rl, rh;
    keccak_rotl<1>(cl[(x + 1) % 5], ch[(x + 1) % 5], rl, rh);
    const uint32_t pl = cl[(x + 4) % 5], ph = ch[(x + 4) % 5];
#pragma unroll
    for (int y = 0; y < 25; y += 5) {  // one three-input XOR each
      lo[x + y] ^= pl ^ rl;
      hi[x + y] ^= ph ^ rh;
    }
  }
  // rho and pi in place along pi's cycle from lane 1, then chi a row at
  // a time: two lanes and one row of temporaries beside the state
  uint32_t tl = lo[1], th = hi[1];
#define KECCAK_PI(dst, r)                             \
  {                                                   \
    const uint32_t ul = lo[dst], uh = hi[dst];        \
    keccak_rotl<r>(tl, th, lo[dst], hi[dst]);         \
    tl = ul;                                          \
    th = uh;                                          \
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
  // chi, iota
#pragma unroll
  for (int y = 0; y < 25; y += 5) {
    uint32_t rl[5], rh[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      rl[x] = lo[x + y];
      rh[x] = hi[x + y];
    }
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      lo[x + y] = rl[x] ^ (~rl[(x + 1) % 5] & rl[(x + 2) % 5]);
      hi[x + y] = rh[x] ^ (~rh[(x + 1) % 5] & rh[(x + 2) % 5]);
    }
  }
  lo[0] ^= rc_lo;
  hi[0] ^= rc_hi;
}

// The permutation over lanes (lo[i], hi[i]), i = x + 5 * y: a loop of
// one round (unrolled it ran slower, from the instruction cache)
__device__ __forceinline__ void keccak_f1600(uint32_t* lo, uint32_t* hi) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r)
    keccak_round(lo, hi, kKeccakRCLo[r], kKeccakRCHi[r]);
}

// keccak-256 of `len` bytes that start at byte `off` (0..3) of a stream
// of little-endian 32-bit words (fetch(m): word m), the digest as 8
// little-endian words.  fetch is called only for the words that hold a
// message byte, each once.
template <class Fetch>
__device__ __forceinline__ void keccak256_stream(const Fetch& fetch, int off,
                                                 int len, uint32_t dg[8]) {
  uint32_t lo[25], hi[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) lo[i] = hi[i] = 0;
  const int nblocks = len / 136 + 1, end = off + len, sh = 8 * off;
  uint32_t cur = len > 0 ? fetch(0) : 0u;
  for (int blk = 0; blk < nblocks; ++blk) {
#pragma unroll
    for (int k = 0; k < 34; ++k) {
      const int m = 34 * blk + k;  // the block's word k: bytes 4m .. 4m+3
      const uint32_t nxt = 4 * (m + 1) < end ? fetch(m + 1) : 0u;
      uint32_t v = keccak_fshr(cur, nxt, sh);
      cur = nxt;
      const int rel = len - 4 * m;  // its bytes below the message's end
      v = rel >= 4 ? v : (rel <= 0 ? 0u : v & ((1u << (8 * rel)) - 1u));
      if (rel >= 0 && rel < 4) v ^= 1u << (8 * rel);  // pad10*1: first bit
      if (k == 33 && blk == nblocks - 1) v ^= 0x80000000u;  // and last
      if (k & 1)
        hi[k >> 1] ^= v;
      else
        lo[k >> 1] ^= v;
    }
    keccak_f1600(lo, hi);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dg[2 * k] = lo[k];
    dg[2 * k + 1] = hi[k];
  }
}

// keccak-256 of len bytes at byte a of mem (mem 4-byte aligned; bytes
// [a & ~3, a + len) rounded out to whole words are read).  Out of line:
// inlined into the lane interpreter it made ptxas spill.
__device__ __noinline__ void keccak256_mem(const uint8_t* mem, int a,
                                           int len, uint32_t dg[8]) {
  const uint32_t* w = (const uint32_t*)(mem + (a & ~3));
  keccak256_stream([w](int m) { return w[m]; }, a & 3, len, dg);
}

// keccak-256 of `size` bytes from byte s of EVM memory words mw[0..]
// (each 32-byte big-endian word as W::w[8], little-endian 32-bit words)
template <class W>
__device__ __forceinline__ void keccak256_be_words(const W* mw, int s,
                                                   int size, uint32_t dg[8]) {
  const int t0 = s >> 2;  // the memory's 32-bit word holding byte s
  keccak256_stream(
      [mw, t0](int m) {
        const int t = t0 + m;
        return keccak_bswap32(mw[t >> 3].w[7 - (t & 7)]);
      },
      s & 3, size, dg);
}
