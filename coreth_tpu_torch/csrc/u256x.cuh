// The 256-bit EVM ALU (K4) as CUDA device functions for Hopper (sm_90a).
//
// Replaces the reference's jnp ALU
//   coreth_tpu/ops/u256x.py (mul, mul_wide, divmod_, sdiv, smod, addmod,
//   mulmod, exp_, shl/shr/sar, byte_op, signextend, lt/gt/slt/sgt/eq,
//   bit_length, not_) and the add/sub of coreth_tpu/ops/u256.py.
// The reference keeps 16 x 16-bit limbs in int32 because the TPU has no
// wide integer product; here a word is 8 x 32-bit little-endian words
// with 32x32->64 products, and every function is the exact EVM
// operation (core/vm/instructions.go), so results equal the reference's
// bit for bit.  Conversion to and from the reference's 16-bit limb
// layout happens at the boundary (u256_from_limbs / u256_to_limbs).
//
// Callers: the step-machine lane interpreter (step_machine.cuh, inside
// K5, K6 and K9), K7's generated programs (spec_lane.cuh), and the
// standalone launch entry u256x_eval.cu, which holds each op against
// the plain PyTorch version (coreth_tpu_torch/ops/u256x.py).
//
// Design (every word index is a compile-time constant once the loops
// are unrolled, so words stay in registers):
// - add, sub, the compares and the products run on PTX carry chains
//   (add.cc / addc, sub.cc / subc, mad.lo.cc / madc.hi.cc); lt and slt
//   are the borrow out of one subtract chain.  MUL is 36 low and 28 high
//   word products, a squaring (EXP) 20 and 16, the wide product 64 of
//   each.
// - Shifts are a select network: whole-word moves by 4, 2 and 1 words on
//   the amount's bits 7, 6 and 5, then one funnel shift a word.  BYTE,
//   SIGNEXTEND and EXP's bit test pick a word by a 3-level select tree.
// - Division is Knuth's Algorithm D (TAOCP vol. 2, 4.3.1) on 32-bit
//   digits.  The divisor is shifted left until its top bit is bit 255
//   (whole words and __clz of its top word), the dividend by the same;
//   each quotient digit is estimated by a 2-by-1 division through the
//   reciprocal of the divisor's top word (Moller and Granlund, "Improved
//   division by invariant integers", 2011, Algorithm 4; the reciprocal
//   once a division, from a float estimate), corrected at most twice
//   against the next word,
//   then multiplied and subtracted on a carry chain, with the rare
//   add-back.  Digits the operands' bit lengths rule out are skipped.
//   Fast paths: a zero divisor (0), a dividend below the divisor, and a
//   divisor of one word (one 2-by-1 division a digit).  DIV, MOD, SDIV
//   and SMOD share one 8-word routine (u256_divmod_op), ADDMOD and MULMOD
//   one 16-word routine (u256_modop).
//
// Portable C++: outside nvcc's device pass (the g++ host builds of the
// tests), or with U256_HOST_BUILD defined, the carry chains run on a
// carry flag threaded through `cf`, the intrinsics in plain C++.  The
// PTX branch is checked only on the card.  U256_COUNT(k, cond) counts
// the division's rare paths in a host build (see U256_P_*); it is empty
// on the card.

#pragma once

#include <cstdint>

#if !defined(__CUDA_ARCH__) && !defined(U256_HOST_BUILD)
#define U256_HOST_BUILD 1
#endif

// the rare paths U256_COUNT names
#define U256_P_ZERO 0       // divisor 0
#define U256_P_BELOW 1      // dividend below the divisor
#define U256_P_ONEWORD 2    // divisor of one word
#define U256_P_NORM0 3      // normalisation shift 0 (top word's bit 31 set)
#define U256_P_CORR1 4      // a digit estimate corrected once (or more)
#define U256_P_CORR2 5      // a digit estimate corrected twice
#define U256_P_ADDBACK 6    // the multiply-subtract went negative
#define U256_P_TOPEQ 7      // the dividend's top word equal to the divisor's
#define U256_P_MINNEG1 8    // SDIV -2^255 / -1
#define U256_P_MOD1 9       // MULMOD by 1
#define U256_P_SUM257 10    // ADDMOD's sum past 2^256
#define U256_P_COUNT 11
#ifndef U256_COUNT
#define U256_COUNT(k, cond) ((void)0)
#endif

struct u256 {
  uint32_t w[8];
};

// ------------------------------------------------------ carry chains
// On the card each helper is one PTX instruction on CC.CF (asm volatile
// keeps their order) and cf is unused; the host build threads the same
// carry through cf.
#ifdef U256_HOST_BUILD
__device__ __forceinline__ uint32_t u256_add_cc(uint32_t& cf, uint32_t a,
                                                uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t u256_addc_cc(uint32_t& cf, uint32_t a,
                                                 uint32_t b) {
  const uint64_t s = (uint64_t)a + b + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t u256_addc(uint32_t& cf, uint32_t a,
                                              uint32_t b) {
  return a + b + cf;
}
__device__ __forceinline__ uint32_t u256_sub_cc(uint32_t& cf, uint32_t a,
                                                uint32_t b) {
  cf = a < b;
  return a - b;
}
__device__ __forceinline__ uint32_t u256_subc_cc(uint32_t& cf, uint32_t a,
                                                 uint32_t b) {
  const uint64_t t = (uint64_t)b + cf;
  cf = (uint64_t)a < t;
  return (uint32_t)((uint64_t)a - t);
}
__device__ __forceinline__ uint32_t u256_subc(uint32_t& cf, uint32_t a,
                                              uint32_t b) {
  return a - b - cf;
}
__device__ __forceinline__ uint32_t u256_mulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
__device__ __forceinline__ uint32_t u256_mad_lo_cc(uint32_t& cf, uint32_t a,
                                                   uint32_t b, uint32_t c) {
  return u256_add_cc(cf, a * b, c);
}
__device__ __forceinline__ uint32_t u256_madc_lo_cc(uint32_t& cf,
                                                    uint32_t a, uint32_t b,
                                                    uint32_t c) {
  return u256_addc_cc(cf, a * b, c);
}
__device__ __forceinline__ uint32_t u256_mad_hi_cc(uint32_t& cf, uint32_t a,
                                                   uint32_t b, uint32_t c) {
  return u256_add_cc(cf, u256_mulhi(a, b), c);
}
__device__ __forceinline__ uint32_t u256_madc_hi_cc(uint32_t& cf,
                                                    uint32_t a, uint32_t b,
                                                    uint32_t c) {
  return u256_addc_cc(cf, u256_mulhi(a, b), c);
}
__device__ __forceinline__ uint32_t u256_madc_hi(uint32_t& cf, uint32_t a,
                                                 uint32_t b, uint32_t c) {
  return u256_addc(cf, u256_mulhi(a, b), c);
}
// (hi:lo) << s, high word; (hi:lo) >> s, low word; s in [0, 31]
__device__ __forceinline__ uint32_t u256_fshl(uint32_t lo, uint32_t hi,
                                              int s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << s) >> 32);
}
__device__ __forceinline__ uint32_t u256_fshr(uint32_t lo, uint32_t hi,
                                              int s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
}
__device__ __forceinline__ int u256_clz(uint32_t x) {
  return x ? __builtin_clz(x) : 32;
}
__device__ __forceinline__ float u256_rcpf(uint32_t d) {
  return 1.0f / (float)d;
}
#else
#define U256_OP2(name, ins)                                          \
  __device__ __forceinline__ uint32_t name(uint32_t&, uint32_t a,    \
                                           uint32_t b) {             \
    uint32_t r;                                                      \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));     \
    return r;                                                        \
  }
#define U256_OP3(name, ins)                                          \
  __device__ __forceinline__ uint32_t name(uint32_t&, uint32_t a,    \
                                           uint32_t b, uint32_t c) { \
    uint32_t r;                                                      \
    asm volatile(ins " %0, %1, %2, %3;"                              \
                 : "=r"(r)                                           \
                 : "r"(a), "r"(b), "r"(c));                          \
    return r;                                                        \
  }
U256_OP2(u256_add_cc, "add.cc.u32")
U256_OP2(u256_addc_cc, "addc.cc.u32")
U256_OP2(u256_addc, "addc.u32")
U256_OP2(u256_sub_cc, "sub.cc.u32")
U256_OP2(u256_subc_cc, "subc.cc.u32")
U256_OP2(u256_subc, "subc.u32")
U256_OP3(u256_mad_lo_cc, "mad.lo.cc.u32")
U256_OP3(u256_madc_lo_cc, "madc.lo.cc.u32")
U256_OP3(u256_mad_hi_cc, "mad.hi.cc.u32")
U256_OP3(u256_madc_hi_cc, "madc.hi.cc.u32")
U256_OP3(u256_madc_hi, "madc.hi.u32")
#undef U256_OP2
#undef U256_OP3
__device__ __forceinline__ uint32_t u256_mulhi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}
__device__ __forceinline__ uint32_t u256_fshl(uint32_t lo, uint32_t hi,
                                              int s) {
  return __funnelshift_l(lo, hi, s);
}
__device__ __forceinline__ uint32_t u256_fshr(uint32_t lo, uint32_t hi,
                                              int s) {
  return __funnelshift_r(lo, hi, s);
}
__device__ __forceinline__ int u256_clz(uint32_t x) { return __clz(x); }
// 1 / d to about 2 ulp, inline (MUFU.RCP)
__device__ __forceinline__ float u256_rcpf(uint32_t d) {
  return __fdividef(1.0f, (float)d);
}
#endif

// ------------------------------------------------------ construction

__device__ __forceinline__ u256 u256_zero() {
  u256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ u256 u256_small(uint32_t v) {
  u256 r = u256_zero();
  r.w[0] = v;
  return r;
}

__device__ __forceinline__ u256 u256_from_limbs(const int32_t* l) {
  u256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.w[i] = ((uint32_t)l[2 * i] & 0xFFFFu) |
             (((uint32_t)l[2 * i + 1] & 0xFFFFu) << 16);
  return r;
}

__device__ __forceinline__ void u256_to_limbs(const u256& a, int32_t* l) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[2 * i] = (int32_t)(a.w[i] & 0xFFFFu);
    l[2 * i + 1] = (int32_t)(a.w[i] >> 16);
  }
}

// 32 big-endian bytes (as uint8 values) -> word
__device__ __forceinline__ u256 u256_from_be(const uint8_t* be) {
  u256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.w[i] = (uint32_t)be[31 - 4 * i] | ((uint32_t)be[30 - 4 * i] << 8) |
             ((uint32_t)be[29 - 4 * i] << 16) |
             ((uint32_t)be[28 - 4 * i] << 24);
  return r;
}

// word k (0..7, known only at run time) by a 3-level select tree
__device__ __forceinline__ uint32_t u256_word_at(const u256& a, int k) {
  const bool b2 = k & 4, b1 = k & 2, b0 = k & 1;
  const uint32_t l0 = b2 ? a.w[4] : a.w[0], l1 = b2 ? a.w[5] : a.w[1];
  const uint32_t l2 = b2 ? a.w[6] : a.w[2], l3 = b2 ? a.w[7] : a.w[3];
  const uint32_t m0 = b1 ? l2 : l0, m1 = b1 ? l3 : l1;
  return b0 ? m1 : m0;
}

// big-endian byte j (0 = most significant, 0..31) of a word
__device__ __forceinline__ uint32_t u256_be_byte(const u256& a, int j) {
  const int p = 31 - j;  // little-endian byte position
  return (u256_word_at(a, p >> 2) >> ((p & 3) * 8)) & 0xFFu;
}

// ------------------------------------------------------ compares

__device__ __forceinline__ bool u256_is_zero(const u256& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a.w[i];
  return o == 0;
}

__device__ __forceinline__ bool u256_eq(const u256& a, const u256& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a.w[i] ^ b.w[i];
  return o == 0;
}

// the borrow out of a - b over n words (1 when a < b), top words xor'd
// with `flip` (0x80000000 compares as signed)
template <int N>
__device__ __forceinline__ bool u256_borrow(const uint32_t* a,
                                            const uint32_t* b,
                                            uint32_t flip) {
  uint32_t cf = 0;
  (void)u256_sub_cc(cf, a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) (void)u256_subc_cc(cf, a[i], b[i]);
  (void)u256_subc_cc(cf, a[N - 1] ^ flip, b[N - 1] ^ flip);
  return u256_subc(cf, 0u, 0u) != 0;
}

// unsigned a < b
__device__ __forceinline__ bool u256_lt(const u256& a, const u256& b) {
  return u256_borrow<8>(a.w, b.w, 0u);
}

__device__ __forceinline__ bool u256_slt(const u256& a, const u256& b) {
  return u256_borrow<8>(a.w, b.w, 0x80000000u);
}

// ------------------------------------------------------ add, sub, not

__device__ __forceinline__ u256 u256_add(const u256& a, const u256& b) {
  u256 r;
  uint32_t cf = 0;
  r.w[0] = u256_add_cc(cf, a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) r.w[i] = u256_addc_cc(cf, a.w[i], b.w[i]);
  r.w[7] = u256_addc(cf, a.w[7], b.w[7]);
  return r;
}

__device__ __forceinline__ u256 u256_sub(const u256& a, const u256& b) {
  u256 r;
  uint32_t cf = 0;
  r.w[0] = u256_sub_cc(cf, a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) r.w[i] = u256_subc_cc(cf, a.w[i], b.w[i]);
  r.w[7] = u256_subc(cf, a.w[7], b.w[7]);
  return r;
}

__device__ __forceinline__ u256 u256_neg(const u256& a) {
  return u256_sub(u256_zero(), a);
}

__device__ __forceinline__ bool u256_sign(const u256& a) {
  return (a.w[7] >> 31) != 0;
}

__device__ __forceinline__ u256 u256_not(const u256& a) {
  u256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = ~a.w[i];
  return r;
}

// ------------------------------------------------------ products

// a * b mod 2^256: a row a word of a, its low products on one carry
// chain and its high products (one word up) on a second; carries out of
// word 7 fall away
__device__ __forceinline__ u256 u256_mul(const u256& a, const u256& b) {
  u256 r = u256_zero();
  uint32_t cf = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = u256_mad_lo_cc(cf, a.w[i], b.w[0], r.w[i]);
#pragma unroll
    for (int j = 1; i + j < 8; ++j)
      r.w[i + j] = u256_madc_lo_cc(cf, a.w[i], b.w[j], r.w[i + j]);
    if (i < 7) {
      r.w[i + 1] = u256_mad_hi_cc(cf, a.w[i], b.w[0], r.w[i + 1]);
#pragma unroll
      for (int j = 1; i + j + 1 < 8; ++j)
        r.w[i + j + 1] = u256_madc_hi_cc(cf, a.w[i], b.w[j], r.w[i + j + 1]);
    }
  }
  return r;
}

// a * a mod 2^256: the 16 cross products a_i a_j (i < j, i + j <= 7)
// once, doubled, plus the squares a_i^2 (i <= 3): 36 word products
// where u256_mul takes 64
__device__ __forceinline__ u256 u256_sqr(const u256& a) {
  u256 t = u256_zero();
  uint32_t cf = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // row i: lows of a_i a_j into words 2i+1 .., highs into 2i+2 ..
    t.w[2 * i + 1] = u256_mad_lo_cc(cf, a.w[i], a.w[i + 1], t.w[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; i + j < 8; ++j)
      t.w[i + j] = u256_madc_lo_cc(cf, a.w[i], a.w[j], t.w[i + j]);
    if (i < 3) {
      t.w[2 * i + 2] = u256_mad_hi_cc(cf, a.w[i], a.w[i + 1],
                                      t.w[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; i + j + 1 < 8; ++j)
        t.w[i + j + 1] = u256_madc_hi_cc(cf, a.w[i], a.w[j], t.w[i + j + 1]);
    }
  }
#pragma unroll
  for (int i = 7; i > 0; --i) t.w[i] = u256_fshl(t.w[i - 1], t.w[i], 1);
  t.w[0] <<= 1;
  // + the squares, low words at 2i, high at 2i + 1
  t.w[0] = u256_mad_lo_cc(cf, a.w[0], a.w[0], t.w[0]);
  t.w[1] = u256_madc_hi_cc(cf, a.w[0], a.w[0], t.w[1]);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    t.w[2 * i] = u256_madc_lo_cc(cf, a.w[i], a.w[i], t.w[2 * i]);
    t.w[2 * i + 1] = u256_madc_hi_cc(cf, a.w[i], a.w[i], t.w[2 * i + 1]);
  }
  return t;
}

// full 512-bit product, 16 little-endian words: row i adds its low
// products to words i..i+7 (the carry into word i + 8, still zero
// before the row) and its high products to words i+1..i+8 (no carry
// out: the partial sum stays below 2^(32 (i + 9)))
__device__ __forceinline__ void u256_mul_wide(const u256& a, const u256& b,
                                              uint32_t out[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = 0;
  uint32_t cf = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = u256_mad_lo_cc(cf, a.w[i], b.w[0], out[i]);
#pragma unroll
    for (int j = 1; j < 8; ++j)
      out[i + j] = u256_madc_lo_cc(cf, a.w[i], b.w[j], out[i + j]);
    out[i + 8] = u256_addc(cf, out[i + 8], 0u);
    out[i + 1] = u256_mad_hi_cc(cf, a.w[i], b.w[0], out[i + 1]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      out[i + j + 1] = u256_madc_hi_cc(cf, a.w[i], b.w[j], out[i + j + 1]);
    out[i + 8] = u256_madc_hi(cf, a.w[i], b.w[7], out[i + 8]);
  }
}

// ------------------------------------------------------ bit lengths

template <int N>
__device__ __forceinline__ int words_bit_length(const uint32_t* x) {
  int bl = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (x[i]) bl = 32 * i + 32 - u256_clz(x[i]);
  return bl;
}

__device__ __forceinline__ int u256_bit_length(const u256& a) {
  return words_bit_length<8>(a.w);
}

// ------------------------------------------------------ shift networks

// x (N words) <<= s, s in [0, 255]: moves by 4, 2, 1 words, then bits
template <int N>
__device__ __forceinline__ void words_shl(uint32_t* x, int s) {
#pragma unroll
  for (int k = 4; k >= 1; k >>= 1) {
    const bool f = (s >> 5) & k;
#pragma unroll
    for (int i = N - 1; i >= 0; --i)
      x[i] = f ? (i >= k ? x[i >= k ? i - k : 0] : 0u) : x[i];
  }
  const int b = s & 31;
#pragma unroll
  for (int i = N - 1; i > 0; --i) x[i] = u256_fshl(x[i - 1], x[i], b);
  x[0] <<= b;
}

// x (N words) >>= s, s in [0, 255], the words above x read as `fill`
template <int N>
__device__ __forceinline__ void words_shr(uint32_t* x, int s,
                                          uint32_t fill) {
#pragma unroll
  for (int k = 4; k >= 1; k >>= 1) {
    const bool f = (s >> 5) & k;
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = f ? (i + k < N ? x[i + k < N ? i + k : 0] : fill) : x[i];
  }
  const int b = s & 31;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) x[i] = u256_fshr(x[i], x[i + 1], b);
  x[N - 1] = u256_fshr(x[N - 1], fill, b);
}

// an amount word: true when it is past `limit` (else *s holds it)
__device__ __forceinline__ bool u256_over(const u256& n, uint32_t limit,
                                          int* s) {
  uint32_t hi = 0;
#pragma unroll
  for (int i = 1; i < 8; ++i) hi |= n.w[i];
  *s = (int)(n.w[0] & 0xFFu);
  return hi != 0 || n.w[0] > limit;
}

// x << n
__device__ __forceinline__ u256 u256_shl(const u256& x, const u256& n) {
  int s;
  const bool over = u256_over(n, 255, &s);
  u256 r = x;
  words_shl<8>(r.w, s);
  return over ? u256_zero() : r;
}

// x >> n (logical)
__device__ __forceinline__ u256 u256_shr(const u256& x, const u256& n) {
  int s;
  const bool over = u256_over(n, 255, &s);
  u256 r = x;
  words_shr<8>(r.w, s, 0u);
  return over ? u256_zero() : r;
}

// x >> n (arithmetic): the sign word fills from above
__device__ __forceinline__ u256 u256_sar(const u256& x, const u256& n) {
  const uint32_t fill = u256_sign(x) ? 0xFFFFFFFFu : 0u;
  int s;
  const bool over = u256_over(n, 255, &s);
  u256 r = x;
  words_shr<8>(r.w, s, fill);
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = over ? fill : r.w[i];
  return r;
}

// BYTE: big-endian byte i of x, 0 when i >= 32
__device__ __forceinline__ u256 u256_byte(const u256& i, const u256& x) {
  int s;
  const bool over = u256_over(i, 31, &s);
  return u256_small(over ? 0u : u256_be_byte(x, s & 31));
}

// SIGNEXTEND from byte b (0 = lowest); b >= 31 leaves x unchanged
__device__ __forceinline__ u256 u256_signextend(const u256& b,
                                                const u256& x) {
  int s;
  const bool over = u256_over(b, 30, &s);
  const int t = 8 * (s > 30 ? 30 : s) + 7;  // sign bit position
  const bool neg = (u256_word_at(x, t >> 5) >> (t & 31)) & 1u;
  u256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rel = t + 1 - 32 * i;  // bits of word i below it are kept
    const uint32_t keep =
        rel >= 32 ? 0xFFFFFFFFu : (rel <= 0 ? 0u : (1u << rel) - 1u);
    const uint32_t ext = neg ? (x.w[i] | ~keep) : (x.w[i] & keep);
    r.w[i] = over ? x.w[i] : ext;
  }
  return r;
}

// ------------------------------------------------------ division

// d's reciprocal floor((2^64 - 1) / d) - 2^32, d normalised (bit 31
// set): a float estimate of 2^64 / d (off by up to ~2^11), one float
// correction from the exact remainder, then at most a step or two (no
// 64-bit division: nvcc calls a subroutine for one)
__device__ __forceinline__ uint32_t u256_recip(uint32_t d) {
  const float r = u256_rcpf(d);
  uint64_t q = (uint64_t)(r * 18446744073709551616.0f);
  // X - q * d, X = 2^64 - 1: below 2^44 in size, so exact mod 2^64
  int64_t rem = (int64_t)(0xFFFFFFFFFFFFFFFFull - q * d);
  q += (int64_t)((float)rem * r);
  rem = (int64_t)(0xFFFFFFFFFFFFFFFFull - q * d);
  while (rem < 0) {
    --q;
    rem += d;
  }
  while (rem >= (int64_t)d) {
    ++q;
    rem -= d;
  }
  return (uint32_t)q;
}

// (u1:u0) / d with u1 < d, d normalised, inv = u256_recip(d)
// (Moller-Granlund Algorithm 4); *rem the remainder
__device__ __forceinline__ uint32_t u256_div21(uint32_t u1, uint32_t u0,
                                               uint32_t d, uint32_t inv,
                                               uint32_t* rem) {
  const uint64_t p =
      (uint64_t)inv * u1 + ((((uint64_t)u1) << 32) | (uint64_t)u0);
  uint32_t q1 = (uint32_t)(p >> 32) + 1u;
  const uint32_t q0 = (uint32_t)p;
  uint32_t r = u0 - q1 * d;
  if (r > q0) {
    --q1;
    r += d;
  }
  if (r >= d) {
    ++q1;
    r -= d;
  }
  *rem = r;
  return q1;
}

// u (N words) / v, v of one nonzero word: a 2-by-1 division a digit from
// the top, after shifting both by __clz(v); digits above the quotient's
// bit length (Lu - Lv) are zero and skipped (the remainder then is the
// next word).  q (N words) only when WANT_Q.
template <int N, bool WANT_Q>
__device__ __forceinline__ void words_div1(const uint32_t* u, uint32_t v,
                                           int span, uint32_t* q,
                                           u256* r) {
  const int sh = u256_clz(v);
  U256_COUNT(U256_P_NORM0, sh == 0);
  const uint32_t d = v << sh, inv = u256_recip(d);
  uint32_t rem = u256_fshl(u[N - 1], 0u, sh);
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    const uint32_t uj = u256_fshl(j > 0 ? u[j - 1] : 0u, u[j], sh);
    uint32_t qj = 0;
    if (32 * j <= span)
      qj = u256_div21(rem, uj, d, inv, &rem);
    else
      rem = uj;  // the digit is zero, so is the remainder above it
    if constexpr (WANT_Q) q[j] = qj;
  }
  *r = u256_small(rem >> sh);
}

// u (N words) / v, v past one word: Knuth's Algorithm D with V = v << s
// (bit 255 set) over U = u << s (N + 8 words)
template <int N, bool WANT_Q>
__device__ __forceinline__ void words_divn(const uint32_t* u, const u256& v,
                                           int lv, int span, uint32_t* q,
                                           u256* r) {
  const int s = 256 - lv;
  U256_COUNT(U256_P_NORM0, (s & 31) == 0);
  uint32_t V[8], U[N + 8];
#pragma unroll
  for (int i = 0; i < 8; ++i) V[i] = v.w[i];
  words_shl<8>(V, s);
#pragma unroll
  for (int i = 0; i < N + 8; ++i) U[i] = i < N ? u[i] : 0u;
  words_shl<N + 8>(U, s);
  const uint32_t vt = V[7], vn = V[6], inv = u256_recip(vt);
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    uint32_t qh = 0;
    if (32 * j <= span) {
      // the estimate from the window's top two words
      const uint32_t ut = U[j + 8], un = U[j + 7], un2 = U[j + 6];
      uint32_t rh;
      bool rh_over;
      if (ut >= vt) {
        U256_COUNT(U256_P_TOPEQ, true);
        qh = 0xFFFFFFFFu;
        const uint64_t t = (uint64_t)un + vt;
        rh = (uint32_t)t;
        rh_over = (t >> 32) != 0;
      } else {
        qh = u256_div21(ut, un, vt, inv, &rh);
        rh_over = false;
      }
      // at most two corrections against the next word
      if (!rh_over &&
          (uint64_t)qh * vn > ((((uint64_t)rh) << 32) | (uint64_t)un2)) {
        U256_COUNT(U256_P_CORR1, true);
        --qh;
        const uint64_t t = (uint64_t)rh + vt;
        rh = (uint32_t)t;
        if ((t >> 32) == 0 &&
            (uint64_t)qh * vn > ((((uint64_t)rh) << 32) | (uint64_t)un2)) {
          U256_COUNT(U256_P_CORR2, true);
          --qh;
        }
      }
      // U[j .. j+8] -= qh * V
      uint32_t p[9], cf = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = qh * V[k];
      p[1] = u256_mad_hi_cc(cf, qh, V[0], p[1]);
#pragma unroll
      for (int k = 1; k < 7; ++k)
        p[k + 1] = u256_madc_hi_cc(cf, qh, V[k], p[k + 1]);
      p[8] = u256_madc_hi(cf, qh, V[7], 0u);
      U[j] = u256_sub_cc(cf, U[j], p[0]);
#pragma unroll
      for (int k = 1; k < 9; ++k) U[j + k] = u256_subc_cc(cf, U[j + k], p[k]);
      const bool neg = u256_subc(cf, 0u, 0u) != 0;
      if (neg) {  // the estimate was one too large: add V back
        U256_COUNT(U256_P_ADDBACK, true);
        --qh;
        U[j] = u256_add_cc(cf, U[j], V[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k) U[j + k] = u256_addc_cc(cf, U[j + k], V[k]);
        U[j + 8] = u256_addc(cf, U[j + 8], 0u);
      }
    }
    if constexpr (WANT_Q) q[j] = qh;
  }
  words_shr<8>(U, s, 0u);
#pragma unroll
  for (int i = 0; i < 8; ++i) r->w[i] = U[i];
}

// u (N words) / v: q (N words, when WANT_Q) and the remainder r;
// v == 0 gives q = 0 and r = 0
template <int N, bool WANT_Q>
__device__ __forceinline__ void words_divrem(const uint32_t* u,
                                             const u256& v, uint32_t* q,
                                             u256* r) {
  const int lu = words_bit_length<N>(u), lv = u256_bit_length(v);
  uint32_t hi = 0;
#pragma unroll
  for (int i = 8; i < N; ++i) hi |= u[i];
  if (lv == 0 || (hi == 0 && u256_borrow<8>(u, v.w, 0u))) {
    // divisor zero, or dividend below it: q = 0, r = u (0 for v == 0)
    U256_COUNT(U256_P_ZERO, lv == 0);
    U256_COUNT(U256_P_BELOW, lv != 0);
    if constexpr (WANT_Q) {
#pragma unroll
      for (int i = 0; i < N; ++i) q[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) r->w[i] = lv == 0 ? 0u : u[i];
    return;
  }
  if (lv <= 32) {
    U256_COUNT(U256_P_ONEWORD, true);
    words_div1<N, WANT_Q>(u, v.w[0], lu - lv, q, r);
  } else {
    words_divn<N, WANT_Q>(u, v, lv, lu - lv, q, r);
  }
}

// (a / b, a % b); b == 0 -> (0, 0)
__device__ __forceinline__ void u256_divmod(const u256& a, const u256& b,
                                            u256* q, u256* r) {
  words_divrem<8, true>(a.w, b, q->w, r);
}

// DIV, SDIV, MOD, SMOD by EVM opcode (0x04 .. 0x07), one division
__device__ __forceinline__ u256 u256_divmod_op(int op, const u256& a,
                                               const u256& b) {
  const bool sgn = op == 0x05 || op == 0x07, want_mod = op >= 0x06;
  const bool na = sgn && u256_sign(a), nb = sgn && u256_sign(b);
  U256_COUNT(U256_P_MINNEG1, op == 0x05 && a.w[7] == 0x80000000u &&
                                 (a.w[0] | a.w[1] | a.w[2] | a.w[3] |
                                  a.w[4] | a.w[5] | a.w[6]) == 0 &&
                                 (b.w[0] & b.w[1] & b.w[2] & b.w[3] & b.w[4] &
                                  b.w[5] & b.w[6] & b.w[7]) == 0xFFFFFFFFu);
  u256 q, r;
  u256_divmod(na ? u256_neg(a) : a, nb ? u256_neg(b) : b, &q, &r);
  // SDIV negates when the signs differ (-2^255 / -1 stays -2^255);
  // SMOD takes the dividend's sign
  const bool negate = want_mod ? na : (na != nb);
  const u256 v = want_mod ? r : q;
  return negate ? u256_neg(v) : v;
}

__device__ __forceinline__ u256 u256_sdiv(const u256& a, const u256& b) {
  return u256_divmod_op(0x05, a, b);
}

__device__ __forceinline__ u256 u256_smod(const u256& a, const u256& b) {
  return u256_divmod_op(0x07, a, b);
}

// ADDMOD (mul false: the 257-bit sum) or MULMOD (the 512-bit product)
// modulo m, one 16-word division; m == 0 -> 0
__device__ __forceinline__ u256 u256_modop(bool mul, const u256& a,
                                           const u256& b, const u256& m) {
  uint32_t x[16];
  if (mul) {
    U256_COUNT(U256_P_MOD1, m.w[0] == 1u && (m.w[1] | m.w[2] | m.w[3] |
                                             m.w[4] | m.w[5] | m.w[6] |
                                             m.w[7]) == 0);
    u256_mul_wide(a, b, x);
  } else {
    uint32_t cf = 0;
    x[0] = u256_add_cc(cf, a.w[0], b.w[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) x[i] = u256_addc_cc(cf, a.w[i], b.w[i]);
    x[8] = u256_addc(cf, 0u, 0u);
    U256_COUNT(U256_P_SUM257, x[8] != 0);
#pragma unroll
    for (int i = 9; i < 16; ++i) x[i] = 0;
  }
  u256 r;
  words_divrem<16, false>(x, m, nullptr, &r);
  return r;
}

__device__ __forceinline__ u256 u256_addmod(const u256& a, const u256& b,
                                            const u256& m) {
  return u256_modop(false, a, b, m);
}

__device__ __forceinline__ u256 u256_mulmod(const u256& a, const u256& b,
                                            const u256& m) {
  return u256_modop(true, a, b, m);
}

// ------------------------------------------------------ EXP

// b ** e mod 2^256, square-and-multiply over e's bit length (the bit's
// word picked by the select tree; squarings by u256_sqr, none after the
// top bit)
__device__ __forceinline__ u256 u256_exp(const u256& b, const u256& e) {
  u256 res = u256_small(1), cur = b;
  const int nb = u256_bit_length(e);
  for (int i = 0; i < nb; ++i) {
    if ((u256_word_at(e, i >> 5) >> (i & 31)) & 1u) res = u256_mul(res, cur);
    if (i + 1 < nb) cur = u256_sqr(cur);
  }
  return res;
}
