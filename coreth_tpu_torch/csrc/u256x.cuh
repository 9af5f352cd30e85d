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
// Callers: the step-machine kernel (step_machine.cu) for its arithmetic
// families, and the standalone launch entry u256x_eval.cu, which holds
// each op against the plain PyTorch version (coreth_tpu_torch/ops/
// u256x.py).
//
// Cost: MUL is 36 word products; DIV/MOD/SDIV/SMOD are bit-serial
// restoring division (one shift, compare and subtract per dividend bit,
// from the dividend's top set bit); ADDMOD/MULMOD divide a 288- or
// 512-bit value the same way; EXP is square-and-multiply over the
// exponent's bit length.  Everything stays in registers.

#pragma once

#include <cstdint>

struct u256 {
  uint32_t w[8];
};

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

// big-endian byte j (0 = most significant) of a word
__device__ __forceinline__ uint32_t u256_be_byte(const u256& a, int j) {
  int p = 31 - j;  // little-endian byte position
  return (a.w[p >> 2] >> ((p & 3) * 8)) & 0xFFu;
}

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

// unsigned a < b
__device__ __forceinline__ bool u256_lt(const u256& a, const u256& b) {
  for (int i = 7; i >= 0; --i)
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  return false;
}

__device__ __forceinline__ bool u256_slt(const u256& a, const u256& b) {
  u256 x = a, y = b;
  x.w[7] ^= 0x80000000u;
  y.w[7] ^= 0x80000000u;
  return u256_lt(x, y);
}

__device__ __forceinline__ u256 u256_add(const u256& a, const u256& b) {
  u256 r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

__device__ __forceinline__ u256 u256_sub(const u256& a, const u256& b) {
  u256 r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)a.w[i] - b.w[i] - borrow;
    r.w[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return r;
}

__device__ __forceinline__ u256 u256_neg(const u256& a) {
  return u256_sub(u256_zero(), a);
}

__device__ __forceinline__ bool u256_sign(const u256& a) {
  return (a.w[7] >> 31) != 0;
}

__device__ __forceinline__ u256 u256_abs(const u256& a) {
  return u256_sign(a) ? u256_neg(a) : a;
}

__device__ __forceinline__ u256 u256_not(const u256& a) {
  u256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = ~a.w[i];
  return r;
}

// a * b mod 2^256
__device__ __forceinline__ u256 u256_mul(const u256& a, const u256& b) {
  u256 r = u256_zero();
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
    for (int j = 0; i + j < 8; ++j) {
      uint64_t t = (uint64_t)a.w[i] * b.w[j] + r.w[i + j] + carry;
      r.w[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return r;
}

// full 512-bit product, 16 little-endian words
__device__ __forceinline__ void u256_mul_wide(const u256& a, const u256& b,
                                              uint32_t out[16]) {
  for (int i = 0; i < 16; ++i) out[i] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
    for (int j = 0; j < 8; ++j) {
      uint64_t t = (uint64_t)a.w[i] * b.w[j] + out[i + j] + carry;
      out[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    out[i + 8] = (uint32_t)carry;
  }
}

__device__ __forceinline__ int words_bit_length(const uint32_t* x, int n) {
  for (int i = n - 1; i >= 0; --i)
    if (x[i]) return 32 * i + 32 - __clz(x[i]);
  return 0;
}

__device__ __forceinline__ int u256_bit_length(const u256& a) {
  return words_bit_length(a.w, 8);
}

// x (n words) mod m by restoring division, MSB first; m == 0 -> 0.
// With q != nullptr also the quotient (valid when it fits 256 bits).
__device__ u256 words_mod(const uint32_t* x, int n, const u256& m, u256* q) {
  u256 r = u256_zero();
  if (q) *q = u256_zero();
  if (u256_is_zero(m)) return r;
  for (int bit = words_bit_length(x, n) - 1; bit >= 0; --bit) {
    uint32_t top = r.w[7] >> 31;
#pragma unroll
    for (int i = 7; i > 0; --i) r.w[i] = (r.w[i] << 1) | (r.w[i - 1] >> 31);
    r.w[0] = (r.w[0] << 1) | ((x[bit >> 5] >> (bit & 31)) & 1u);
    if (top || !u256_lt(r, m)) {
      r = u256_sub(r, m);
      if (q && bit < 256) q->w[bit >> 5] |= 1u << (bit & 31);
    }
  }
  return r;
}

// (a / b, a % b); b == 0 -> (0, 0)
__device__ __forceinline__ void u256_divmod(const u256& a, const u256& b,
                                            u256* q, u256* r) {
  *r = words_mod(a.w, 8, b, q);
}

__device__ __forceinline__ u256 u256_sdiv(const u256& a, const u256& b) {
  u256 q, r;
  u256_divmod(u256_abs(a), u256_abs(b), &q, &r);
  return (u256_sign(a) != u256_sign(b)) ? u256_neg(q) : q;
}

__device__ __forceinline__ u256 u256_smod(const u256& a, const u256& b) {
  u256 q, r;
  u256_divmod(u256_abs(a), u256_abs(b), &q, &r);
  return u256_sign(a) ? u256_neg(r) : r;
}

// (a + b) % m over the 257-bit sum
__device__ __forceinline__ u256 u256_addmod(const u256& a, const u256& b,
                                            const u256& m) {
  uint32_t s[9];
  uint64_t c = 0;
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  s[8] = (uint32_t)c;
  return words_mod(s, 9, m, nullptr);
}

// (a * b) % m over the 512-bit product
__device__ __forceinline__ u256 u256_mulmod(const u256& a, const u256& b,
                                            const u256& m) {
  uint32_t p[16];
  u256_mul_wide(a, b, p);
  return words_mod(p, 16, m, nullptr);
}

// b ** e mod 2^256, square-and-multiply over e's bit length
__device__ __forceinline__ u256 u256_exp(const u256& b, const u256& e) {
  u256 res = u256_small(1), cur = b;
  int nb = u256_bit_length(e);
  for (int i = 0; i < nb; ++i) {
    if ((e.w[i >> 5] >> (i & 31)) & 1u) res = u256_mul(res, cur);
    cur = u256_mul(cur, cur);
  }
  return res;
}

// shift amount >= 256?  (else *s holds it)
__device__ __forceinline__ bool u256_shift_over(const u256& n, int* s) {
  for (int i = 1; i < 8; ++i)
    if (n.w[i]) return true;
  if (n.w[0] > 255) return true;
  *s = (int)n.w[0];
  return false;
}

// x << n
__device__ __forceinline__ u256 u256_shl(const u256& x, const u256& n) {
  int s;
  if (u256_shift_over(n, &s)) return u256_zero();
  u256 r;
  int ws = s >> 5, bs = s & 31;
  for (int i = 7; i >= 0; --i) {
    int k = i - ws;
    uint32_t hi = k >= 0 ? x.w[k] : 0;
    uint32_t lo = k - 1 >= 0 ? x.w[k - 1] : 0;
    r.w[i] = bs ? (hi << bs) | (lo >> (32 - bs)) : hi;
  }
  return r;
}

// x >> n (logical)
__device__ __forceinline__ u256 u256_shr(const u256& x, const u256& n) {
  int s;
  if (u256_shift_over(n, &s)) return u256_zero();
  u256 r;
  int ws = s >> 5, bs = s & 31;
  for (int i = 0; i < 8; ++i) {
    int k = i + ws;
    uint32_t lo = k < 8 ? x.w[k] : 0;
    uint32_t hi = k + 1 < 8 ? x.w[k + 1] : 0;
    r.w[i] = bs ? (lo >> bs) | (hi << (32 - bs)) : lo;
  }
  return r;
}

// x >> n (arithmetic)
__device__ __forceinline__ u256 u256_sar(const u256& x, const u256& n) {
  bool neg = u256_sign(x);
  int s;
  if (u256_shift_over(n, &s)) return neg ? u256_not(u256_zero()) : u256_zero();
  u256 r = u256_shr(x, n);
  if (neg && s > 0) {
    // set bits [256 - s, 256)
    for (int bit = 256 - s; bit < 256; ++bit)
      r.w[bit >> 5] |= 1u << (bit & 31);
  }
  return r;
}

// BYTE: big-endian byte i of x, 0 when i >= 32
__device__ __forceinline__ u256 u256_byte(const u256& i, const u256& x) {
  int s;
  if (u256_shift_over(i, &s) || s > 31) return u256_zero();
  return u256_small(u256_be_byte(x, s));
}

// SIGNEXTEND from byte b (0 = lowest); b >= 31 leaves x unchanged
__device__ __forceinline__ u256 u256_signextend(const u256& b,
                                                const u256& x) {
  int s;
  if (u256_shift_over(b, &s) || s > 30) return x;
  int t = 8 * s + 7;  // sign bit position
  bool neg = (x.w[t >> 5] >> (t & 31)) & 1u;
  u256 r;
  for (int i = 0; i < 8; ++i) {
    int lo = 32 * i;  // bits [lo, lo + 32) of word i
    uint32_t keep;
    if (t + 1 >= lo + 32) keep = 0xFFFFFFFFu;
    else if (t + 1 <= lo) keep = 0;
    else keep = (1u << (t + 1 - lo)) - 1u;
    r.w[i] = neg ? (x.w[i] | ~keep) : (x.w[i] & keep);
  }
  return r;
}
