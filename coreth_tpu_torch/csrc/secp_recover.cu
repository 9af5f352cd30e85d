// Batched secp256k1 public-key recovery ladder for Hopper (sm_90a).
//
// Replaces the reference's jitted device program
//   coreth_tpu/ops/secp.py:384 recover_kernel
//   (with _shamir:345, _mixed_add:298, pt_double:281, fe_*, _carry:81).
// Per signature: y = sqrt(x^3 + 7), parity select, the G+R table entry
// (one Fermat inversion), then the 256-step Shamir ladder u1*G + u2*R,
// MSB first, with the reference's exact doubling and mixed-add formulas
// and its collision / infinity rules.  Outputs are canonical mod p, so
// every row matches the JAX kernel and the plain PyTorch version
// (coreth_tpu_torch/ops/secp.py recover_kernel_plain) byte for byte.
//
// Design: one thread per signature.  The reference used 20 x 13-bit
// limbs because the TPU's vector unit has no 64-bit product; here a
// field element is 8 x 32-bit words with 32x32->64 products and the
// p = 2^256 - 2^32 - 977 fold, every value kept canonical in [0, p).
//
// Bound: integer multiply throughput.  About 5.6k field multiplies per
// signature (18 per ladder step x 256, plus ~500 each for the square
// root and the inversion), each 64 word products plus ~20 for the fold.
// Nothing is shared between threads, and the state (a Jacobian point and
// four affine addends) lives in registers; device memory sees only the
// 77 input and 102 output bytes per signature.
//
// Inputs: x (B,33) uint8 little-endian x coordinates (< 2^257: the host
// prep emits r or r + n); parity (B,) int32; u1w, u2w (B,8) int32 words
// of the little-endian scalars, read as uint32.
// Output: (B,102) uint8 = X(33) ++ Y(33) ++ Z(33) canonical Jacobian
// little-endian ++ [inf, collision, is_residue].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct fe {
  uint32_t w[8];
};

__constant__ uint32_t kP[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                               0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                               0xFFFFFFFFu, 0xFFFFFFFFu};
// (p + 1) / 4: the square root of a residue when p = 3 mod 4
__constant__ uint32_t kSqrtExp[8] = {0xBFFFFF0Cu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                     0xFFFFFFFFu, 0x3FFFFFFFu};
// p - 2: Fermat inversion
__constant__ uint32_t kInvExp[8] = {0xFFFFFC2Du, 0xFFFFFFFEu, 0xFFFFFFFFu,
                                    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                    0xFFFFFFFFu, 0xFFFFFFFFu};
__constant__ uint32_t kGx[8] = {0x16F81798u, 0x59F2815Bu, 0x2DCE28D9u,
                                0x029BFCDBu, 0xCE870B07u, 0x55A06295u,
                                0xF9DCBBACu, 0x79BE667Eu};
__constant__ uint32_t kGy[8] = {0xFB10D4B8u, 0x9C47D08Fu, 0xA6855419u,
                                0xFD17B448u, 0x0E1108A8u, 0x5DA4FBFCu,
                                0x26A3C465u, 0x483ADA77u};
// affine 2G, for the R == G corner of the G+R entry
__constant__ uint32_t kG2x[8] = {0x5C709EE5u, 0xABAC09B9u, 0x8CEF3CA7u,
                                 0x5C778E4Bu, 0x95C07CD8u, 0x3045406Eu,
                                 0x41ED7D6Du, 0xC6047F94u};
__constant__ uint32_t kG2y[8] = {0x50CFE52Au, 0x236431A9u, 0x3266D0E1u,
                                 0xF7F63265u, 0x466CEAEEu, 0xA3C58419u,
                                 0xA63DC339u, 0x1AE168FEu};

__device__ __forceinline__ fe fe_const(const uint32_t* c) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c[i];
  return r;
}

__device__ __forceinline__ fe fe_small(uint32_t v) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  r.w[0] = v;
  return r;
}

// r - p when r >= p (r < 2p on entry); `carry` is a 2^256 bit above r.
__device__ __forceinline__ void fe_cond_sub_p(fe& r, uint32_t carry) {
  fe t;
  int64_t b = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t d = (int64_t)r.w[i] - (int64_t)kP[i] + b;
    t.w[i] = (uint32_t)d;
    b = d >> 32;  // 0 or -1
  }
  if (carry || b == 0) r = t;
}

// r + top * 2^256 (top < 2^34) reduced to [0, p): 2^256 = 2^32 + 977.
__device__ __forceinline__ void fe_fold_top(fe& r, uint64_t top) {
  uint64_t c = (uint64_t)r.w[0] + top * 977u;
  r.w[0] = (uint32_t)c;
  c >>= 32;
  c += (uint64_t)r.w[1] + top;
  r.w[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    c += r.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  if (c) {
    // wrapped past 2^256 again: r is now tiny, fold the single bit
    uint64_t d = (uint64_t)r.w[0] + 977u;
    r.w[0] = (uint32_t)d;
    d = (d >> 32) + (uint64_t)r.w[1] + 1u;
    r.w[1] = (uint32_t)d;
    d >>= 32;
#pragma unroll
    for (int i = 2; i < 8; ++i) {
      d += r.w[i];
      r.w[i] = (uint32_t)d;
      d >>= 32;
    }
  }
  fe_cond_sub_p(r, 0);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_cond_sub_p(r, (uint32_t)c);
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
  int64_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t d = (int64_t)a.w[i] - (int64_t)b.w[i] + bw;
    r.w[i] = (uint32_t)d;
    bw = d >> 32;
  }
  if (bw) {  // a < b: add p back (mod 2^256)
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c += (uint64_t)r.w[i] + kP[i];
      r.w[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return r;
}

__device__ __noinline__ fe fe_mul(fe a, fe b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.w[i] * b.w[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // L + H * 2^256 = L + H * 977 + (H << 32)  (mod p)
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)t[i] + (uint64_t)t[i + 8] * 977u;
    if (i > 0) c += t[i + 7];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  c += t[15];
  fe_fold_top(r, c);
  return r;
}

__device__ __forceinline__ fe fe_sq(const fe& a) { return fe_mul(a, a); }

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a.w[i];
  return o == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a.w[i] ^ b.w[i];
  return o == 0;
}

// base^e for a constant exponent, MSB first (the bit schedule is the
// same for every thread, so the branch never diverges)
__device__ fe fe_pow(const fe& base, const uint32_t* e) {
  fe acc = fe_small(1);
  for (int i = 255; i >= 0; --i) {
    acc = fe_sq(acc);
    if ((e[i >> 5] >> (i & 31)) & 1u) acc = fe_mul(acc, base);
  }
  return acc;
}

// Jacobian doubling, a = 0 (reference pt_double, same formula order)
__device__ __forceinline__ void pt_double(fe& X, fe& Y, fe& Z) {
  fe A = fe_sq(X);
  fe Bb = fe_sq(Y);
  fe C = fe_sq(Bb);
  fe t = fe_sub(fe_sub(fe_sq(fe_add(X, Bb)), A), C);
  fe D = fe_add(t, t);
  fe E = fe_add(fe_add(A, A), A);
  fe F = fe_sq(E);
  fe nX = fe_sub(F, fe_add(D, D));
  fe C2 = fe_add(C, C);
  fe C8 = fe_add(fe_add(C2, C2), fe_add(C2, C2));
  fe nY = fe_sub(fe_mul(E, fe_sub(D, nX)), C8);
  fe nZ = fe_mul(fe_add(Y, Y), Z);
  X = nX;
  Y = nY;
  Z = nZ;
}

// Jacobian += affine with the reference's selection rules
// (_mixed_add): returns true on a doubling collision (addend == acc).
__device__ __forceinline__ bool mixed_add(fe& X, fe& Y, fe& Z, bool& inf,
                                          const fe& ax, const fe& ay,
                                          bool a_inf, bool doit) {
  bool eff = doit && !a_inf;
  if (!eff) return false;
  if (inf) {  // inf + Q = Q
    X = ax;
    Y = ay;
    Z = fe_small(1);
    inf = false;
    return false;
  }
  fe z1z1 = fe_sq(Z);
  fe u2 = fe_mul(ax, z1z1);
  fe s2 = fe_mul(ay, fe_mul(Z, z1z1));
  fe h = fe_sub(u2, X);
  fe r = fe_sub(s2, Y);
  bool h0 = fe_is_zero(h);
  bool r0 = fe_is_zero(r);
  fe hh = fe_sq(h);
  fe hhh = fe_mul(h, hh);
  fe v = fe_mul(X, hh);
  fe nx = fe_sub(fe_sub(fe_sq(r), hhh), fe_add(v, v));
  fe ny = fe_sub(fe_mul(r, fe_sub(v, nx)), fe_mul(Y, hhh));
  fe nz = fe_mul(Z, h);
  X = nx;
  Y = ny;
  Z = nz;
  inf = h0 && !r0;  // addend == -acc
  return h0 && r0;
}

__device__ __forceinline__ void store_fe(uint8_t* out, const fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[4 * i + 0] = (uint8_t)(a.w[i]);
    out[4 * i + 1] = (uint8_t)(a.w[i] >> 8);
    out[4 * i + 2] = (uint8_t)(a.w[i] >> 16);
    out[4 * i + 3] = (uint8_t)(a.w[i] >> 24);
  }
  out[32] = 0;
}

__global__ void __launch_bounds__(32)
secp_recover_kernel(const uint8_t* __restrict__ xb,
                    const int32_t* __restrict__ parity,
                    const uint32_t* __restrict__ u1w,
                    const uint32_t* __restrict__ u2w,
                    uint8_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* xr = xb + 33 * (int64_t)row;
  // x mod p, from bits 0..259 like the reference's 20 x 13-bit unpack
  fe x;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x.w[i] = (uint32_t)xr[4 * i] | ((uint32_t)xr[4 * i + 1] << 8) |
             ((uint32_t)xr[4 * i + 2] << 16) |
             ((uint32_t)xr[4 * i + 3] << 24);
  fe_fold_top(x, xr[32] & 0xFu);

  fe ysq = fe_add(fe_mul(fe_mul(x, x), x), fe_small(7));
  fe y = fe_pow(ysq, kSqrtExp);
  bool residue = fe_eq(fe_sq(y), ysq);
  if ((int32_t)(y.w[0] & 1u) != parity[row]) y = fe_sub(fe_small(0), y);

  // G + R, affine: general case by Fermat inversion; R == G -> 2G;
  // R == -G -> the infinity flag
  fe gx = fe_const(kGx), gy = fe_const(kGy);
  fe dx = fe_sub(x, gx);
  bool x_eq = fe_is_zero(dx);
  fe lam = fe_mul(fe_sub(y, gy), fe_pow(dx, kInvExp));
  fe gqx = fe_sub(fe_sub(fe_mul(lam, lam), gx), x);
  fe gqy = fe_sub(fe_mul(lam, fe_sub(gx, gqx)), gy);
  bool y_eq = fe_is_zero(fe_sub(y, gy));
  if (x_eq && y_eq) {
    gqx = fe_const(kG2x);
    gqy = fe_const(kG2y);
  }
  bool gq_inf = x_eq && !y_eq;

  uint32_t s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s1[i] = u1w[8 * (int64_t)row + i];
    s2[i] = u2w[8 * (int64_t)row + i];
  }
  fe X = fe_small(0), Y = fe_small(0), Z = fe_small(0);
  bool inf = true, bad = false;
  for (int pos = 255; pos >= 0; --pos) {
    pt_double(X, Y, Z);
    uint32_t b1 = (s1[pos >> 5] >> (pos & 31)) & 1u;
    uint32_t b2 = (s2[pos >> 5] >> (pos & 31)) & 1u;
    bool both = b1 & b2;
    const fe& ax = both ? gqx : (b2 ? x : gx);
    const fe& ay = both ? gqy : (b2 ? y : gy);
    bad |= mixed_add(X, Y, Z, inf, ax, ay, both && gq_inf, (b1 | b2) != 0);
  }

  uint8_t* o = out + 102 * (int64_t)row;
  store_fe(o, X);
  store_fe(o + 33, Y);
  store_fe(o + 66, Z);
  o[99] = inf;
  o[100] = bad;
  o[101] = residue;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
extern "C" int secp_recover_launch(const void* xb, const void* parity,
                                   const void* u1w, const void* u2w,
                                   void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 32;  // one warp per block: 128 blocks at 4096 rows
  int blocks = (n + threads - 1) / threads;
  secp_recover_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xb, (const int32_t*)parity, (const uint32_t*)u1w,
      (const uint32_t*)u2w, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
