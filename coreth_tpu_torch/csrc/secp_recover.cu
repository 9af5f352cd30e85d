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
// Design: a group of G threads of one warp per signature (G = SECP_G = 4;
// G = 8, one word a thread, measured slower on an H100; G = 1 is the
// one-thread form the tests' host build compiles with -DSECP_G=1).  A field element is 8 x 32-bit words; thread
// t of the group holds the W = 8 / G words [tW, tW + W) (its "digit").
// Values are kept weakly reduced: any 256-bit representative, canonical
// mod p only where a value is compared (is_zero, the parity of y) or
// emitted, which gives the same field values as the reference's canonical
// arithmetic.
//
// - Multiply: column-wise.  Thread t owns product digits t and t + G; in
//   G rounds it takes a's digit (t + 1 + q) mod G (shuffled, rotating) and
//   b's digit G - 1 - q (broadcast) and accumulates their W x W product
//   with PTX carry chains (mad.lo.cc / madc.hi.cc / addc); the sum before
//   round G - 1 - t is digit t + G's, the rest digit t's.  Then
//   (fold_wide) in three rounds: each column sum's middle digit
//   goes one thread up and its top word two, the carries (<= 2) stay
//   pending; the fold 2^256 = 2^32 + 977 (low + 977 * high + (high << 32)
//   per digit) takes the pending carries in, and its own carries, with the
//   top digit's shifted-out word added back as c * (2^32 + 977), leave
//   every digit at most one carry bit, resolved across the group with two
//   ballots (carry generate and propagate masks added as integers); a
//   last wrap out of 2^256 resolves only when some group of the warp has
//   one.
// - Add / subtract: per-thread chains and one resolve; the wrap they may
//   need lands in the low words, and its carry (rare) resolves only when
//   a group of the warp has one.
// - Independent multiplies, adds and subtracts run two at a time,
//   interleaved stage by stage (fe_mul_n, fe_addsub_n), so their
//   shuffles' and votes' latencies overlap: a ladder step's 18 multiplies
//   are 9 rounds of one inlined two-product multiply (ladder_step).
// - Square root and inversion: the fixed addition chains of libsecp256k1
//   for (p + 1) / 4 (253 squarings, 13 multiplies) and p - 2 (255, 15)
//   in place of a binary ladder over the exponent bits, run side by side
//   (the inversion needs only x) as one pair of chains up to x^(2^223-1).
// - The ladder runs the same code in every group: each step doubles and
//   computes the mixed add, then selects by the reference's rules (both
//   bits: G+R, b2: R, else G; a gq_inf addend skipped; inf + Q = Q; the
//   collision flag h0 && r0), so the warp never diverges: every shuffle
//   and vote names the whole warp.
// - Blocks of SECP_BLOCK = 128 threads (four warps, one a scheduler): at
//   G = 4 a 4096-signature chunk is 512 warps, ~3.9 an SM; K8r's
//   1,024-signature launches a quarter of that each.
//
// What bounds it on this card: latency, not issue.  A multiply is ~10
// dependent rounds of shuffles, votes and carry chains (secp_ops.py
// times each operation), and one warp a scheduler has little else to
// issue meanwhile.
//
// Bound (chip_smoke.py ladder_imads): integer multiply throughput, the
// word products of the function's multiplies (64) and squarings (36).
// Device memory sees only the 77 input and 102
// output bytes per signature.
//
// Inputs: x (B,33) uint8 little-endian x coordinates (< 2^257: the host
// prep emits r or r + n); parity (B,) int32; u1w, u2w (B,8) int32 words
// of the little-endian scalars, read as uint32.
// Output: (B,102) uint8 = X(33) ++ Y(33) ++ Z(33) canonical Jacobian
// little-endian ++ [inf, collision, is_residue].

#include <cstdint>
#include <cuda_runtime.h>

#ifndef SECP_G
#define SECP_G 4
#endif
#ifndef SECP_BLOCK
#define SECP_BLOCK 128
#endif

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

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

// ------------------------------------------------------ carry chains
// On the card each helper is one PTX instruction on CC.CF (mad.lo.cc /
// madc.hi.cc / addc ...; asm volatile keeps their order) and cf is
// unused; the host build of the tests (SECP_HOST_BUILD) threads the same
// carry through cf.
#ifdef SECP_HOST_BUILD
__device__ __forceinline__ uint32_t add_cc(uint32_t& cf, uint32_t a,
                                           uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t& cf, uint32_t a,
                                            uint32_t b) {
  const uint64_t s = (uint64_t)a + b + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t addc(uint32_t& cf, uint32_t a,
                                         uint32_t b) {
  return a + b + cf;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t& cf, uint32_t a,
                                           uint32_t b) {
  cf = a < b;
  return a - b;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t& cf, uint32_t a,
                                            uint32_t b) {
  const uint64_t t = (uint64_t)b + cf;
  cf = (uint64_t)a < t;
  return (uint32_t)((uint64_t)a - t);
}
__device__ __forceinline__ uint32_t subc(uint32_t& cf, uint32_t a,
                                         uint32_t b) {
  return a - b - cf;
}
__device__ __forceinline__ uint32_t hi32(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t& cf, uint32_t a,
                                              uint32_t b, uint32_t c) {
  return add_cc(cf, a * b, c);
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t& cf, uint32_t a,
                                               uint32_t b, uint32_t c) {
  return addc_cc(cf, a * b, c);
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t& cf, uint32_t a,
                                              uint32_t b, uint32_t c) {
  return add_cc(cf, hi32(a, b), c);
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t& cf, uint32_t a,
                                               uint32_t b, uint32_t c) {
  return addc_cc(cf, hi32(a, b), c);
}
#else
#define SECP_OP2(name, ins)                                          \
  __device__ __forceinline__ uint32_t name(uint32_t&, uint32_t a,    \
                                           uint32_t b) {             \
    uint32_t r;                                                      \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));     \
    return r;                                                        \
  }
#define SECP_OP3(name, ins)                                          \
  __device__ __forceinline__ uint32_t name(uint32_t&, uint32_t a,    \
                                           uint32_t b, uint32_t c) { \
    uint32_t r;                                                      \
    asm volatile(ins " %0, %1, %2, %3;"                              \
                 : "=r"(r)                                           \
                 : "r"(a), "r"(b), "r"(c));                          \
    return r;                                                        \
  }
SECP_OP2(add_cc, "add.cc.u32")
SECP_OP2(addc_cc, "addc.cc.u32")
SECP_OP2(addc, "addc.u32")
SECP_OP2(sub_cc, "sub.cc.u32")
SECP_OP2(subc_cc, "subc.cc.u32")
SECP_OP2(subc, "subc.u32")
SECP_OP3(mad_lo_cc, "mad.lo.cc.u32")
SECP_OP3(madc_lo_cc, "madc.lo.cc.u32")
SECP_OP3(mad_hi_cc, "mad.hi.cc.u32")
SECP_OP3(madc_hi_cc, "madc.hi.cc.u32")
#undef SECP_OP2
#undef SECP_OP3
#endif

// ------------------------------------------------------------ the group
// Every shuffle and vote names the whole warp, so every thread of a warp
// runs the same sequence of them: no shuffle or vote sits under a branch
// or a short-circuit operator that groups could take differently.
template <int G>
struct Grp {
  static_assert(G == 1 || G == 2 || G == 4, "a digit holds two words or more");
  static constexpr int W = 8 / G;
  int t;  // this thread's place in its group
  // v of the group's thread src (in [0, G))
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    if constexpr (G == 1)
      return v;
    else
      return __shfl_sync(FULL, v, src, G);
  }
  // bit i: p of the group's thread i
  __device__ __forceinline__ uint32_t ballot(bool p) const {
    if constexpr (G == 1)
      return p ? 1u : 0u;
    else
      return (__ballot_sync(FULL, p) >> ((threadIdx.x & 31) & ~(G - 1))) &
             ((1u << G) - 1);
  }
};

template <int G>
struct Fe {
  uint32_t w[8 / G];
};

// word j of p = 2^256 - 2^32 - 977
__device__ __forceinline__ uint32_t p_word(int j) {
  return j == 0 ? 0xFFFFFC2Fu : (j == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
}

// word j of the three-word constant k (zero past it)
__device__ __forceinline__ uint32_t k_word(int j, uint32_t k0, uint32_t k1,
                                           uint32_t k2) {
  return j == 0 ? k0 : (j == 1 ? k1 : (j == 2 ? k2 : 0u));
}

template <int G>
__device__ __forceinline__ Fe<G> fe_const(const Grp<G>& g,
                                          const uint32_t* c) {
  Fe<G> r;
#pragma unroll
  for (int i = 0; i < Grp<G>::W; ++i) r.w[i] = c[g.t * Grp<G>::W + i];
  return r;
}

template <int G>
__device__ __forceinline__ Fe<G> fe_small(const Grp<G>& g, uint32_t v) {
  Fe<G> r;
#pragma unroll
  for (int i = 0; i < Grp<G>::W; ++i) r.w[i] = 0;
  r.w[0] = g.t == 0 ? v : 0u;
  return r;
}

template <int G>
__device__ __forceinline__ Fe<G> sel(bool c, const Fe<G>& a,
                                     const Fe<G>& b) {
  Fe<G> r;
#pragma unroll
  for (int i = 0; i < Grp<G>::W; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// x += c (c < 2^32) over the thread's words; returns the carry out
template <int W>
__device__ __forceinline__ uint32_t add_small(uint32_t* x, uint32_t c) {
  uint32_t cf = 0;
  x[0] = add_cc(cf, x[0], c);
#pragma unroll
  for (int i = 1; i < W; ++i) x[i] = addc_cc(cf, x[i], 0u);
  return addc(cf, 0u, 0u);
}

template <int W>
__device__ __forceinline__ bool all_ones(const uint32_t* x) {
  uint32_t a = x[0];
#pragma unroll
  for (int i = 1; i < W; ++i) a &= x[i];
  return a == FULL;
}

template <int W>
__device__ __forceinline__ bool all_zero(const uint32_t* x) {
  uint32_t o = x[0];
#pragma unroll
  for (int i = 1; i < W; ++i) o |= x[i];
  return o == 0;
}

// Carry resolution across the group: thread i's digit generated a carry
// (gen) or is all ones (propagates one); the carries each digit receives
// are ((P + (Gm << 1)) ^ P), bit G the carry out of 2^256 (returned).
template <int G>
__device__ __forceinline__ uint32_t resolve_add(const Grp<G>& g, Fe<G>& x,
                                                uint32_t gen) {
  const uint32_t Gm = g.ballot(gen != 0);
  const uint32_t Pm = g.ballot(all_ones<Grp<G>::W>(x.w));
  const uint32_t R = (Pm + (Gm << 1)) ^ Pm;
  add_small<Grp<G>::W>(x.w, (R >> g.t) & 1u);
  return (R >> G) & 1u;
}

// the same for borrows: a zero digit propagates one
template <int G>
__device__ __forceinline__ uint32_t resolve_sub(const Grp<G>& g, Fe<G>& x,
                                                uint32_t brw) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  const uint32_t Gm = g.ballot(brw != 0);
  const uint32_t Pm = g.ballot(all_zero<W>(x.w));
  const uint32_t R = (Pm + (Gm << 1)) ^ Pm;
  x.w[0] = sub_cc(cf, x.w[0], (R >> g.t) & 1u);
#pragma unroll
  for (int i = 1; i < W; ++i) x.w[i] = subc_cc(cf, x.w[i], 0u);
  return (R >> G) & 1u;
}

// resolve_add / resolve_sub for N values at once (bit k of SUBS: value k
// is a difference): every vote first
template <int G, int N, unsigned SUBS>
__device__ __forceinline__ void resolve_n(const Grp<G>& g, Fe<G>* x,
                                          const uint32_t* gen,
                                          uint32_t* top) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  uint32_t Gm[N], Pm[N];
#pragma unroll
  for (int k = 0; k < N; ++k) Gm[k] = g.ballot(gen[k] != 0);
#pragma unroll
  for (int k = 0; k < N; ++k)
    Pm[k] = g.ballot((SUBS >> k) & 1u ? all_zero<W>(x[k].w)
                                      : all_ones<W>(x[k].w));
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t R = (Pm[k] + (Gm[k] << 1)) ^ Pm[k];
    const uint32_t c = (R >> g.t) & 1u;
    if ((SUBS >> k) & 1u) {
      x[k].w[0] = sub_cc(cf, x[k].w[0], c);
#pragma unroll
      for (int i = 1; i < W; ++i) x[k].w[i] = subc_cc(cf, x[k].w[i], 0u);
    } else {
      add_small<W>(x[k].w, c);
    }
    top[k] = (R >> G) & 1u;
  }
}

// x += c * 2^256 = c * (2^32 + 977) (mod p) for c < 2^34: the 256-bit sum,
// returns its carry out of 2^256
template <int G>
__device__ __forceinline__ uint32_t add_wrap(const Grp<G>& g, Fe<G>& x,
                                             uint64_t c) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  const uint64_t m = c * 977u;
  const uint64_t u = (m >> 32) + (c & 0xFFFFFFFFu);
  const uint32_t k0 = (uint32_t)m, k1 = (uint32_t)u;
  const uint32_t k2 = (uint32_t)(u >> 32) + (uint32_t)(c >> 32);
  x.w[0] = add_cc(cf, x.w[0], k_word(g.t * W, k0, k1, k2));
#pragma unroll
  for (int i = 1; i < W; ++i)
    x.w[i] = addc_cc(cf, x.w[i], k_word(g.t * W + i, k0, k1, k2));
  return resolve_add(g, x, addc(cf, 0u, 0u));
}

// add c * 2^256 back; a second wrap leaves a value below 2^68, so a third
// cannot happen
template <int G>
__device__ __forceinline__ void wrap_fix(const Grp<G>& g, Fe<G>& x,
                                         uint64_t c) {
  const uint32_t top = add_wrap(g, x, c);
  if (__any_sync(FULL, top != 0)) add_wrap(g, x, top);
}

// x -= b * 2^256 = b * (2^32 + 977) (mod p), b in {0, 1}; returns the
// borrow out of the 256-bit difference
template <int G>
__device__ __forceinline__ uint32_t sub_wrap(const Grp<G>& g, Fe<G>& x,
                                             uint32_t b) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  const uint32_t k0 = 977u * b, k1 = b;
  x.w[0] = sub_cc(cf, x.w[0], k_word(g.t * W, k0, k1, 0u));
#pragma unroll
  for (int i = 1; i < W; ++i)
    x.w[i] = subc_cc(cf, x.w[i], k_word(g.t * W + i, k0, k1, 0u));
  return resolve_sub(g, x, subc(cf, 0u, 0u) & 1u);
}

// a +/- b for N independent pairs (bit k of SUBS: pair k subtracts),
// interleaved stage by stage (their votes overlap).  The wrap (2^256 = 2^32 + 977 added back, or taken off)
// lands in the low words; its carry or borrow leaves the low digit so
// rarely that the full resolve runs only when some group of the warp
// needs it.
template <int G, int N, unsigned SUBS>
__device__ __forceinline__ void fe_addsub_n(const Grp<G>& g, const Fe<G>* a,
                                            const Fe<G>* b, Fe<G>* r) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  uint32_t top[N], gen[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if ((SUBS >> k) & 1u) {
      r[k].w[0] = sub_cc(cf, a[k].w[0], b[k].w[0]);
#pragma unroll
      for (int i = 1; i < W; ++i) r[k].w[i] = subc_cc(cf, a[k].w[i], b[k].w[i]);
      gen[k] = subc(cf, 0u, 0u) & 1u;
    } else {
      r[k].w[0] = add_cc(cf, a[k].w[0], b[k].w[0]);
#pragma unroll
      for (int i = 1; i < W; ++i) r[k].w[i] = addc_cc(cf, a[k].w[i], b[k].w[i]);
      gen[k] = addc(cf, 0u, 0u);
    }
  }
  resolve_n<G, N, SUBS>(g, r, gen, top);
  bool spill = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t k0 = 977u * top[k], k1 = top[k];
    if ((SUBS >> k) & 1u) {
      r[k].w[0] = sub_cc(cf, r[k].w[0], k_word(g.t * W, k0, k1, 0u));
#pragma unroll
      for (int i = 1; i < W; ++i)
        r[k].w[i] = subc_cc(cf, r[k].w[i], k_word(g.t * W + i, k0, k1, 0u));
      gen[k] = subc(cf, 0u, 0u) & 1u;
    } else {
      r[k].w[0] = add_cc(cf, r[k].w[0], k_word(g.t * W, k0, k1, 0u));
#pragma unroll
      for (int i = 1; i < W; ++i)
        r[k].w[i] = addc_cc(cf, r[k].w[i], k_word(g.t * W + i, k0, k1, 0u));
      gen[k] = addc(cf, 0u, 0u);
    }
    spill = spill || gen[k] != 0;
  }
  if (__any_sync(FULL, spill)) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      // the carry leaves its digit; a second wrap only when b > a + p
      // (subtract) or both >= p (add)
      const bool sub = (SUBS >> k) & 1u;
      const uint32_t t2 = sub ? resolve_sub(g, r[k], gen[k])
                              : resolve_add(g, r[k], gen[k]);
      if (sub)
        sub_wrap(g, r[k], t2);
      else
        add_wrap(g, r[k], t2);
    }
  }
}

template <int G>
__device__ __forceinline__ Fe<G> fe_add(const Grp<G>& g, const Fe<G>& a,
                                        const Fe<G>& b) {
  Fe<G> r;
  fe_addsub_n<G, 1, 0>(g, &a, &b, &r);
  return r;
}

template <int G>
__device__ __forceinline__ Fe<G> fe_sub(const Grp<G>& g, const Fe<G>& a,
                                        const Fe<G>& b) {
  Fe<G> r;
  fe_addsub_n<G, 1, 1>(g, &a, &b, &r);
  return r;
}

// acc (2W + 1 words) += a * b (W words each)
template <int W>
__device__ __forceinline__ void mac(uint32_t* acc, const uint32_t* a,
                                    const uint32_t* b) {
  uint32_t cf = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    acc[i] = mad_lo_cc(cf, a[i], b[0], acc[i]);
#pragma unroll
    for (int j = 1; j < W; ++j) acc[i + j] = madc_lo_cc(cf, a[i], b[j], acc[i + j]);
#pragma unroll
    for (int k = i + W; k < 2 * W; ++k) acc[k] = addc_cc(cf, acc[k], 0u);
    acc[2 * W] = addc(cf, acc[2 * W], 0u);
    acc[i + 1] = mad_hi_cc(cf, a[i], b[0], acc[i + 1]);
#pragma unroll
    for (int j = 1; j < W; ++j)
      acc[i + 1 + j] = madc_hi_cc(cf, a[i], b[j], acc[i + 1 + j]);
#pragma unroll
    for (int k = i + W + 1; k < 2 * W; ++k) acc[k] = addc_cc(cf, acc[k], 0u);
    acc[2 * W] = addc(cf, acc[2 * W], 0u);
  }
}

// The rest of a multiply for digits of W >= 2 words, in three rounds.
// (1) Each column sum's middle W words go one digit up and its top word
// (< G) two digits up, in one round; a digit keeps a carry of at most 2
// for the next, pending.  (2) The fold low + 977 * high + (high << 32)
// takes the pending carries in (a high digit's as 977 * c and c << 32, in
// its own words) and the high words shifted in from the digit below, in
// one round; its carries (< 2^10) and the top digit's, with the word
// shifted out of it (c < 2^33, added back as c * (2^32 + 977) in the
// lowest words), go out in one more.  Every digit then carries at most one
// bit: one resolve.  (3) A wrap out of 2^256 adds 2^32 + 977 to the low
// digit, whose carry out is rare and resolves only when some group of the
// warp has one.
template <int G, int N>
__device__ __forceinline__ void fold_wide(const Grp<G>& g,
                                          uint32_t (*lo)[2 * Grp<G>::W + 1],
                                          uint32_t (*hi)[2 * Grp<G>::W + 1],
                                          Fe<G>* r) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  const int src = (g.t - 1) & (G - 1), src2 = (g.t - 2) & (G - 1);
  const bool first = g.t == 0;
  // (1) digit t: lo + mid of digit t-1 + top of digit t-2
  uint32_t ml[N][W], mh[N][W], tl[N], th[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ml[k][i] = g.shfl(lo[k][W + i], src);
      mh[k][i] = g.shfl(hi[k][W + i], src);
    }
    tl[k] = g.shfl(lo[k][2 * W], src2);
    th[k] = g.shfl(hi[k][2 * W], src2);
  }
  uint32_t xl[N][W], xh[N][W], cl[N], ch[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // high digit t + G: mid from digit t+G-1 (thread 0: low digit G-1),
    // top from digit t+G-2 (threads 0, 1: low digits G-2, G-1)
    const uint32_t top_l = g.t >= 2 ? tl[k] : 0u;
    const uint32_t top_h = g.t >= 2 ? th[k] : (g.t + G >= 2 ? tl[k] : 0u);
    xl[k][0] = add_cc(cf, lo[k][0], first ? 0u : ml[k][0]);
#pragma unroll
    for (int i = 1; i < W; ++i) xl[k][i] = addc_cc(cf, lo[k][i], first ? 0u : ml[k][i]);
    cl[k] = addc(cf, 0u, 0u);
    xl[k][0] = add_cc(cf, xl[k][0], top_l);
#pragma unroll
    for (int i = 1; i < W; ++i) xl[k][i] = addc_cc(cf, xl[k][i], 0u);
    cl[k] = addc(cf, cl[k], 0u);  // <= 2
    xh[k][0] = add_cc(cf, hi[k][0], first ? ml[k][0] : mh[k][0]);
#pragma unroll
    for (int i = 1; i < W; ++i)
      xh[k][i] = addc_cc(cf, hi[k][i], first ? ml[k][i] : mh[k][i]);
    ch[k] = addc(cf, 0u, 0u);
    xh[k][0] = add_cc(cf, xh[k][0], top_h);
#pragma unroll
    for (int i = 1; i < W; ++i) xh[k][i] = addc_cc(cf, xh[k][i], 0u);
    ch[k] = addc(cf, ch[k], 0u);
  }
  // (2) the pending carries in, the fold, and its carries out
  uint32_t icl[N], ich[N], prev[N], sw[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    icl[k] = g.shfl(cl[k], src);
    ich[k] = g.shfl(ch[k], src);
    prev[k] = g.shfl(xh[k][W - 1], src);
    sw[k] = g.shfl(xh[k][W - 1], G - 1);
  }
  uint32_t e[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t cin_l = first ? 0u : icl[k];
    const uint32_t cin_h = first ? icl[k] : ich[k];  // thread 0: digit G-1's
    uint32_t m977[W + 1];
#pragma unroll
    for (int i = 0; i < W; ++i) m977[i] = xh[k][i] * 977u;
    m977[W] = 0;
    m977[1] = mad_hi_cc(cf, xh[k][0], 977u, m977[1]);
#pragma unroll
    for (int i = 1; i < W; ++i)
      m977[i + 1] = madc_hi_cc(cf, xh[k][i], 977u, m977[i + 1]);
    // low + 977 * high
    r[k].w[0] = add_cc(cf, xl[k][0], m977[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) r[k].w[i] = addc_cc(cf, xl[k][i], m977[i]);
    e[k] = addc(cf, m977[W], 0u);
    // + (high << 32): the word from the digit below, then this digit's
    r[k].w[0] = add_cc(cf, r[k].w[0], first ? 0u : prev[k]);
#pragma unroll
    for (int i = 1; i < W; ++i) r[k].w[i] = addc_cc(cf, r[k].w[i], xh[k][i - 1]);
    e[k] = addc(cf, e[k], 0u);
    // + the pending carries: cin_l + 977 * cin_h at word 0, cin_h at 1
    r[k].w[0] = add_cc(cf, r[k].w[0], cin_l + 977u * cin_h);
    r[k].w[1] = addc_cc(cf, r[k].w[1], cin_h);
#pragma unroll
    for (int i = 2; i < W; ++i) r[k].w[i] = addc_cc(cf, r[k].w[i], 0u);
    e[k] = addc(cf, e[k], 0u);  // < 2^10
  }
  uint32_t ein[N], eg[N], gen[N], top[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ein[k] = g.shfl(e[k], src);
    eg[k] = g.shfl(e[k], G - 1);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t c = (uint64_t)sw[k] + eg[k];
    const uint64_t m = c * 977u;
    const uint64_t u = (m >> 32) + (c & 0xFFFFFFFFu);
    const uint32_t k0 = (uint32_t)m, k1 = (uint32_t)u;
    const uint32_t k2 = (uint32_t)(u >> 32) + (uint32_t)(c >> 32);
    r[k].w[0] = add_cc(cf, r[k].w[0], k_word(g.t * W, k0, k1, k2));
#pragma unroll
    for (int i = 1; i < W; ++i)
      r[k].w[i] = addc_cc(cf, r[k].w[i], k_word(g.t * W + i, k0, k1, k2));
    gen[k] = addc(cf, 0u, 0u);
    r[k].w[0] = add_cc(cf, r[k].w[0], first ? 0u : ein[k]);
#pragma unroll
    for (int i = 1; i < W; ++i) r[k].w[i] = addc_cc(cf, r[k].w[i], 0u);
    gen[k] = addc(cf, gen[k], 0u);  // one of the two adds carries at most
  }
  resolve_n<G, N, 0>(g, r, gen, top);
  // (3) the wrap
  bool spill = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    r[k].w[0] = add_cc(cf, r[k].w[0], first ? 977u * top[k] : 0u);
    r[k].w[1] = addc_cc(cf, r[k].w[1], first ? top[k] : 0u);
#pragma unroll
    for (int i = 2; i < W; ++i) r[k].w[i] = addc_cc(cf, r[k].w[i], 0u);
    gen[k] = addc(cf, 0u, 0u);
    spill = spill || gen[k] != 0;
  }
  if (__any_sync(FULL, spill)) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      add_wrap(g, r[k], resolve_add(g, r[k], gen[k]));
  }
}

// r[k] = a[k] * b[k] for N independent products, interleaved stage by
// stage (each stage's shuffles and votes for all N go out together).
template <int G, int N>
__device__ __forceinline__ void fe_mul_n(const Grp<G>& g, const Fe<G>* a,
                                         const Fe<G>* b, Fe<G>* r) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  // product digits t (lo) and t + G (hi): all G rounds accumulate; rounds
  // q < G-1-t pair a digits above t (digit t + G), so the sum before round
  // G-1-t is hi and the rest is lo
  uint32_t lo[N][2 * W + 1], hi[N][2 * W + 1], acc[N][2 * W + 1];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i <= 2 * W; ++i) acc[k][i] = hi[k][i] = 0;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int m = (g.t + 1 + q) & (G - 1);
    uint32_t am[N][W], bn[N][W];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        am[k][i] = g.shfl(a[k].w[i], m);
        bn[k][i] = g.shfl(b[k].w[i], G - 1 - q);
      }
    const bool park = G > 1 && q == G - 1 - g.t;
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = 0; i <= 2 * W; ++i) hi[k][i] = park ? acc[k][i] : hi[k][i];
      mac<W>(acc[k], am[k], bn[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    lo[k][0] = sub_cc(cf, acc[k][0], hi[k][0]);
#pragma unroll
    for (int i = 1; i < 2 * W; ++i) lo[k][i] = subc_cc(cf, acc[k][i], hi[k][i]);
    lo[k][2 * W] = subc(cf, acc[k][2 * W], hi[k][2 * W]);
  }
  fold_wide<G, N>(g, lo, hi, r);
}
// A multiply outside the ladder is a call (one copy of its code), with
// values in and out, so that the call passes registers, not addresses.
template <int G>
struct Fe2 {
  Fe<G> r0, r1;
};

template <int G>
__device__ __noinline__ Fe<G> fe_mul_v(Grp<G> g, Fe<G> a, Fe<G> b) {
  Fe<G> r;
  fe_mul_n<G, 1>(g, &a, &b, &r);
  return r;
}

template <int G>
__device__ __forceinline__ Fe<G> fe_mul(const Grp<G>& g, const Fe<G>& a,
                                        const Fe<G>& b) {
  return fe_mul_v(g, a, b);
}

template <int G>
__device__ __forceinline__ Fe<G> fe_sqr(const Grp<G>& g, const Fe<G>& a) {
  return fe_mul(g, a, a);
}

// the canonical representative in [0, p) (the value is < 2^256 < 2p)
template <int G>
__device__ __forceinline__ Fe<G> fe_canon(const Grp<G>& g, const Fe<G>& x) {
  uint32_t cf = 0;
  constexpr int W = Grp<G>::W;
  Fe<G> d;
  d.w[0] = sub_cc(cf, x.w[0], p_word(g.t * W));
#pragma unroll
  for (int i = 1; i < W; ++i) d.w[i] = subc_cc(cf, x.w[i], p_word(g.t * W + i));
  const uint32_t bt = resolve_sub(g, d, subc(cf, 0u, 0u) & 1u);
  return sel(bt == 0, d, x);
}

// x = 0 (mod p): the weak value is 0 or p
template <int G>
__device__ __forceinline__ bool fe_is_zero(const Grp<G>& g, const Fe<G>& x) {
  constexpr int W = Grp<G>::W;
  constexpr uint32_t all = (1u << G) - 1;
  uint32_t z = 0, q = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    z |= x.w[i];
    q |= x.w[i] ^ p_word(g.t * W + i);
  }
  // both votes in every thread: a vote the warp's other groups skip is
  // undefined
  const uint32_t zm = g.ballot(z == 0), qm = g.ballot(q == 0);
  return zm == all || qm == all;
}

// r0 = a0 +/- b0 and r1 = a1 +/- b1 at once (bit k of SUBS: a subtract)
template <int G, unsigned SUBS>
__device__ __forceinline__ void addsub2(const Grp<G>& g, const Fe<G>& a0,
                                        const Fe<G>& b0, const Fe<G>& a1,
                                        const Fe<G>& b1, Fe<G>& r0,
                                        Fe<G>& r1) {
  const Fe<G> a[2] = {a0, a1}, b[2] = {b0, b1};
  Fe<G> r[2];
  fe_addsub_n<G, 2, SUBS>(g, a, b, r);
  r0 = r[0];
  r1 = r[1];
}

// The addition chains' steps, one copy each, their multiplies inlined:
// x^(2^n) * m for two chains at once, and x^(2^n) (* m) for one.
template <int G>
__device__ __noinline__ Fe2<G> sqr_mul2(Grp<G> g, Fe<G> x0, Fe<G> m0,
                                        Fe<G> x1, Fe<G> m1, int n) {
  Fe<G> x[2] = {x0, x1}, m[2] = {m0, m1}, r[2];
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_mul_n<G, 2>(g, x, x, x);
  fe_mul_n<G, 2>(g, x, m, r);
  return {r[0], r[1]};
}

template <int G>
__device__ __noinline__ Fe<G> sqr_mul1(Grp<G> g, Fe<G> x, int n, Fe<G> m,
                                       bool mul) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_mul_n<G, 1>(g, &x, &x, &x);
  if (mul) fe_mul_n<G, 1>(g, &x, &m, &x);  // uniform across the warp
  return x;
}

// ysq^((p + 1) / 4) (the square root of a residue, p = 3 mod 4) and
// dx^(p - 2) (the Fermat inverse, 0 for 0) by libsecp256k1's chains: both
// build a^(2^k - 1) for k = 2, 3, 6, 9, 11, 22, 44, 88, 176, 220, 223 the
// same way, so the two run as one pair of chains up to there
template <int G>
__device__ __forceinline__ void sqrt_inv(const Grp<G>& g, const Fe<G>& ysq,
                                         const Fe<G>& dx, Fe<G>& root,
                                         Fe<G>& inv) {
  Fe2<G> x2 = sqr_mul2(g, ysq, ysq, dx, dx, 1);
  Fe2<G> x3 = sqr_mul2(g, x2.r0, ysq, x2.r1, dx, 1);
  Fe2<G> t = sqr_mul2(g, x3.r0, x3.r0, x3.r1, x3.r1, 3);            // 6
  t = sqr_mul2(g, t.r0, x3.r0, t.r1, x3.r1, 3);                      // 9
  t = sqr_mul2(g, t.r0, x2.r0, t.r1, x2.r1, 2);                      // 11
  const Fe2<G> x22 = sqr_mul2(g, t.r0, t.r0, t.r1, t.r1, 11);
  const Fe2<G> x44 = sqr_mul2(g, x22.r0, x22.r0, x22.r1, x22.r1, 22);
  t = sqr_mul2(g, x44.r0, x44.r0, x44.r1, x44.r1, 44);               // 88
  t = sqr_mul2(g, t.r0, t.r0, t.r1, t.r1, 88);                       // 176
  t = sqr_mul2(g, t.r0, x44.r0, t.r1, x44.r1, 44);                   // 220
  t = sqr_mul2(g, t.r0, x3.r0, t.r1, x3.r1, 3);                      // 223
  t = sqr_mul2(g, t.r0, x22.r0, t.r1, x22.r1, 23);
  // (p + 1) / 4 ends 6 squarings, * x2, 2 squarings; p - 2 ends 5, * a,
  // 3, * x2, 2, * a
  root = sqr_mul1(g, sqr_mul1(g, t.r0, 6, x2.r0, true), 2, x2.r0, false);
  inv = sqr_mul1(g, sqr_mul1(g, sqr_mul1(g, t.r1, 5, dx, true), 3, x2.r1,
                             true),
                 2, dx, true);
}

// One ladder step: the Jacobian doubling (reference pt_double, a = 0)
// and then Jacobian += affine (reference _mixed_add), every field value as
// the reference computes it.  Its 18 multiplies pair up into 9 rounds of
// two independent products; the step is a loop over the rounds around one
// inlined two-product multiply, and a switch on the round does the
// round's adds and subtracts and picks the next factors (one copy of the
// multiply, no call, a loop body the instruction cache holds).  The add's
// general formulas always run, then the reference's selection: an addend
// that is skipped (not doit, or the infinite G+R entry) leaves the state,
// inf + Q = Q, else the sum, at infinity when h = 0 and r != 0, a doubling
// collision when both are 0.
template <int G>
__device__ __forceinline__ void ladder_step(const Grp<G>& g, Fe<G>& X,
                                            Fe<G>& Y, Fe<G>& Z, bool& inf,
                                            bool& bad, const Fe<G>& ax,
                                            const Fe<G>& ay, bool a_inf,
                                            bool doit) {
  // doubled point nX, nY, nZ; the add's values h, r, ... nx, ny, nz
  Fe<G> A, Bb, y2, C, D, E, C8, nX, nY, nZ, z1z1, h, r, rr, hh, nx, ny, nz;
  bool h0 = false, r0 = false;
  Fe<G> m[2] = {X, Y}, n[2] = {X, Y};  // this round's factors
#pragma unroll 1
  for (int round = 0; round < 9; ++round) {
    Fe<G> p[2];
    fe_mul_n<G, 2>(g, m, n, p);
    switch (round) {
      case 0: {  // A = X^2, B = Y^2
        A = p[0];
        Bb = p[1];
        Fe<G> xb;
        addsub2<G, 0>(g, X, Bb, Y, Y, xb, y2);
        m[0] = n[0] = Bb;
        m[1] = n[1] = xb;
        break;
      }
      case 1: {  // C = B^2, (X + B)^2
        C = p[0];
        Fe<G> t, A2;
        addsub2<G, 1>(g, p[1], A, A, A, t, A2);  // (X + B)^2 - A, 2A
        addsub2<G, 1>(g, t, C, A2, A, t, E);     // t, E = 3A
        D = fe_add(g, t, t);
        m[0] = n[0] = E;
        m[1] = y2;
        n[1] = Z;
        break;
      }
      case 2: {  // F = E^2, nZ = 2Y * Z
        nZ = p[1];
        Fe<G> D2, C2, C4, dn;
        addsub2<G, 0>(g, D, D, C, C, D2, C2);
        addsub2<G, 1>(g, p[0], D2, C2, C2, nX, C4);  // nX = F - 2D, 4C
        addsub2<G, 1>(g, D, nX, C4, C4, dn, C8);     // D - nX, 8C
        m[0] = E;
        n[0] = dn;
        m[1] = n[1] = nZ;
        break;
      }
      case 3: {  // E (D - nX), and the add's Z^2
        nY = fe_sub(g, p[0], C8);
        z1z1 = p[1];
        m[0] = ax;
        m[1] = nZ;
        n[0] = n[1] = z1z1;
        break;
      }
      case 4: {  // u2 = ax Z^2, Z^3
        h = fe_sub(g, p[0], nX);
        m[0] = ay;
        n[0] = p[1];
        m[1] = nZ;
        n[1] = h;
        break;
      }
      case 5: {  // s2 = ay Z^3, nz = Z h
        nz = p[1];
        r = fe_sub(g, p[0], nY);
        h0 = fe_is_zero(g, h);
        r0 = fe_is_zero(g, r);
        m[0] = n[0] = h;
        m[1] = n[1] = r;
        break;
      }
      case 6: {  // h^2, r^2
        hh = p[0];
        rr = p[1];
        m[0] = h;
        m[1] = nX;
        n[0] = n[1] = hh;
        break;
      }
      case 7: {  // hhh = h^3, v = X h^2
        const Fe<G> hhh = p[0], v = p[1];
        Fe<G> t, v2;
        addsub2<G, 1>(g, rr, hhh, v, v, t, v2);  // r^2 - h^3, 2v
        nx = fe_sub(g, t, v2);
        m[0] = r;
        n[0] = fe_sub(g, v, nx);
        m[1] = nY;
        n[1] = hhh;
        break;
      }
      default:  // r (v - nx), Y h^3
        ny = fe_sub(g, p[0], p[1]);
    }
  }
  const bool eff = doit && !a_inf;
  const bool take = eff && inf, general = eff && !inf;
  X = sel(take, ax, sel(general, nx, nX));
  Y = sel(take, ay, sel(general, ny, nY));
  Z = sel(take, fe_small(g, 1u), sel(general, nz, nZ));
  bad = bad || (general && h0 && r0);
  inf = take ? false : (general ? (h0 && !r0) : inf);
}

template <int G>
__device__ __forceinline__ void store_fe(const Grp<G>& g, uint8_t* out,
                                         const Fe<G>& a) {
#pragma unroll
  for (int i = 0; i < Grp<G>::W; ++i) {
    uint8_t* o = out + 4 * (g.t * Grp<G>::W + i);
    o[0] = (uint8_t)(a.w[i]);
    o[1] = (uint8_t)(a.w[i] >> 8);
    o[2] = (uint8_t)(a.w[i] >> 16);
    o[3] = (uint8_t)(a.w[i] >> 24);
  }
}

template <int G>
__global__ void __launch_bounds__(SECP_BLOCK)
secp_recover_kernel(const uint8_t* __restrict__ xb,
                    const int32_t* __restrict__ parity,
                    const uint32_t* __restrict__ u1w,
                    const uint32_t* __restrict__ u2w,
                    uint8_t* __restrict__ out, int n) {
  constexpr int W = Grp<G>::W;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  Grp<G> g;
  g.t = (int)(gid & (G - 1));
  // a group past the batch repeats the last row and stores nothing: every
  // thread of a warp runs every shuffle and vote
  const bool valid = gid / G < n;
  const int row = valid ? (int)(gid / G) : n - 1;
  const uint8_t* xr = xb + 33 * (int64_t)row;

  // x mod p, from bits 0..259 like the reference's 20 x 13-bit unpack
  Fe<G> x;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint8_t* p = xr + 4 * (g.t * W + i);
    x.w[i] = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
             ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  }
  wrap_fix(g, x, xr[32] & 0xFu);

  const Fe<G> ysq = fe_add(g, fe_mul(g, fe_sqr(g, x), x), fe_small(g, 7u));
  const Fe<G> gx = fe_const(g, kGx), gy = fe_const(g, kGy);
  const Fe<G> dx = fe_sub(g, x, gx);
  Fe<G> y, inv;
  sqrt_inv(g, ysq, dx, y, inv);
  y = fe_canon(g, y);
  const bool residue = fe_is_zero(g, fe_sub(g, fe_sqr(g, y), ysq));
  const bool flip = (int32_t)(g.shfl(y.w[0], 0) & 1u) != parity[row];
  y = sel(flip, fe_sub(g, fe_small(g, 0u), y), y);

  // G + R, affine: general case by Fermat inversion; R == G -> 2G;
  // R == -G -> the infinity flag
  const bool x_eq = fe_is_zero(g, dx);
  const Fe<G> lam = fe_mul(g, fe_sub(g, y, gy), inv);
  Fe<G> gqx = fe_sub(g, fe_sub(g, fe_sqr(g, lam), gx), x);
  Fe<G> gqy = fe_sub(g, fe_mul(g, lam, fe_sub(g, gx, gqx)), gy);
  const bool y_eq = fe_is_zero(g, fe_sub(g, y, gy));
  gqx = sel(x_eq && y_eq, fe_const(g, kG2x), gqx);
  gqy = sel(x_eq && y_eq, fe_const(g, kG2y), gqy);
  const bool gq_inf = x_eq && !y_eq;

  Fe<G> X = fe_small(g, 0u), Y = X, Z = X;
  bool inf = true, bad = false;
#pragma unroll 1
  for (int wi = 7; wi >= 0; --wi) {
    const uint32_t w1 = u1w[8 * (int64_t)row + wi];
    const uint32_t w2 = u2w[8 * (int64_t)row + wi];
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      const bool b1 = (w1 >> bit) & 1u, b2 = (w2 >> bit) & 1u;
      const bool both = b1 && b2;
      const Fe<G> ax = sel(both, gqx, sel(b2, x, gx));
      const Fe<G> ay = sel(both, gqy, sel(b2, y, gy));
      ladder_step(g, X, Y, Z, inf, bad, ax, ay, both && gq_inf, b1 || b2);
    }
  }

  X = fe_canon(g, X);
  Y = fe_canon(g, Y);
  Z = fe_canon(g, Z);
  if (valid) {
    uint8_t* o = out + 102 * (int64_t)row;
    store_fe(g, o, X);
    store_fe(g, o + 33, Y);
    store_fe(g, o + 66, Z);
    if (g.t == 0) {
      o[32] = o[65] = o[98] = 0;
      o[99] = inf;
      o[100] = bad;
      o[101] = residue;
    }
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the wrapper can raise on a refused launch.
extern "C" int secp_recover_launch(const void* xb, const void* parity,
                                   const void* u1w, const void* u2w,
                                   void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int64_t threads = (int64_t)n * SECP_G;
  const int blocks = (int)((threads + SECP_BLOCK - 1) / SECP_BLOCK);
  secp_recover_kernel<SECP_G><<<blocks, SECP_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xb, (const int32_t*)parity, (const uint32_t*)u1w,
      (const uint32_t*)u2w, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

// The design's parameters: the group width and the block size.
extern "C" int secp_recover_info(int* g, int* block) {
  *g = SECP_G;
  *block = SECP_BLOCK;
  return 0;
}
