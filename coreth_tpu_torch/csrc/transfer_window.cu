// One window of value-transfer blocks as a row-parallel walk, for Hopper
// (sm_90a).
//
// Replaces the reference's jitted device program
//   coreth_tpu/replay/engine.py:245 _transfer_window
//   (with _step_core:209, _transfer_step:282, _slot_step:224,
//    _gather_fetch:196 and the ops/u256.py limb chains).
// It gathers the window-local accounts and slots, runs the K blocks in
// order (each block's nonce-sequence and solvency checks, per-account
// debits / required balance / credits plus the coinbase fee, per-slot
// token debits and credits), writes one fetch row block per block and
// scatters the locals back.  The plain PyTorch version it is held
// against is engine._transfer_window_plain; both follow the reference
// bit for bit, including out-of-bounds pad gids (gather zeros, drop on
// scatter) and blocks whose ok flag is 0 (their state still applies,
// sub wrapping mod 2^256, and later blocks run on top).
//
// Design.  A block's state applies whether or not its ok flag is set, so
// each account or slot row evolves from its own values only: its
// per-block sums (debit, required, credit with the coinbase's fee total,
// send count; slot debit and credit), each normalized per block, and its
// own pre-block value, which its solvency and nonce checks read.  Rows
// meet only in the per-block ok AND.  So the window is three launches on
// the stream, each spread over the card, with no block-by-block chain:
//   (a) blocks — one CTA a block, independent of the state: it claims a
//       compact row for each row the block touches (the masked lanes'
//       senders, or the row a sender's wrapped nonce check reads, their
//       recipients and slots, the coinbase), then for each row its fetch
//       rows name, in a dense map M (row, k) -> compact row or -1 (the
//       launch sets M to -1 first); it sums the lanes, one thread a
//       (lane, limb), into uint32 limb sums, with the nonce check's
//       operand tx_nonce - offset as a min and a max a row (all of a
//       row's must equal its pre-block nonce), normalizes them (mod
//       2^256, as u256.normalize) and writes the compact rows, each value
//       as eight 32-bit words.  The sums accumulate in the CTA's shared
//       memory when they fit (layout 1: up to pad 344 at any L and SL,
//       536 at SL = 64), else in device memory (layout 0);
//   (b) rows — one thread a row of the L + SL, consecutive rows on
//       consecutive CTAs (the busiest senders are the first locals): it
//       gathers the row (out of range gids read zeros), walks k = 0..K-1
//       through M, checks solvency and the nonce against the pre-block
//       value (a failure clears ok[k]), applies sub(add(v, credit),
//       debit) and the nonce bump on 32-bit words, stores the post-block
//       value into the compact row, and scatters the final value (out of
//       range gids drop).  Compact rows move as 16-byte vectors, the
//       rows of four events loaded together before they are applied;
//   (c) fetch — fetch row (k, i) reads the post-block value of its row's
//       compact row of block k (a fetched row always has one) as 16-bit
//       limbs, indices wrapped like a jnp gather; the ok row reads ok[k].
// Limb sums are uint32: a limb takes at most 2 * pad adds of < 2^16
// (MAX_PAD 16384 in the wrapper).  Table limbs are < 2^16
// (u256.pack_np), so two make a word exactly.
//
// Scratch (int32 words, the wrapper allocates it; transfer_window_plan):
// compact account rows K * CA * 28, compact slot rows K * CS * 16, in
// layout 0 the sums K * NA * 52 and K * NS * 32, M (L + SL) * K, ok K;
// CA = min(L, 2 * pad + 1 + t_pad), CS = min(SL, 2 * pad + s_pad), NA =
// min(L, 2 * pad + 1), NS = min(SL, 2 * pad).  At phase k1's shapes of
// chip_smoke.py (K = 128, pad = 128, L = 16384, SL = 64, t_pad = 512,
// s_pad = 64): 4,992,640 words (20.0 MB), layout 1 with 61,648 B of
// shared memory a phase-(a) CTA.  At MAX_PAD (pad = 16384, K = 128, L =
// 65536, SL = 8, t_pad = 32768, s_pad = 8): 461,430,400 words (1.85 GB),
// layout 0.  The wrapper refuses a scratch past 1 << 30 words.
//
// Bound: bytes — each table, the packed txs and the fetch rows read or
// written once, ~15 MB at main-path shapes (~4.4 us at 3.35 TB/s).  The
// walk of a row touched by every block is K dependent steps, and M's
// reset and the compact rows' traffic come on top.

#include <cstdint>
#include <cuda_runtime.h>

#include "transfer_block.cuh"

namespace {

using tw::COLS;
using tw::FW;
using tw::LIMBS;
using tw::wrap_idx;
using tw::in_range;

constexpr int WORDS = LIMBS / 2;  // a value as 32-bit words
// phase (a)'s sums of an account (uint32 limb sums): debit | required |
// credit | send count | the nonce operand's min and max | pad
constexpr int ACW = 3 * LIMBS + 4;
constexpr int S_CNT = 3 * LIMBS, S_NLO = S_CNT + 1, S_NHI = S_CNT + 2;
constexpr int SCW = 2 * LIMBS;  // of a slot: debit | credit
// a compact account row: debit | required | credit (words) | send count |
// nonce min | nonce max | pad; after phase (b) its first nine words hold
// the post-block balance and nonce
constexpr int AW = 3 * WORDS + 4;
constexpr int A_CNT = 3 * WORDS, A_NLO = A_CNT + 1, A_NHI = A_CNT + 2;
// a compact slot row: debit | credit; after phase (b) the post-block value
constexpr int SW = 2 * WORDS;
constexpr int A_THREADS = 256;  // phase (a): one CTA a block
constexpr int R_THREADS = 128;  // phase (b): one thread a row
constexpr int F_THREADS = 256;  // phase (c): one thread a fetch word
constexpr int MCHUNK = 16;      // map entries a row thread loads at once
constexpr int EGROUP = 4;       // events whose compact rows load at once
constexpr long long MAX_GRID = 1 << 16;

struct Plan {
  long long words;  // scratch int32 words
  int CA, CS;       // compact rows a block
  int NA, NS;       // of which sum rows at most
  int smem;         // layout 1: phase (a)'s shared sums, bytes
};

Plan plan_of(int K, int pad, int L, int SL, int t_pad, int s_pad,
             int layout) {
  Plan p;
  auto lmin = [](long long a, long long b) { return (int)(a < b ? a : b); };
  p.NA = lmin(L, 2LL * pad + 1);
  p.NS = lmin(SL, 2LL * pad);
  p.CA = lmin(L, 2LL * pad + 1 + t_pad);
  p.CS = lmin(SL, 2LL * pad + s_pad);
  p.words = (long long)K * p.CA * AW + (long long)K * p.CS * SW +
            (long long)(L + SL) * K + K;
  if (layout == 0)
    p.words += (long long)K * p.NA * ACW + (long long)K * p.NS * SCW;
  p.smem = (p.NA * ACW + p.NS * SCW) * 4;
  return p;
}

struct Scratch {
  unsigned *ca, *cs;    // compact rows (K, CA, AW), (K, CS, SW)
  unsigned *sa, *ss;    // layout 0: the sums (K, NA, ACW), (K, NS, SCW)
  int *ma, *ms;         // M: (L, K) and (SL, K), row-major by row
  int* ok;              // (K)
  int CA, CS, NA, NS;
};

// the first claim of a row in a block takes compact row base + (*cnt)++
// (a plain read first: most repeated claims, such as the fetch rows' pad
// entries, find the row claimed without an atomic on one address)
__device__ __forceinline__ void claim(int* m, int base, int* cnt) {
  if (*m == -1 && atomicCAS(m, -1, -2) == -1)
    *m = base + atomicAdd(cnt, 1);
}

// word w of a value whose normalized 16-bit limbs are at a
__device__ __forceinline__ unsigned word_of(const unsigned* a, int w) {
  return a[2 * w] | a[2 * w + 1] << 16;
}

__global__ void __launch_bounds__(A_THREADS) k1_blocks(
    const int* __restrict__ txds, int K, int pad, int L, int SL,
    const int* __restrict__ t_idxs, int t_pad,
    const int* __restrict__ s_idxs, int s_pad, Scratch x,
    int shared_sums) {
  extern __shared__ __align__(16) unsigned tw_smem[];
  __shared__ int na, nf, ns, nsf;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = blockIdx.x; k < K; k += gridDim.x) {
    const int* txd = txds + (int64_t)k * pad * COLS;
    const int cb = txd[5];  // coinbase, broadcast in every row
    auto am = [&](int r) { return x.ma + (int64_t)r * K + k; };
    auto sm = [&](int r) { return x.ms + (int64_t)r * K + k; };
    if (tid == 0) {
      na = nf = ns = nsf = 0;
      x.ok[k] = 1;
    }
    __syncthreads();
    // the block's sum rows
    for (int i = tid; i < pad; i += nt) {
      const int* row = txd + (int64_t)i * COLS;
      if (row[4] == 0) continue;  // masked-out pad row adds nothing
      claim(am(wrap_idx(row[0], L)), 0, &na);  // also its nonce check's
      if (in_range(row[1], L)) claim(am(row[1]), 0, &na);
      if (in_range(row[54], SL)) claim(sm(row[54]), 0, &ns);
      if (in_range(row[55], SL)) claim(sm(row[55]), 0, &ns);
    }
    if (tid == 0 && in_range(cb, L)) claim(am(cb), 0, &na);
    __syncthreads();
    const int n1 = na, s1 = ns;
    unsigned* acc = shared_sums ? tw_smem : x.sa + (int64_t)k * x.NA * ACW;
    unsigned* sacc =
        shared_sums ? tw_smem + x.NA * ACW : x.ss + (int64_t)k * x.NS * SCW;
    // zero the sums; claim the fetched rows the lanes did not
    for (int e = tid; e < n1 * ACW; e += nt)
      acc[e] = e % ACW == S_NLO ? 0xFFFFFFFFu : 0u;
    for (int e = tid; e < s1 * SCW; e += nt) sacc[e] = 0u;
    for (int i = tid; i < t_pad; i += nt)
      claim(am(wrap_idx(t_idxs[(int64_t)k * t_pad + i], L)), n1, &nf);
    for (int i = tid; i < s_pad; i += nt)
      claim(sm(wrap_idx(s_idxs[(int64_t)k * s_pad + i], SL)), s1, &nsf);
    __syncthreads();
    // segment sums, one thread a (lane, limb); a limb's debit takes the
    // value + fee carry chain up to it (per tx, as the reference)
    for (int e = tid; e < pad * LIMBS; e += nt) {
      const int* row = txd + (int64_t)(e / LIMBS) * COLS;
      const int j = e % LIMBS;
      if (row[4] == 0) continue;
      const int s = row[0], r = row[1];
      const int* value = row + 6;
      const int* fee = row + 22;
      int carry = 0;
#pragma unroll
      for (int q = 0; q < LIMBS - 1; ++q)
        if (q < j) carry = (value[q] + fee[q] + carry) >> 16;
      const unsigned debit = (unsigned)((value[j] + fee[j] + carry) & 0xFFFF);
      if (in_range(s, L)) {
        unsigned* a = acc + (int64_t)*am(s) * ACW;
        atomicAdd(a + j, debit);
        atomicAdd(a + LIMBS + j, (unsigned)row[38 + j]);
        if (j == 0) atomicAdd(a + S_CNT, 1u);
      }
      if (in_range(r, L))
        atomicAdd(acc + (int64_t)*am(r) * ACW + 2 * LIMBS + j,
                  (unsigned)value[j]);
      if (in_range(cb, L))
        atomicAdd(acc + (int64_t)*am(cb) * ACW + 2 * LIMBS + j,
                  (unsigned)fee[j]);
      const unsigned amt = (unsigned)row[56 + j];
      if (in_range(row[54], SL))
        atomicAdd(sacc + (int64_t)*sm(row[54]) * SCW + j, amt);
      if (in_range(row[55], SL))
        atomicAdd(sacc + (int64_t)*sm(row[55]) * SCW + LIMBS + j, amt);
      if (j == 0) {
        unsigned* a = acc + (int64_t)*am(wrap_idx(s, L)) * ACW;
        const unsigned want = (unsigned)row[2] - (unsigned)row[3];
        atomicMin(a + S_NLO, want);
        atomicMax(a + S_NHI, want);
      }
    }
    __syncthreads();
    // the sums normalized in place, a thread a row
    for (int p = tid; p < n1; p += nt) {
      unsigned* a = acc + (int64_t)p * ACW;
      auto get = [&](int c) { return a[c]; };
      for (int c = 0; c < S_CNT; c += LIMBS)
        tw::normalize(get, c, (int*)a + c);
    }
    for (int p = tid; p < s1; p += nt) {
      unsigned* a = sacc + (int64_t)p * SCW;
      auto get = [&](int c) { return a[c]; };
      tw::normalize(get, 0, (int*)a);
      tw::normalize(get, LIMBS, (int*)a + LIMBS);
    }
    __syncthreads();
    // the compact rows, neighbouring threads on neighbouring words; a
    // fetched row no lane touched has no sums and no nonce check
    unsigned* ca = x.ca + (int64_t)k * x.CA * AW;
    for (int e = tid; e < (n1 + nf) * AW; e += nt) {
      const int p = e / AW, w = e % AW;
      const unsigned* a = acc + (int64_t)p * ACW;
      unsigned v;
      if (p >= n1)
        v = w == A_NLO ? 0xFFFFFFFFu : 0u;
      else if (w < A_CNT)
        v = word_of(a + (w / WORDS) * LIMBS, w % WORDS);
      else
        v = w < AW - 1 ? a[S_CNT + w - A_CNT] : 0u;
      ca[e] = v;
    }
    unsigned* cs = x.cs + (int64_t)k * x.CS * SW;
    for (int e = tid; e < (s1 + nsf) * SW; e += nt) {
      const int p = e / SW, w = e % SW;
      cs[e] = p < s1 ? word_of(sacc + (int64_t)p * SCW + (w / WORDS) * LIMBS,
                               w % WORDS)
                     : 0u;
    }
    __syncthreads();  // the shared sums serve the CTA's next block
  }
}

// a < b, 256-bit values as eight 32-bit words
__device__ __forceinline__ bool lt_words(const unsigned* a,
                                         const unsigned* b) {
  unsigned borrow = 0;
#pragma unroll
  for (int j = 0; j < WORDS; ++j)
    borrow = (unsigned)(((uint64_t)a[j] - b[j] - borrow) >> 32) & 1u;
  return borrow != 0;
}

// v = sub(add(v, credit), debit) mod 2^256, on words
__device__ __forceinline__ void apply_words(unsigned* v, const unsigned* credit,
                                            const unsigned* debit) {
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    const uint64_t s = (uint64_t)v[j] + credit[j] + carry;
    v[j] = (unsigned)s;
    carry = s >> 32;
  }
  unsigned borrow = 0;
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    const uint64_t d = (uint64_t)v[j] - debit[j] - borrow;
    v[j] = (unsigned)d;
    borrow = (unsigned)(d >> 32) & 1u;
  }
}

// A compact row in registers, W words as 16-byte vectors (word i with i
// a constant after unrolling)
template <int W>
struct Row {
  uint4 q[W / 4];
  __device__ __forceinline__ void load(const unsigned* p) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) q[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ unsigned operator[](int i) const {
    const uint4 v = q[i >> 2];
    return (i & 3) == 0 ? v.x : (i & 3) == 1 ? v.y : (i & 3) == 2 ? v.z : v.w;
  }
};

// One event of a row's walk: block k's compact row `r` (at `c`) against
// the pre-block value v (and nonce n); then the post-block value into
// the compact row's first words.
template <bool ACCT, int W>
__device__ __forceinline__ void step(const Row<W>& r, unsigned* c, int k,
                                     unsigned* v, unsigned* n, int* ok) {
  unsigned debit[WORDS], credit[WORDS];
  bool bad;
  if (ACCT) {
    unsigned req[WORDS];
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      debit[j] = r[j];
      req[j] = r[WORDS + j];
      credit[j] = r[2 * WORDS + j];
    }
    const unsigned cnt = r[A_CNT], lo = r[A_NLO], hi = r[A_NHI];
    bad = (cnt != 0 && lt_words(v, req)) ||
          (lo <= hi && (lo != *n || hi != *n));
    *n += cnt;
  } else {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      debit[j] = r[j];
      credit[j] = r[WORDS + j];
    }
    bad = lt_words(v, debit);
  }
  if (bad) ok[k] = 0;
  apply_words(v, credit, debit);
  reinterpret_cast<uint4*>(c)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(c)[1] = make_uint4(v[4], v[5], v[6], v[7]);
  if (ACCT) c[WORDS] = *n;
}

// Row r's walk over the window: its map entries MCHUNK at a time, and
// the compact rows of EGROUP events loaded together before they are
// applied in order.
template <bool ACCT, int W>
__device__ __forceinline__ void walk(int r, int g, bool in, int* tab,
                                     int* non, int K, const int* m,
                                     unsigned* rows, int C, int* ok) {
  unsigned v[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS; ++j)
    v[j] = in ? (unsigned)tab[2 * j] | (unsigned)tab[2 * j + 1] << 16 : 0u;
  unsigned n = ACCT && in ? (unsigned)non[g] : 0u;
  m += (int64_t)r * K;
  for (int k0 = 0; k0 < K; k0 += MCHUNK) {
    int pos[MCHUNK];
#pragma unroll
    for (int u = 0; u < MCHUNK; ++u) pos[u] = k0 + u < K ? m[k0 + u] : -1;
#pragma unroll
    for (int e0 = 0; e0 < MCHUNK; e0 += EGROUP) {
      Row<W> buf[EGROUP];
#pragma unroll
      for (int u = 0; u < EGROUP; ++u)
        if (pos[e0 + u] >= 0)
          buf[u].load(rows + ((int64_t)(k0 + e0 + u) * C + pos[e0 + u]) * W);
#pragma unroll
      for (int u = 0; u < EGROUP; ++u)
        if (pos[e0 + u] >= 0)
          step<ACCT>(buf[u],
                     rows + ((int64_t)(k0 + e0 + u) * C + pos[e0 + u]) * W,
                     k0 + e0 + u, v, &n, ok);
    }
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      tab[2 * j] = (int)(v[j] & 0xFFFFu);
      tab[2 * j + 1] = (int)(v[j] >> 16);
    }
    if (ACCT) non[g] = (int)n;
  }
}

// A thread a row; consecutive rows on consecutive CTAs, so the rows most
// blocks touch (the busiest senders are the first locals) spread over
// the SMs.
__global__ void __launch_bounds__(R_THREADS) k1_rows(
    int* __restrict__ bal, int* __restrict__ non, int* __restrict__ sv,
    int cap, int scap, const int* __restrict__ acct_gids, int L,
    const int* __restrict__ slot_gids, int SL, int K, Scratch x) {
  const int T = blockDim.x * gridDim.x;
  for (int t = threadIdx.x * gridDim.x + blockIdx.x; t < L + SL; t += T) {
    if (t < L) {
      const int g = acct_gids[t];
      walk<true, AW>(t, g, in_range(g, cap), bal + (int64_t)g * LIMBS, non,
                     K, x.ma, x.ca, x.CA, x.ok);
    } else {
      const int g = slot_gids[t - L];
      walk<false, SW>(t - L, g, in_range(g, scap), sv + (int64_t)g * LIMBS,
                      non, K, x.ms, x.cs, x.CS, x.ok);
    }
  }
}

__global__ void __launch_bounds__(F_THREADS) k1_fetch(
    int* __restrict__ f, const int* __restrict__ t_idxs, int t_pad,
    const int* __restrict__ s_idxs, int s_pad, int L, int SL, int K,
    Scratch x) {
  const int fw = (t_pad + s_pad + 1) * FW;
  const int64_t total = (int64_t)K * fw;
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int k = (int)(e / fw), i = (int)(e % fw) / FW, j = (int)(e % FW);
    const unsigned* c = nullptr;
    if (i < t_pad) {
      const int r = wrap_idx(t_idxs[(int64_t)k * t_pad + i], L);
      c = x.ca + ((int64_t)k * x.CA + x.ma[(int64_t)r * K + k]) * AW;
    } else if (i < t_pad + s_pad) {
      const int r = wrap_idx(s_idxs[(int64_t)k * s_pad + i - t_pad], SL);
      c = x.cs + ((int64_t)k * x.CS + x.ms[(int64_t)r * K + k]) * SW;
    }
    int v;
    if (c == nullptr)  // the ok row
      v = j == 0 ? x.ok[k] : 0;
    else if (j < LIMBS)
      v = (int)((c[j / 2] >> (16 * (j & 1))) & 0xFFFFu);
    else
      v = i < t_pad ? (int)c[WORDS] : 0;
    f[e] = v;
  }
}

unsigned grid_for(long long items, int threads) {
  const long long g = (items + threads - 1) / threads;
  return (unsigned)(g < 1 ? 1 : (g > MAX_GRID ? MAX_GRID : g));
}

template <class... P, class... A>
int launch(void (*kernel)(P...), unsigned grid, int threads, int smem,
           cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the opt-in shared memory a block of this card, less the kernel's own
int shared_avail(int* avail) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        avail, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *avail -= 1024;
  return (int)err;
}

}  // namespace

// The window's plan in ``layout`` (-1: the one that fits): out int64[4] =
// scratch int32 words, layout 1's shared bytes a phase-(a) CTA, the
// layout (1: sums in shared memory, 0: in device memory), compact
// account rows a block.  Returns a cudaError.
extern "C" int transfer_window_plan(int K, int pad, int L, int SL, int t_pad,
                                    int s_pad, int layout, void* out) {
  int avail = 0;
  const int rc = shared_avail(&avail);
  if (layout < 0)
    layout = plan_of(K, pad, L, SL, t_pad, s_pad, 1).smem <= avail ? 1 : 0;
  const Plan p = plan_of(K, pad, L, SL, t_pad, s_pad, layout);
  long long* o = (long long*)out;
  o[0] = p.words;
  o[1] = p.smem;
  o[2] = layout;
  o[3] = p.CA;
  return rc;
}

// Launch the window on `stream` (PyTorch's current stream): M's reset,
// then phases (a), (b), (c).  bal/non/sv are updated in place (the
// wrapper hands in clones of the engine's tables); `scratch` holds
// `scratch_words` int32 words (transfer_window_plan of `layout`).  With
// `split_ms` (float[3], else null) the call records events between the
// phases, waits for the last and writes each phase's milliseconds, the
// reset in (a)'s.  Returns 0, -3 for layout 1 past the shared memory, -4
// for a short scratch, else a cudaError.
extern "C" int transfer_window_launch(
    void* bal, void* non, void* sv, int cap, int scap, const void* acct_gids,
    int L, const void* slot_gids, int SL, const void* txds, int K, int pad,
    const void* t_idxs, int t_pad, const void* s_idxs, int s_pad, int layout,
    void* scratch, long long scratch_words, void* fetches, void* stream,
    void* split_ms) {
  if (K <= 0) return 0;
  const Plan p = plan_of(K, pad, L, SL, t_pad, s_pad, layout);
  if (scratch_words < p.words) return -4;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (layout) {
    int avail = 0;
    rc = shared_avail(&avail);
    if (rc != 0) return rc;
    if (p.smem > avail) return -3;
    rc = (int)cudaFuncSetAttribute(
        k1_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (rc != 0) return rc;
  }
  Scratch x;  // the compact rows first: 16-byte rows for vector access
  x.CA = p.CA;
  x.CS = p.CS;
  x.NA = p.NA;
  x.NS = p.NS;
  x.ca = (unsigned*)scratch;
  x.cs = x.ca + (int64_t)K * p.CA * AW;
  x.sa = x.cs + (int64_t)K * p.CS * SW;
  x.ss = x.sa + (layout ? 0 : (int64_t)K * p.NA * ACW);
  x.ma = (int*)(x.ss + (layout ? 0 : (int64_t)K * p.NS * SCW));
  x.ms = x.ma + (int64_t)L * K;
  x.ok = x.ms + (int64_t)SL * K;
  cudaEvent_t ev[4];
  float* ms = (float*)split_ms;
  if (ms) {
    for (int i = 0; i < 4; ++i) cudaEventCreate(&ev[i]);
    cudaEventRecord(ev[0], st);
  }
  rc = (int)cudaMemsetAsync(x.ma, 0xFF, (size_t)(L + SL) * K * 4, st);
  if (rc == 0)
    rc = launch(k1_blocks, (unsigned)K, A_THREADS, layout ? p.smem : 0, st,
                (const int*)txds, K, pad, L, SL, (const int*)t_idxs, t_pad,
                (const int*)s_idxs, s_pad, x, layout);
  if (ms) cudaEventRecord(ev[1], st);
  if (rc == 0)
    rc = launch(k1_rows, grid_for((long long)L + SL, R_THREADS), R_THREADS,
                0, st, (int*)bal, (int*)non, (int*)sv, cap, scap,
                (const int*)acct_gids, L, (const int*)slot_gids, SL, K, x);
  if (ms) cudaEventRecord(ev[2], st);
  if (rc == 0)
    rc = launch(k1_fetch,
                grid_for((long long)K * (t_pad + s_pad + 1) * FW, F_THREADS),
                F_THREADS, 0, st, (int*)fetches, (const int*)t_idxs, t_pad,
                (const int*)s_idxs, s_pad, L, SL, K, x);
  if (ms) {
    cudaEventRecord(ev[3], st);
    cudaEventSynchronize(ev[3]);
    for (int i = 0; i < 3; ++i) cudaEventElapsedTime(ms + i, ev[i], ev[i + 1]);
    for (int i = 0; i < 4; ++i) cudaEventDestroy(ev[i]);
  }
  return rc;
}
