"""A host build of ``coreth_tpu_torch/csrc/secp_recover.cu`` (K2) for the
CPU tests.

The kernel's device code is plain C++ once the CUDA spellings are
shimmed: ``SECP_HOST_BUILD`` swaps the PTX carry chains for the same
chains on a thread-local carry flag, and each warp runs as 32 host
threads that meet at a barrier for every shuffle and vote.  The lanes
of a warp must run the same sequence of them (as the card requires of a
full-warp shuffle or vote); the shim checks that, so a vote under a
branch that groups of one warp take differently fails the launch.  A
launch runs its warps one after another.  A build takes one group width
(``-DSECP_G``): 1 is the one-thread form; 4, the kernel's, runs the
card's shuffle and ballot code, but how the card schedules it is checked
only on the card.  Beside the kernel, each build carries a unit that
runs single field operations (``run_fe``), so that operands which random
signatures never produce (the carries out of a digit after a wrap) can
be held to Python integers.  This is a test harness, not a path of the
port.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np

SHIM = r"""
#include <atomic>
#include <chrono>
#include <cstdint>
#include <thread>
#include <vector>
#define SECP_HOST_BUILD 1
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __launch_bounds__(...)
#define __constant__ static const
struct Dim3Shim { unsigned x, y, z; };
static thread_local Dim3Shim threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static Dim3Shim blockDim = {1, 1, 1};
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
// one warp: its 32 lanes exchange through two alternating slot rows, one
// barrier an exchange (a lane can only overwrite a row after every lane
// has passed the next barrier, i.e. has read it).  A lane that waits
// longer than a minute poisons the warp: its lanes diverged.
struct ShimWarp {
  int n = 32;
  std::atomic<int> count{0};
  std::atomic<unsigned> phase{0};
  std::atomic<bool> poisoned{false};
  uint32_t slot[2][32];
  void wait() {
    const unsigned ph = phase.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
      count.store(0, std::memory_order_relaxed);
      phase.store(ph + 1, std::memory_order_release);
      return;
    }
    const auto t0 = std::chrono::steady_clock::now();
    for (long spin = 0; phase.load(std::memory_order_acquire) == ph; ++spin) {
      if (poisoned.load(std::memory_order_relaxed)) return;
      if (spin > 16) std::this_thread::yield();
      if ((spin & 0xFFFF) == 0 &&
          std::chrono::steady_clock::now() - t0 > std::chrono::seconds(60))
        poisoned = true;
    }
  }
};
static thread_local ShimWarp* shim_warp = nullptr;
static thread_local int shim_lane = 0, shim_row = 0;
// the sequence of warp-wide operations a lane ran: on the card every lane
// of a warp meets every other at each one, so the sequences must be equal
static thread_local uint64_t shim_seq = 0;
inline uint32_t* shim_post(uint32_t v, int op) {
  shim_seq = shim_seq * 1000003u + (uint64_t)op;
  uint32_t* s = shim_warp->slot[shim_row];
  shim_row ^= 1;
  s[shim_lane] = v;
  shim_warp->wait();
  return s;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width) {
  const uint32_t* s = shim_post(v, 1);
  return s[(shim_lane & ~(width - 1)) + src % width];
}
inline unsigned __ballot_sync(unsigned, bool p) {
  const uint32_t* s = shim_post(p ? 1u : 0u, 2);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= s[i] << i;
  return m;
}
inline bool __any_sync(unsigned, bool p) {
  const uint32_t* s = shim_post(p ? 1u : 0u, 3);
  for (int i = 0; i < 32; ++i)
    if (s[i]) return true;
  return false;
}
// Runs the launch warp by warp (blocks of 32 threads: one warp each), each
// lane a host thread.  Returns 0, or -4 when the lanes of a warp ran
// different sequences of warp-wide operations.
template <class K, class... A>
int shim_launch(int, unsigned blocks, unsigned threads, K k, A... args) {
  blockDim = {threads, 1, 1};
  int rc = 0;
  for (unsigned b = 0; b < blocks; ++b) {
    ShimWarp warp;
    uint64_t seq[32];
    std::vector<std::thread> lanes;
    for (int i = 0; i < 32; ++i)
      lanes.emplace_back([&, i] {
        shim_warp = &warp;
        shim_lane = i;
        shim_row = 0;
        shim_seq = 0;
        threadIdx = {(unsigned)i, 0, 0};
        blockIdx = {b, 0, 0};
        k(args...);
        seq[i] = shim_seq;
      });
    for (auto& t : lanes) t.join();
    for (int i = 1; i < 32; ++i)
      if (seq[i] != seq[0]) rc = -4;
    if (warp.poisoned) rc = -4;
  }
  return rc;
}
"""


# One field operation a row at the group width SECP_G, beside the kernel:
# row k of `out` holds two elements, the operation's results (weakly
# reduced: any representative below 2^256).
#   0: a * b          1: a + b          2: a - b
#   3: a * b and a * a at once (the ladder's two-product multiply)
#   4: a - b and a + b at once (the ladder's paired adds)
#   5: a + (b's low nibble) * 2^256, reduced as the x unpack reduces it
#   6: the canonical a, and the flag a = 0 (mod p) in word 0 of the second
FE_UNIT = r"""
namespace {
template <int G>
__global__ void fe_unit(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        int n, int op) {
  constexpr int W = Grp<G>::W;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  Grp<G> g;
  g.t = (int)(gid & (G - 1));
  const bool valid = gid / G < n;
  const int row = valid ? (int)(gid / G) : n - 1;
  Fe<G> x, y, r[2];
  for (int i = 0; i < W; ++i) {
    x.w[i] = a[8 * row + g.t * W + i];
    y.w[i] = b[8 * row + g.t * W + i];
  }
  r[1] = fe_small(g, 0u);
  const Fe<G> xs[2] = {x, x}, ys[2] = {y, x};
  switch (op) {
    case 0: r[0] = fe_mul(g, x, y); break;
    case 1: r[0] = fe_add(g, x, y); break;
    case 2: r[0] = fe_sub(g, x, y); break;
    case 3: fe_mul_n<G, 2>(g, xs, ys, r); break;
    case 4: addsub2<G, 1>(g, x, y, x, y, r[0], r[1]); break;
    case 5:
      r[0] = x;
      wrap_fix(g, r[0], g.shfl(y.w[0], 0) & 0xFu);
      break;
    default:
      r[0] = fe_canon(g, x);
      r[1] = fe_small(g, fe_is_zero(g, x) ? 1u : 0u);
  }
  if (valid)
    for (int k = 0; k < 2; ++k)
      for (int i = 0; i < W; ++i)
        out[16 * row + 8 * k + g.t * W + i] = r[k].w[i];
}
}  // namespace
extern "C" int fe_unit_launch(const void* a, const void* b, void* out, int n,
                              int op) {
  const int blocks = (n * SECP_G + SECP_BLOCK - 1) / SECP_BLOCK;
  return shim_launch(SECP_G, blocks, SECP_BLOCK, fe_unit<SECP_G>,
                     (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
                     n, op);
}
"""

FE_OPS = {"mul": 0, "add": 1, "sub": 2, "mul2": 3, "subadd": 4, "wrap": 5,
          "canon": 6}


def host_source(src: str) -> str:
    """``secp_recover.cu`` for the host, with the field-operation unit: the
    launch runs its groups and returns the shim's check of their warp-wide
    operations."""
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src.replace(
        "  secp_recover_kernel<SECP_G><<<blocks, SECP_BLOCK, 0, "
        "(cudaStream_t)stream>>>(",
        "  if (int rc = shim_launch(SECP_G, blocks, SECP_BLOCK, "
        "secp_recover_kernel<SECP_G>,")
    src = src.replace("      (const uint32_t*)u2w, (uint8_t*)out, n);\n"
                      "  return (int)cudaGetLastError();",
                      "      (const uint32_t*)u2w, (uint8_t*)out, n))\n"
                      "    return rc;\n  return (int)cudaGetLastError();")
    assert "shim_launch(SECP_G" in src and "return rc;" in src
    return src + FE_UNIT


def gxx():
    return shutil.which("g++")


def build(tmp: str, g: int, src_path: str = None) -> ctypes.CDLL:
    """g++ the shimmed source into ``tmp`` at group width g (``-DSECP_G``)
    with blocks of 32 threads (one warp, so the check of the warp-wide
    operations spans 32 / g rows)."""
    if src_path is None:
        from coreth_tpu_torch import kernels
        src_path = os.path.join(kernels.CSRC, "secp_recover.cu")
    with open(src_path) as f:
        src = host_source(f.read())
    unit = os.path.join(tmp, f"secp_recover_g{g}.cpp")
    with open(unit, "w") as f:
        f.write(SHIM + src)
    out = os.path.join(tmp, f"libsecp_recover_host_g{g}.so")
    r = subprocess.run([gxx(), "-std=c++20", "-O2", "-w", "-shared", "-fPIC",
                        f"-DSECP_G={g}", "-DSECP_BLOCK=32", "-o", out, unit,
                        "-lpthread"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[:4000])
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.secp_recover_launch.argtypes = [P, P, P, P, P, I, P]
    lib.secp_recover_launch.restype = I
    lib.fe_unit_launch.argtypes = [P, P, P, I, I]
    lib.fe_unit_launch.restype = I
    return lib


def run(lib, x, parity, u1w, u2w) -> np.ndarray:
    """The kernel on numpy inputs: (B, 102) uint8."""
    args = [np.ascontiguousarray(a) for a in (x, parity, u1w, u2w)]
    out = np.zeros((args[0].shape[0], 102), dtype=np.uint8)
    rc = lib.secp_recover_launch(*(a.ctypes.data for a in args),
                                 out.ctypes.data, out.shape[0], None)
    assert rc != -4, "lanes of one warp ran different shuffles and votes"
    assert rc == 0
    return out


def _words(vals) -> np.ndarray:
    return np.array([np.frombuffer(v.to_bytes(32, "little"), "<u4")
                     for v in vals], dtype=np.uint32).reshape(-1, 8)


def run_fe(lib, op: str, a, b):
    """Field operation ``op`` (``FE_OPS``) on rows of Python ints below
    2^256: a list of (first, second) result ints per row."""
    A, B = _words(a), _words(b)
    out = np.zeros((len(a), 2, 8), dtype=np.uint32)
    rc = lib.fe_unit_launch(A.ctypes.data, B.ctypes.data, out.ctypes.data,
                            len(a), FE_OPS[op])
    assert rc != -4, "lanes of one warp ran different shuffles and votes"
    assert rc == 0
    return [tuple(int.from_bytes(r.tobytes(), "little") for r in row)
            for row in out]
