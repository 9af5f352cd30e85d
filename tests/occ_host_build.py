"""A host build of ``coreth_tpu_torch/csrc/occ_window.cu`` (K6, K7's
variants, K9 with its flags epilogue) and ``csrc/step_machine.cu`` (K5)
for the CPU tests.

The kernel's device code is plain C++ once the CUDA spellings are
shimmed: each CTA of the cluster is a host thread with one thread (the
warp-wide loops' stride ``OCC_WARP`` 1), the cluster barrier a
``std::barrier``, each CTA's dynamic shared memory a buffer of its own,
and the bulk copies that stage a block's inputs (``stage_*``, which the
CUDA source defines only under nvcc) plain ``memcpy``s with no-op
mbarriers.  This is a test harness, not a path of the port: on the card
the same source runs as nvcc builds it.
"""

import os
import re
import shutil
import subprocess

SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __launch_bounds__(...)
#define __constant__ static const
#define __shared__ static thread_local
#define __align__(x) alignas(x)
#define OCC_WARP 1
using std::max;
struct Dim3Shim { unsigned x, y, z; };
inline Dim3Shim dim3(unsigned x, unsigned y, unsigned z) { return {x, y, z}; }
static thread_local Dim3Shim threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static Dim3Shim blockDim = {1, 1, 1};
static thread_local Dim3Shim gridDim = {1, 1, 1};
static thread_local uint8_t* shim_smem = nullptr;
inline void __syncthreads() {}
inline void __syncwarp() {}
inline int __syncthreads_or(int p) { return p; }
inline int __syncthreads_and(int p) { return p; }
inline bool __any_sync(unsigned, bool p) { return p; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline void __trap() { __builtin_trap(); }
template <class T> T atomicOr(T* p, T v) { T o = *p; *p = o | v; return o; }
template <class T> T atomicMin(T* p, T v) {
  T o = *p;
  if (v < o) *p = v;
  return o;
}
template <class T> T atomicMax(T* p, T v) {
  T o = *p;
  if (v > o) *p = v;
  return o;
}
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcg(T* p, T v) { *p = v; }
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
inline int cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 9
};
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448;  // an H100's opt-in shared memory a block
  return 0;
}
template <class K> int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
// the group: every CTA of the launch is one host thread of one cluster
static std::barrier<>* shim_barrier = nullptr;
inline int grp_rank() { return (int)blockIdx.x; }
inline void grp_sync() { shim_barrier->arrive_and_wait(); }
// the staging copies: synchronous, so the mbarriers have nothing to do
inline void stage_init(uint64_t*, int) {}
inline void stage_fence() {}
inline void stage_expect(uint64_t*, uint32_t) {}
inline void stage_copy(void* dst, const void* src, uint32_t bytes,
                       uint64_t*) {
  std::memcpy(dst, src, bytes);
}
inline void stage_wait(uint64_t*, int) {}
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  Dim3Shim gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int cudaOccupancyMaxActiveClusters(int* n, const void*,
                                          const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}
template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...),
                       A&&... args) {
  const unsigned n = cfg->gridDim.x;
  std::barrier<> bar(n);
  shim_barrier = &bar;
  std::vector<std::vector<uint64_t>> smem(
      n, std::vector<uint64_t>(cfg->dynamicSmemBytes / 8 + 2));
  std::vector<std::thread> cta;
  for (unsigned b = 0; b < n; ++b)
    cta.emplace_back([&, b] {
      gridDim = {n, 1, 1};
      blockIdx = {b, 0, 0};
      shim_smem = (uint8_t*)smem[b].data();
      k(args...);
    });
  for (auto& t : cta) t.join();
  return 0;
}
"""


def host_source(src: str) -> str:
    """A kernel source (``occ_window.cu``, ``step_machine.cu``) for the
    host: each dynamic shared-memory buffer the launch's per-CTA buffer,
    a plain ``<<<...>>>`` launch a call on one host thread."""
    src = src.replace("#include <cuda_runtime.h>", "")
    src = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)shim_smem;", src)
    return re.sub(r"<<<[^>]*>>>", "", src)


def gxx() -> str:
    """The host compiler, or None."""
    return shutil.which("g++")


def write_csrc(tmp: str) -> None:
    """``csrc/`` into ``tmp``, occ_window.cu and step_machine.cu as
    ``host_source`` makes them."""
    from coreth_tpu_torch.kernels import CSRC
    for fn in os.listdir(CSRC):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn)) as f:
                src = f.read()
            if fn in ("occ_window.cu", "step_machine.cu"):
                src = host_source(src)
            with open(os.path.join(tmp, fn), "w") as f:
                f.write(src)


def build(tmp: str, unit_src: str, out: str,
          *flags) -> subprocess.CompletedProcess:
    """g++ ``SHIM + unit_src`` (a translation unit that includes
    ``occ_window.cu``, or ``occ_window.cu`` itself) against the shimmed
    sources in ``tmp``."""
    write_csrc(tmp)
    unit = os.path.join(tmp, "unit.cpp")
    with open(unit, "w") as f:
        f.write(SHIM + unit_src)
    cmd = [gxx(), "-std=c++20", "-w", "-I", tmp, *flags, unit, "-lpthread"]
    if out:
        cmd[1:1] = ["-shared", "-fPIC", "-o", out]
    return subprocess.run(cmd, capture_output=True, text=True)
