#!/usr/bin/env python3
"""Time the recovery ladder's field operations (K2) one warp at a time.

Run from the root of a checkout, on a machine with a card:

    python3 secp_ops.py

The kernel's parts are inlined into one ladder, so this script writes a
unit of its own (``coreth_tpu_torch/csrc/build/secp_ops/secp_ops.cu``)
that includes ``csrc/secp_recover.cu`` and runs, in one warp, chains of
dependent operations (a multiply, two at once, an add, a subtract, two
subtracts at once, the zero test, and a whole ladder step) between
``clock64()`` reads.  It builds that unit with ``nvcc`` and prints one
JSON line at the kernel's group width: SM cycles per operation, and per
step, beside the step's count of multiply rounds.  The chains' values are checked
against nothing (they are timing loads, not results): the kernel is held
to its plain version by ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

UNIT = r"""
#include "%(src)s"
namespace {
template <int G>
__global__ void secp_ops(unsigned long long* out, uint32_t seed, int iters) {
  Grp<G> g;
  g.t = threadIdx.x & (G - 1);
  Fe<G> a, b, c, d, x, y, z;
  for (int i = 0; i < Grp<G>::W; ++i) {
    a.w[i] = seed * (i + 3) + threadIdx.x;
    b.w[i] = seed ^ (i * 77 + threadIdx.x);
  }
  c = a; d = b; x = a; y = b; z = fe_small(g, 1u);
  bool inf = false, bad = false;
  long long t[8];
  t[0] = clock64();
  for (int i = 0; i < iters; ++i) a = fe_mul(g, a, b);
  t[1] = clock64();
  for (int i = 0; i < iters; ++i) {
    Fe<G> m[2] = {c, d}, n[2] = {b, b}, r[2];
    fe_mul_n<G, 2>(g, m, n, r);
    c = r[0]; d = r[1];
  }
  t[2] = clock64();
  for (int i = 0; i < iters; ++i) a = fe_add(g, a, b);
  t[3] = clock64();
  for (int i = 0; i < iters; ++i) a = fe_sub(g, a, b);
  t[4] = clock64();
  for (int i = 0; i < iters; ++i) addsub2<G, 3>(g, c, b, d, b, c, d);
  t[5] = clock64();
  for (int i = 0; i < iters; ++i) b = sel(fe_is_zero(g, b), a, b);
  t[6] = clock64();
  for (int i = 0; i < iters; ++i)
    ladder_step(g, x, y, z, inf, bad, a, c, false, (i & 3) != 0);
  t[7] = clock64();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 7; ++i) out[i] = t[i + 1] - t[i];
    out[7] = a.w[0] ^ b.w[0] ^ c.w[0] ^ d.w[0] ^ x.w[0] ^ y.w[0] ^ z.w[0] ^ inf ^ bad;
  }
}
}  // namespace
extern "C" int secp_ops_launch(void* out, int iters) {
  secp_ops<SECP_G><<<1, 32>>>((unsigned long long*)out, 12345u, iters);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
extern "C" int secp_ops_group() { return SECP_G; }
"""

OPS = ["mul", "mul2", "add", "sub", "sub2", "is_zero", "ladder_step"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("secp_ops: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from coreth_tpu_torch import kernels
    dst = os.path.join(kernels.BUILD_DIR, "secp_ops")
    os.makedirs(dst, exist_ok=True)
    unit = os.path.join(dst, "secp_ops.cu")
    with open(unit, "w") as f:
        f.write(UNIT % {"src": os.path.join(kernels.CSRC, "secp_recover.cu")})
    path = os.path.join(dst, "libsecp_ops.so")
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", path, unit],
                   check=True)
    lib = ctypes.CDLL(path)
    lib.secp_ops_launch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = torch.zeros(8, dtype=torch.int64, device="cuda")
    iters = 256
    lib.secp_ops_launch(out.data_ptr(), 16)   # warm
    if lib.secp_ops_launch(out.data_ptr(), iters) != 0:
        raise RuntimeError("secp_ops: launch failed")
    cyc = out.cpu().tolist()
    print(json.dumps({
        "secp_ops": "K2", "g": lib.secp_ops_group(), "iters": iters,
        "cycles_per_op": {op: round(cyc[i] / iters, 1)
                          for i, op in enumerate(OPS)},
        "step_multiply_rounds": 9, "step_multiplies": 18}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
