#!/usr/bin/env python3
"""Split the device time of one sharded transfer window launch (K8) into
its parts.

Run from the root of a checkout, on a machine with a card:

    python3 window_split.py

The kernel carries no counters.  This script copies
``coreth_tpu_torch/csrc/sharded_window.cu`` and ``transfer_block.cuh``
into a build directory of its own (``coreth_tpu_torch/csrc/build/
split_k8``), inserts ``clock64()`` reads at the ``// @split`` markers of
the kernel by text, builds that copy with ``nvcc`` and runs phase k1's
window of ``chip_smoke.py`` (128 blocks x 128 lanes, 16,384 window
locals) through it at n = 2, 4 and 8 shards (psum), its results held to
``_sharded_window_plain`` (tolerance 0).  Per width it prints one JSON
line: the launch on CTA 0's first thread's clock (ms at the SM clock it
measured against ``%globaltimer``), and its parts, summed over the
window's blocks: ``gather`` (the window's rows into the working sets),
``map`` (a block's row map and the barrier after it), ``accumulate``
(the shard's lanes into its slab and the first-position flags),
``exchange`` (the cluster barrier's wait), ``reduce`` (the warp's rows of
the reduce and apply), ``zero`` (the other buffer's zeroing and the CTA
barrier, which waits for the slowest warp's rows), ``rows`` (the
shard's fetch rows), ``fetch`` (the ok flag), ``scatter``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PARTS = ["gather", "map", "accumulate", "exchange", "reduce", "zero",
         "rows", "fetch", "scatter"]

_PROF = r"""
__device__ unsigned long long sw_prof[16];
__device__ __forceinline__ long long sw_ns() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
extern "C" int sw_prof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, sw_prof, sizeof(sw_prof));
}
extern "C" int sw_prof_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(sw_prof, z, sizeof(z));
}
"""


def _tick(i: int) -> str:
    # the sums stay in registers until the end: a global counter's
    # read-modify-write at every mark would land in the next part
    return ("  { const long long _n = clock64(); "
            f"_acc[{i}] += _n - _tp; _tp = _n; }}\n")


def instrument(src: str) -> str:
    """The kernel source with the counters at its markers."""
    out = src.replace('#include "transfer_block.cuh"\n',
                      '#include "transfer_block.cuh"\n' + _PROF)
    rules = {"begin": (f"  long long _acc[{len(PARTS)}] = {{}};\n"
                       "  long long _tp = clock64(), _ts = _tp, "
                       "_ns0 = sw_ns();\n")}
    for i, part in enumerate(PARTS):
        rules[part] = _tick(i)
    rules["scatter"] += (
        "  if (tid == 0 && d == 0) {\n"
        f"    for (int _i = 0; _i < {len(PARTS)}; ++_i) "
        "sw_prof[_i] = _acc[_i];\n"
        f"    sw_prof[{len(PARTS)}] = clock64() - _ts;\n"
        f"    sw_prof[{len(PARTS) + 1}] = sw_ns() - _ns0;\n  }}\n")
    for marker, code in rules.items():
        tag = f"// @split {marker}\n"
        if out.count(tag) != 1:
            raise RuntimeError(f"window_split: marker {marker!r} not found "
                               "exactly once")
        lines = out.split(tag)
        out = lines[0] + tag + code + lines[1]
    return out


def build(root: str) -> ctypes.CDLL:
    from coreth_tpu_torch import kernels
    dst = os.path.join(kernels.BUILD_DIR, "split_k8")
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "transfer_block.cuh")) as f:
        open(os.path.join(dst, "transfer_block.cuh"), "w").write(f.read())
    with open(os.path.join(kernels.CSRC, "sharded_window.cu")) as f:
        src = instrument(f.read())
    unit = os.path.join(dst, "sharded_window_split.cu")
    with open(unit, "w") as f:
        f.write(src)
    lib = os.path.join(dst, "libsharded_window_split.so")
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", dst, "-o", lib,
                    unit], check=True)
    out = ctypes.CDLL(lib)
    kernels._declare("sharded_window", out)
    out.sw_prof_read.argtypes = [ctypes.c_void_p]
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("window_split: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.replay import shard as SH
    lib = build(root)
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    win = chip_smoke.random_window(rng, 128, 128, 128, 32768, 1024,
                                   n_acct=9400, n_slot=40, L=16384, SL=64,
                                   t_pad=512, s_pad=64)
    args = [torch.from_numpy(a).to(dev) for a in win]
    real = kernels._libs.get("sharded_window")
    for n in (2, 4, 8):
        perm = torch.from_numpy(SH.interleave_txs(128, n)).to(dev)
        sargs = args[:5] + [args[5][:, perm].contiguous()] + args[6:]
        kernels._libs["sharded_window"] = lib
        try:
            got = SH._launch(sargs, n, "psum", SH.window_design(128)["layout"])
            lib.sw_prof_zero()
            SH._launch(sargs, n, "psum", SH.window_design(128)["layout"])
            torch.cuda.synchronize()
        finally:
            if real is None:
                kernels._libs.pop("sharded_window", None)
            else:
                kernels._libs["sharded_window"] = real
        want = SH._sharded_window_plain(*sargs, n, "psum",
                                        return_replicas=True)
        if not all(torch.equal(g, w) for g, w in
                   zip(got[:4] + got[4], want[:4] + want[4])):
            raise AssertionError(f"window_split n={n}: the instrumented "
                                 "kernel differs from the plain version")
        prof = (ctypes.c_ulonglong * 16)()
        lib.sw_prof_read(prof)
        cyc, ns = prof[len(PARTS)], prof[len(PARTS) + 1]
        mhz = cyc / ns * 1e3 if ns else 0.0
        ms = {p: round(prof[i] / mhz / 1e3, 4) if mhz else None
              for i, p in enumerate(PARTS)}
        print(json.dumps({"split": "sharded_window", "n": n, "mode": "psum",
                          "launch_ms": round(ns / 1e6, 4),
                          "sm_clock_mhz": round(mhz, 1), "parts_ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
