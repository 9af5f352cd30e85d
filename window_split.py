#!/usr/bin/env python3
"""Split the device time of a transfer kernel's launch into its parts:
one sharded transfer window (K8), or with ``--k8s`` the per-block
sharded steps (K8s).

Run from the root of a checkout, on a machine with a card:

    python3 window_split.py          # K8
    python3 window_split.py --k8s    # K8s

The kernels carry no counters.  This script copies the kernel's source
(``coreth_tpu_torch/csrc/sharded_window.cu`` or ``sharded_step.cu``) and
``transfer_block.cuh`` into a build directory of its own
(``coreth_tpu_torch/csrc/build/split_<kernel>``), inserts ``clock64()``
reads at the ``// @split`` markers of the kernel by text, builds that
copy with ``nvcc`` and runs it through the kernel's own wrapper, its
results held to the plain version (tolerance 0).

K8: phase k1's window of ``chip_smoke.py`` (128 blocks x 128 lanes,
16,384 window locals) at n = 2, 4 and 8 shards (psum).  Per width one
JSON line: the launch on CTA 0's first thread's clock (ms at the SM clock
it measured against ``%globaltimer``), and its parts, summed over the
window's blocks: ``gather`` (the window's rows into the working sets),
``map`` (a block's row map and the barrier after it), ``accumulate``
(the shard's lanes into its slab and the first-position flags),
``exchange`` (the cluster barrier's wait), ``reduce`` (the warp's rows of
the reduce and apply), ``zero`` (the other buffer's zeroing and the CTA
barrier, which waits for the slowest warp's rows), ``rows`` (the
shard's fetch rows), ``fetch`` (the ok flag), ``scatter``.

K8s: phase k8s's random inputs of ``chip_smoke.py`` (A = S = 16,384,
B = 512) at n = 2, 4 and 8.  Per step and width one JSON line: the
parts named by the kernel's markers, each the longest any CTA spent in
it (a CTA's first thread's clock); the launch from the first CTA's start
to the last CTA's end (``%globaltimer``); the wrapper's time on the card
(CUDA events around it, median of 20) and its host time per call (the
host clock over 50 calls that do not wait for the card).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

K8_PARTS = ["gather", "map", "accumulate", "exchange", "reduce", "zero",
            "rows", "fetch", "scatter"]
NPROF = 32

_PROF = r"""
__device__ unsigned long long sw_prof[32];
__device__ __forceinline__ long long sw_ns() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
extern "C" int sw_prof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, sw_prof, sizeof(sw_prof));
}
extern "C" int sw_prof_zero() {
  unsigned long long z[32] = {0};
  z[30] = ~0ull;  // the earliest start, for the min
  return (int)cudaMemcpyToSymbol(sw_prof, z, sizeof(z));
}
"""


def _tick(i: int) -> str:
    # the sums stay in registers until the end: a global counter's
    # read-modify-write at every mark would land in the next part
    return ("  { const long long _n = clock64(); "
            f"_acc[{i}] += _n - _tp; _tp = _n; }}\n")


def _k8_write(parts) -> str:
    """K8: CTA 0's first thread keeps its parts, cycles and ns."""
    return ("  if (tid == 0 && d == 0) {\n"
            f"    for (int _i = 0; _i < {len(parts)}; ++_i) "
            "sw_prof[_i] = _acc[_i];\n"
            "    sw_prof[28] = clock64() - _ts;\n"
            "    sw_prof[29] = sw_ns() - _ns0;\n  }\n")


def _max_write(parts) -> str:
    """Every CTA's first thread: each part's longest, the longest CTA's
    cycles and ns, the launch's first start and last end."""
    return ("  if (threadIdx.x == 0) {\n"
            f"    for (int _i = 0; _i < {len(parts)}; ++_i) "
            "atomicMax(&sw_prof[_i], (unsigned long long)_acc[_i]);\n"
            "    atomicMax(&sw_prof[28],\n"
            "              (unsigned long long)(clock64() - _ts));\n"
            "    const long long _ne = sw_ns();\n"
            "    atomicMax(&sw_prof[29], (unsigned long long)(_ne - _ns0));\n"
            "    atomicMin(&sw_prof[30], (unsigned long long)_ns0);\n"
            "    atomicMax(&sw_prof[31], (unsigned long long)_ne);\n  }\n")


def parts_of(src: str) -> list:
    """The parts a source's markers name, in order, after ``begin``."""
    marks = re.findall(r"// @split (\S+)\n", src)
    if not marks or marks[0] != "begin":
        raise RuntimeError("window_split: the first marker must be 'begin'")
    return marks[1:]


def instrument(src: str, parts=None, write=_k8_write) -> str:
    """The kernel source with the counters at its markers (``parts``:
    the markers after ``begin``, in order; the last one writes)."""
    parts = parts_of(src) if parts is None else parts
    if len(parts) > 27:
        raise RuntimeError("window_split: too many parts")
    out = src.replace('#include "transfer_block.cuh"\n',
                      '#include "transfer_block.cuh"\n' + _PROF)
    rules = {"begin": (f"  long long _acc[{len(parts)}] = {{}};\n"
                       "  long long _tp = clock64(), _ts = _tp, "
                       "_ns0 = sw_ns();\n")}
    for i, part in enumerate(parts):
        rules[part] = _tick(i)
    rules[parts[-1]] += write(parts)
    for marker, code in rules.items():
        tag = f"// @split {marker}\n"
        if out.count(tag) != 1:
            raise RuntimeError(f"window_split: marker {marker!r} not found "
                               "exactly once")
        lines = out.split(tag)
        out = lines[0] + tag + code + lines[1]
    return out


def build(kernel: str = "sharded_window") -> ctypes.CDLL:
    """The instrumented copy of ``kernel``'s source, built and loaded
    with the real library's declarations.  The build is skipped when the
    copy's library is newer than the kernel's source, its header and this
    script (which writes the instrumentation)."""
    from coreth_tpu_torch import kernels
    dst = os.path.join(kernels.BUILD_DIR, f"split_{kernel}")
    header = os.path.join(kernels.CSRC, "transfer_block.cuh")
    source = os.path.join(kernels.CSRC, kernels.SOURCES[kernel])
    lib = os.path.join(dst, f"lib{kernel}_split.so")
    try:
        built = os.path.getmtime(lib)
        stale = any(built < os.path.getmtime(d) for d in
                    (header, source, os.path.abspath(__file__)))
    except OSError:
        stale = True
    if stale:
        os.makedirs(dst, exist_ok=True)
        shutil.copyfile(header, os.path.join(dst, "transfer_block.cuh"))
        with open(source) as f:
            src = f.read()
        src = instrument(src, K8_PARTS) if kernel == "sharded_window" \
            else instrument(src, write=_max_write)
        unit = os.path.join(dst, f"{kernel}_split.cu")
        with open(unit, "w") as f:
            f.write(src)
        subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-I", dst, "-o",
                        lib, unit], check=True)
    out = ctypes.CDLL(lib)
    kernels._declare(kernel, out)
    out.sw_prof_read.argtypes = [ctypes.c_void_p]
    return out


def _read(lib, parts) -> dict:
    prof = (ctypes.c_ulonglong * NPROF)()
    lib.sw_prof_read(prof)
    cyc, ns = prof[28], prof[29]
    mhz = cyc / ns * 1e3 if ns else 0.0
    return {"parts_ms": {p: round(prof[i] / mhz / 1e3, 4) if mhz else None
                         for i, p in enumerate(parts)},
            "sm_clock_mhz": round(mhz, 1),
            "span_ns": (prof[31] - prof[30]) if prof[31] else None,
            "ns": ns}


class _Swap:
    """``kernels._libs[name]`` is ``lib`` inside the block."""

    def __init__(self, name, lib):
        from coreth_tpu_torch import kernels
        self.k, self.name, self.lib = kernels, name, lib

    def __enter__(self):
        self.real = self.k._libs.get(self.name)
        self.k._libs[self.name] = self.lib

    def __exit__(self, *exc):
        if self.real is None:
            self.k._libs.pop(self.name, None)
        else:
            self.k._libs[self.name] = self.real


def split_k8(dev) -> None:
    import numpy as np
    import torch
    import chip_smoke
    from coreth_tpu_torch.replay import shard as SH
    lib = build("sharded_window")
    rng = np.random.default_rng(chip_smoke.SEED)
    win = chip_smoke.random_window(rng, 128, 128, 128, 32768, 1024,
                                   n_acct=9400, n_slot=40, L=16384, SL=64,
                                   t_pad=512, s_pad=64)
    args = [torch.from_numpy(a).to(dev) for a in win]
    for n in (2, 4, 8):
        perm = torch.from_numpy(SH.interleave_txs(128, n)).to(dev)
        sargs = args[:5] + [args[5][:, perm].contiguous()] + args[6:]
        with _Swap("sharded_window", lib):
            got = SH._launch(sargs, n, "psum", SH.window_design(128)["layout"])
            lib.sw_prof_zero()
            SH._launch(sargs, n, "psum", SH.window_design(128)["layout"])
            torch.cuda.synchronize()
        want = SH._sharded_window_plain(*sargs, n, "psum",
                                        return_replicas=True)
        if not all(torch.equal(g, w) for g, w in
                   zip(got[:4] + got[4], want[:4] + want[4])):
            raise AssertionError(f"window_split n={n}: the instrumented "
                                 "kernel differs from the plain version")
        r = _read(lib, K8_PARTS)
        print(json.dumps({"split": "sharded_window", "n": n, "mode": "psum",
                          "launch_ms": round(r["ns"] / 1e6, 4),
                          "sm_clock_mhz": r["sm_clock_mhz"],
                          "parts_ms": r["parts_ms"]}), flush=True)


def k8s_split(lib, step, args, plain, n: int) -> dict:
    """One K8s call through ``step`` on the instrumented ``lib``, held
    to ``plain``; its parts and launch span."""
    import torch
    from coreth_tpu_torch import kernels
    parts = parts_of(open(os.path.join(
        kernels.CSRC, kernels.SOURCES["sharded_step"])).read())
    with _Swap("sharded_step", lib):
        step(*args)
        torch.cuda.synchronize()
        lib.sw_prof_zero()
        got = step(*args)
        torch.cuda.synchronize()
    want = plain(*args, n)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"window_split k8s n={n}: the instrumented "
                             "kernel differs from the plain version")
    r = _read(lib, parts)
    return {"parts_ms": r["parts_ms"], "sm_clock_mhz": r["sm_clock_mhz"],
            "launch_ms": round(r["span_ns"] / 1e6, 4)
            if r["span_ns"] else None}


def host_ms(fn, calls: int = 50) -> float:
    """Host milliseconds a call of ``fn`` (the card not waited for)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1000 * t / calls


def split_k8s(dev) -> None:
    import numpy as np
    import torch
    import chip_smoke
    from coreth_tpu_torch import parallel as P
    lib = build("sharded_step")
    A = S = 1 << 14
    B = 512
    rng = np.random.default_rng(chip_smoke.SEED)
    t_np, coinbase, s_np = chip_smoke.k8s_inputs(rng, A, S, B)
    targs = [torch.from_numpy(a).to(dev) for a in t_np] + [coinbase]
    sargs = [torch.from_numpy(a).to(dev) for a in s_np]
    for n in (2, 4, 8):
        mesh = P.make_mesh(n)
        for name, step, plain, args in (
                ("transfer", P.sharded_transfer_step(mesh, A),
                 P.sharded_transfer_step_plain, targs),
                ("slot", P.sharded_slot_step(mesh, S),
                 P.sharded_slot_step_plain, sargs)):
            row = k8s_split(lib, step, args, plain, n)
            row.update(
                wrapper_ms=round(chip_smoke.cuda_ms(lambda: step(*args),
                                                    reps=20), 4),
                host_ms=round(host_ms(lambda: step(*args)), 4))
            print(json.dumps({"split": "sharded_step", "step": name, "n": n,
                              **row}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("window_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda")
    if "--k8s" in sys.argv[1:]:
        split_k8s(dev)
    else:
        split_k8(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
