#!/usr/bin/env python3
"""Split the device time of one fused OCC window launch into its parts.

Run from the root of a checkout, on a machine with a card:

    python3 occ_split.py
    python3 occ_split.py --lanes

The kernel carries no counters.  This script copies the checkout's CUDA
sources into a build directory of its own
(``coreth_tpu_torch/csrc/build/split``), inserts ``clock64()`` /
``%globaltimer`` reads at the ``// @split`` markers of ``occ_window.cu``
by text, builds that copy (generic, and the K7 variant for the window's
program set) with ``nvcc``, and runs K6's window (a) of
``chip_smoke.py`` (the ERC-20 chain's first 8 blocks x 256 lanes)
through both.  Per window it prints one JSON line: the device time of
the whole launch on CTA 0's clock, and its parts, summed over the
window's blocks:

- ``init``: a block's setup up to its first exec (lane inputs, seeds,
  row init);
- ``exec``: the rounds' exec phases, up to the barrier after them;
- ``sweep``: the rounds' validation, up to the barrier after it;
- ``writeback``: the trailing columns and the table write-back (K9:
  with the replica sync and the shards' flags of the block);

with the rounds, and the ``ptxas`` lines (registers, spills, stack
frame) of the uninstrumented libraries.  The split runs against the
checkout's own ``occ_run_plain`` (results equal, tolerance 0), so a
patch that changed what the kernel computes fails here.

With ``--lanes`` it instead times the lane interpreter from inside
(``step_machine.cuh``'s ``// @split`` lane markers): each lane's cycles
from its start to its end, and of them the cycles of the ALU switch on
the division family (DIV, SDIV, MOD, SMOD, ADDMOD, MULMOD), the shift
family (SHL, SHR, SAR) and SHA3, with the ops of each family run, on
K5's 256-lane batch (``chip_smoke.machine_lanes``) and on generic K6's
windows (a) and (b) (``chip_smoke.window_from_chain``, ``swap_window``).
Each instrumented launch's results must equal the uninstrumented
kernel's.  The same line gives the ``ptxas`` stack frame, spills and
registers of the K4 and K3 entries, K5, generic K6 and the K7 variant
of window (a), and from ``cuobjdump -sass`` instructions by opcode of
the K3 entry (its round loop: four rounds on half the words) and of K5
(its SHA3's round loop: one round).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

# the counters: (G)lobal device array occ_prof, one u64 per slot
PROF_DECL = "\n__device__ unsigned long long occ_prof[16];\n"
P_INIT, P_EXEC, P_SWEEP, P_WB, P_ROUNDS, P_CYC, P_NS = range(7)

_TIC = ("__device__ __forceinline__ long long occ_ns() {\n"
        "  long long t;\n"
        "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n}\n")
_READ = r"""
extern "C" int occ_prof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, occ_prof, sizeof(occ_prof));
}
extern "C" int occ_prof_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(occ_prof, z, sizeof(z));
}
"""

# (marker, counter code) pairs, each marker found exactly once: CTA 0 of
# the group times each part between the group barriers that end it.
_MARKS = [
    ("  // @split block-start\n",
     "  long long _t0 = clock64();\n"),
    ("  // @split init-end\n",
     "  if (tid == 0 && rank == 0) occ_prof[0] += clock64() - _t0;\n"),
    ("  // @split round-start\n",
     "  long long _t1 = clock64();\n"),
    ("  // @split exec-end\n",
     "  if (tid == 0 && rank == 0) { long long _t2 = clock64(); "
     "occ_prof[1] += _t2 - _t1; _t1 = _t2; }\n"),
    ("  // @split sweep-end\n",
     "  if (tid == 0 && rank == 0) { occ_prof[2] += clock64() - _t1; "
     "occ_prof[4] += 1; }\n"),
    ("  // @split writeback-start\n",
     "  long long _t3 = clock64();\n"),
    ("  // @split writeback-end\n",
     "  if (tid == 0 && rank == 0) occ_prof[3] += clock64() - _t3;\n"),
    ("  // @split kernel-start\n",
     "  long long _tk = clock64(), _nk = occ_ns();\n"),
    ("  // @split kernel-end\n",
     "  if (tid == 0 && rank == 0) { occ_prof[5] += clock64() - "
     "_tk; occ_prof[6] += occ_ns() - _nk; }\n"),
]


# the lane counters (--lanes): slots 8.. of occ_prof, summed over lanes
P_LANE, P_DIV, P_SHIFT, P_SHA3, P_LANES, P_NDIV, P_NSHIFT, P_NSHA3 = \
    range(8, 16)
_LANE_MARKS = [
    ("  // @split lane-start\n",
     "  long long _l0 = clock64(), _c0 = 0, _c1 = 0, _c2 = 0;\n"
     "  unsigned long long _n0 = 0, _n1 = 0, _n2 = 0;\n"),
    ("        // @split alu-start\n",
     "        const long long _la = clock64();\n"),
    ("        // @split alu-end\n",
     "        {\n"
     "          const long long _ld = clock64() - _la;\n"
     "          if (op >= 0x04 && op <= 0x09) { _c0 += _ld; ++_n0; }\n"
     "          else if (op >= 0x1B && op <= 0x1D) { _c1 += _ld; ++_n1; }\n"
     "          else if (op == 0x20) { _c2 += _ld; ++_n2; }\n"
     "        }\n"),
    ("  // @split lane-end\n",
     "  atomicAdd(&occ_prof[8], (unsigned long long)(clock64() - _l0));\n"
     "  atomicAdd(&occ_prof[9], (unsigned long long)_c0);\n"
     "  atomicAdd(&occ_prof[10], (unsigned long long)_c1);\n"
     "  atomicAdd(&occ_prof[11], (unsigned long long)_c2);\n"
     "  atomicAdd(&occ_prof[12], 1ull);\n"
     "  atomicAdd(&occ_prof[13], _n0);\n"
     "  atomicAdd(&occ_prof[14], _n1);\n"
     "  atomicAdd(&occ_prof[15], _n2);\n"),
]


def _patch(src: str, rules) -> str:
    for old, new in rules:
        n = src.count(old)
        if n != 1:
            raise RuntimeError(f"occ_split: anchor found {n} times: "
                               f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def instrument(csrc: str, dst: str, lanes: bool = False) -> None:
    """Copy ``csrc`` to ``dst`` with the counters inserted (with
    ``lanes`` the lane counters too, and the readers in step_machine.cu)."""
    os.makedirs(dst, exist_ok=True)
    for fn in os.listdir(csrc):
        if fn.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(csrc, fn), os.path.join(dst, fn))
    with open(os.path.join(dst, "step_machine.cuh")) as f:
        sm = f.read()
    sm = sm.replace('#include "u256x.cuh"\n',
                    '#include "u256x.cuh"\n' + PROF_DECL + _TIC, 1)
    if lanes:
        sm = _patch(sm, _LANE_MARKS)
        with open(os.path.join(dst, "step_machine.cu"), "a") as f:
            f.write(_READ)
    with open(os.path.join(dst, "step_machine.cuh"), "w") as f:
        f.write(sm)
    with open(os.path.join(dst, "occ_window.cu")) as f:
        src = f.read()
    src = _patch(src, _MARKS) + _READ
    with open(os.path.join(dst, "occ_window.cu"), "w") as f:
        f.write(src)


def start(dst: str, units: dict) -> dict:
    """Start one nvcc for each {name: source path}, all at once, into
    ``dst/lib<name>.so``; ``finish`` waits for them."""
    from coreth_tpu_torch import kernels
    nvcc = kernels._nvcc()
    procs = {}
    for name, path in units.items():
        cmd = [nvcc, kernels.ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", dst, "-o",
               os.path.join(dst, f"lib{name}.so"), path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       os.path.join(dst, f"lib{name}.so"))
    return procs


def finish(procs: dict) -> dict:
    """{name: loaded library} of ``start``'s builds; raises on a failed
    one."""
    from coreth_tpu_torch import kernels
    libs = {}
    for name, (proc, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(path)
        kernels._declare("step_machine" if name == "step_machine"
                         else "occ_window", lib)
        lib.occ_prof_read.argtypes = [ctypes.c_void_p]
        lib.occ_prof_zero.argtypes = []
        libs[name] = lib
    return libs


def split(lib, pk, spec, n: int = 1, sync_rows=None) -> dict:
    """One instrumented launch of window ``pk`` (K6 for n = 1, else K9
    over n shards), equal to the plain version, and its parts in ms of
    the clock of the group's first CTA."""
    import numpy as np
    import torch
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.evm.device import machine as M
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    dev = pk["table"].device
    X = 0 if sync_rows is None else int(sync_rows.shape[0])

    def launch():
        largs, out = M.occ_launch_args(*args, n=n)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n == 1:
            rc = lib.occ_window_launch(*M.pointers(largs), stream)
        else:
            i32 = dict(dtype=torch.int32, device=dev)
            rows = (sync_rows.to(torch.int32).contiguous() if X
                    else torch.zeros((1, n + 1), **i32))
            pre = torch.empty((n, max(X, 1), 16), **i32)
            xc = torch.empty((2, n, max(X, 1)), **i32)
            xv = torch.empty((2, n, max(X, 1), 16), **i32)
            W = pk["occ"].blocks
            flags = torch.empty((2 * W * (n + 1),), **i32)
            rc = lib.occ_sharded_launch(
                n, X, rows.data_ptr(), pre.data_ptr(), xc.data_ptr(),
                xv.data_ptr(), flags.data_ptr(), *M.pointers(largs), stream)
            torch.cuda.synchronize()
            out["flags"] = flags[:2 * W].view(W, 2)
        kernels.check(rc, "occ_window (instrumented)")
        return out
    launch()
    torch.cuda.synchronize()
    kernels.check(lib.occ_prof_zero(), "occ_prof_zero")
    got = launch()
    torch.cuda.synchronize()
    prof = np.zeros(16, dtype=np.uint64)
    kernels.check(lib.occ_prof_read(prof.ctypes.data), "occ_prof_read")
    want = (M.occ_run_plain(*args, spec) if n == 1 else
            M.occ_sharded_plain(*args, spec, n, sync_rows, "psum"))
    for k in ("table", "packed", "steps") + (("flags",) if n > 1 else ()):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"occ_split: instrumented {k} differs from "
                                 "the plain version")
    cyc, ns = float(prof[P_CYC]), float(prof[P_NS])
    ms_per_cyc = ns / cyc / 1e6 if cyc else 0.0
    parts = {k: round(float(prof[i]) * ms_per_cyc, 4) for k, i in
             (("init", P_INIT), ("exec", P_EXEC), ("sweep", P_SWEEP),
              ("writeback", P_WB))}
    rounds = int(prof[P_ROUNDS])
    return {"kernel_ms": round(ns / 1e6, 4),
            "sm_clock_mhz": round(cyc / ns * 1e3, 1) if ns else None,
            **parts,
            "other": round(ns / 1e6 - sum(parts.values()), 4),
            "rounds": rounds,
            "exec_per_round": round(parts["exec"] / max(rounds, 1), 4),
            "sweep_per_round": round(parts["sweep"] / max(rounds, 1), 4)}


def group(lib, pk, n: int = 1) -> dict:
    """The group K6 (n = 1) or K9 runs window ``pk`` on: CTAs a shard,
    lanes a CTA, lane slots, staged lanes, shared memory a CTA and
    where the sweep area lives."""
    import numpy as np
    from coreth_tpu_torch.evm.device import machine as M
    largs, _ = M.occ_launch_args(pk["p"], pk["occ"], pk["table"],
                                 pk["key_tab"], pk["inputs"], n=n)
    dims = largs[19]
    out = np.zeros(6, dtype=np.int32)
    rc = lib.occ_group_info(n, dims.ctypes.data, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"occ_group_info: {rc}")
    return {"ctas_per_shard": int(out[0]), "lanes_per_cta": int(out[1]),
            "lane_slots": int(out[2]), "staged_lanes": int(out[3]),
            "smem_per_cta": int(out[4]),
            "sweep_in_shared": bool(out[5])}


def barriers(rounds, X: int = 0) -> int:
    """Cluster barriers of one window launch by the kernel's formula (not
    counted in the run): two a round (``rounds``: per block, the most
    any shard ran) and one a block, and with a sync set two at the
    window's start and two more a block."""
    return 2 * sum(rounds) + len(rounds) + (2 + 2 * len(rounds) if X else 0)


def ptxas_lines(log: str, entry: str = "occ_window_kernel"):
    """The ``-Xptxas -v`` lines of ``entry`` in a build log: the
    function's properties (stack frame, spills) and its registers."""
    out, take = [], 0
    with open(log) as f:
        for ln in f:
            if "Compiling entry function" in ln or \
                    "Function properties for" in ln:
                take = 3 if entry in ln else 0
            if take:
                out.append(ln.strip())
                take -= 1
    return out


def ptxas_stats(log: str, entry: str) -> dict:
    """Registers, stack frame and spill bytes of the function whose
    (mangled) name holds ``entry`` in a ``-Xptxas -v`` build log, and the
    stack frames of the other functions that have one."""
    import re
    out, others, fn = {}, {}, None
    with open(log) as f:
        for ln in f:
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m and fn:
                vals = [int(v) for v in m.groups()]
                if entry in fn:
                    out.update(zip(("stack", "spill_stores",
                                    "spill_loads"), vals))
                elif vals[0]:
                    others[fn] = vals[0]
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn and entry in fn:
                out["registers"] = int(m.group(1))
    out["other_stack_frames"] = others
    return out


SASS_OPS = ("LOP3", "SHF", "PRMT", "IMAD", "IADD3", "SHFL", "STL", "LDL")


def sass_stats(lib: str, entry: str, min_lop3: int = 1) -> dict:
    """From ``cuobjdump -sass`` of a built library: the instructions of
    the function whose (mangled) name holds ``entry`` (with the device
    functions it calls), by opcode (those of SASS_OPS), in the whole
    listing and in its innermost loop with at least ``min_lop3`` LOP3s
    (the shortest such range a backward branch closes: a keccak round
    loop)."""
    import re
    from collections import Counter
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=600).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", out)[1:]
                 if entry in f.split("\n", 1)[0]), "")
    ins = [(int(m.group(1), 16), m.group(2), m.group(3))
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P(?:T|\d+)"
                                r"\s+)?([A-Z][A-Z0-9_]*)([^;]*);", body)]

    def ops(lo, hi):
        c = Counter(op for a, op, _ in ins if lo <= a <= hi)
        return {"instructions": sum(c.values()),
                **{k: c[k] for k in SASS_OPS if c[k]}}
    loops = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            loops.append((addr - int(t.group(1), 16), int(t.group(1), 16),
                          addr))
    loops = [lp for lp in loops
             if ops(lp[1], lp[2]).get("LOP3", 0) >= min_lop3]
    res = {"function": ops(0, 1 << 40)}
    if loops:
        _n, lo, hi = min(loops)
        res["innermost_loop"] = ops(lo, hi)
    return res


def ptxas_report(variant: str) -> dict:
    """``ptxas_stats`` of the K4 and K3 entries, K5, generic K6 and the
    K7 variant library ``variant``, from their build logs."""
    from coreth_tpu_torch import kernels
    out = {entry: ptxas_stats(kernels.log_path(name), entry)
           for entry, name in (("u256x_eval_kernel", "u256x_eval"),
                               ("keccak256_blocks_kernel",
                                "keccak256_blocks"),
                               ("step_machine_kernel", "step_machine"),
                               ("occ_window_kernel", "occ_window"))}
    out["occ_window_kernel (K7 variant)"] = ptxas_stats(
        kernels.log_path(variant), "occ_window_kernel")
    return out


def _counted(name: str, lib, fn) -> tuple:
    """``fn``'s result and the lane counters of one call with the
    instrumented ``lib`` in the place of kernel library ``name``."""
    import numpy as np
    import torch
    from coreth_tpu_torch import kernels
    saved = kernels._libs.get(name)
    kernels._libs[name] = lib
    try:
        fn()
        torch.cuda.synchronize()
        kernels.check(lib.occ_prof_zero(), "occ_prof_zero")
        got = fn()
        torch.cuda.synchronize()
        prof = np.zeros(16, dtype=np.uint64)
        kernels.check(lib.occ_prof_read(prof.ctypes.data), "occ_prof_read")
    finally:
        if saved is None:
            kernels._libs.pop(name, None)
        else:
            kernels._libs[name] = saved
    lane = float(prof[P_LANE])
    row = {"lanes": int(prof[P_LANES]), "lane_cycles": int(lane)}
    for fam, (c, n) in (("div", (P_DIV, P_NDIV)),
                        ("shift", (P_SHIFT, P_NSHIFT)),
                        ("sha3", (P_SHA3, P_NSHA3))):
        row[f"{fam}_share"] = round(float(prof[c]) / lane, 5) if lane else 0
        row[f"{fam}_ops"] = int(prof[n])
        row[f"{fam}_cycles_per_op"] = (round(float(prof[c]) / float(prof[n]),
                                             1) if prof[n] else None)
    return got, row


def _equal(got, want, what: str) -> None:
    import torch
    pairs = (zip(got, want) if isinstance(got, tuple) else
             ((got[k], want[k]) for k in ("table", "packed", "steps")))
    for g, w in pairs:
        if not torch.equal(g, w):
            raise AssertionError(f"occ_split: instrumented {what} differs "
                                 "from the kernel's result")


def lanes_main(root: str, smi: str) -> int:
    """``--lanes``: the in-lane shares of K5's batch and generic K6's
    windows (a) and (b), and the ``ptxas`` lines of five kernels."""
    import torch
    import chip_smoke as CS
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.evm.device import specialize as SP
    dev = torch.device("cuda")
    kernels.build()
    dst = os.path.join(root, "coreth_tpu_torch", "csrc", "build", "lanes")
    instrument(kernels.CSRC, dst, lanes=True)
    procs = start(dst, {n: os.path.join(dst, f"{n}.cu")
                        for n in ("step_machine", "occ_window")})
    genesis, blocks = CS.build_erc20_chain(8, 256, 1024)
    p, inputs = CS.k5_batch(dev)
    wins = {"k6_a": CS.window_from_chain(dev, genesis, blocks),
            "k6_b": CS.swap_window(dev)}
    spec = CS.window_from_chain(dev, genesis, blocks, specialize=True)
    vname, vsrc = SP.variant(spec["spec"])
    kernels.build_generated({vname: vsrc})
    libs = finish(procs)
    out = {"card": smi}
    want = M.run_machine(p, inputs)
    got, out["k5_batch"] = _counted(
        "step_machine", libs["step_machine"],
        lambda: M.run_machine(p, inputs))
    _equal(got, want, "K5 batch")
    for name, pk in wins.items():
        args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"],
                pk["inputs"])
        want = M.run_occ_window(*args)
        got, out[name] = _counted("occ_window", libs["occ_window"],
                                  lambda: M.run_occ_window(*args))
        _equal(got, want, f"K6 {name}")
    out["ptxas"] = ptxas_report(vname)
    out["sass"] = {
        "keccak256_blocks_kernel": sass_stats(
            kernels.lib_path("keccak256_blocks"), "keccak256_blocks_kernel"),
        # the lane interpreter's SHA3 round: its loop of ~130 LOP3s
        "step_machine_kernel": sass_stats(kernels.lib_path("step_machine"),
                                          "step_machine_kernel", 100)}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("occ_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.evm.device import specialize as SP
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if sys.argv[1:] == ["--lanes"]:
        return lanes_main(root, smi)
    t0 = time.monotonic()
    genesis, blocks = CS.build_erc20_chain(8, 256, 1024)
    windows = {"k6_a": CS.window_from_chain(dev, genesis, blocks),
               "k7_a": CS.window_from_chain(dev, genesis, blocks,
                                            specialize=True)}
    t_windows = time.monotonic() - t0
    spec = windows["k7_a"]["spec"]
    vname, vsrc = SP.variant(spec)
    kernels.build_generated({vname: vsrc})
    dst = os.path.join(root, "coreth_tpu_torch", "csrc", "build", "split")
    instrument(kernels.CSRC, dst)
    with open(os.path.join(dst, "variant.cu"), "w") as f:
        f.write(vsrc)
    libs = finish(start(dst, {
        "generic": os.path.join(dst, "occ_window.cu"),
        "variant": os.path.join(dst, "variant.cu")}))
    out = {"card": smi, "setup_s": round(t_windows, 1),
           "ptxas_generic": ptxas_lines(kernels.log_path("occ_window")),
           "ptxas_variant": ptxas_lines(kernels.log_path(vname))}
    for name, lib, sp in (("k6_a", libs["generic"], ()),
                          ("k7_a", libs["variant"], spec)):
        out[name] = split(lib, windows[name], sp)
        out[name]["device_ms_uninstrumented"] = CS.kernel_ms(
            lambda: _launch_real(windows[name], sp), "occ_window", reps=5)
    print(json.dumps(out), flush=True)
    return 0


def _launch_real(pk, spec):
    from coreth_tpu_torch.evm.device import machine as M
    return M.run_occ_window(pk["p"], pk["occ"], pk["table"], pk["key_tab"],
                            pk["inputs"], spec)


if __name__ == "__main__":
    sys.exit(main())
