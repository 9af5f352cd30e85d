"""Build and load the port's hand-written CUDA kernels.

Each source under ``coreth_tpu_torch/csrc/`` compiles with ``nvcc`` into
its own shared library with a plain C interface, loaded through
ctypes: no PyTorch headers, so a build takes seconds.  Libraries go to
``csrc/build/`` (listed in ``.gitignore``) at first use, and rebuild
when their source is newer.  Stale sources build in parallel, one
``nvcc`` each, under a file lock shared by every process of the
checkout.  Importing this module builds nothing and needs no CUDA.

A *generated* kernel (K6's specialised variants: repo code writes a
translation unit from contract bytecode, ``evm/device/specialize.py``)
builds the same way from ``csrc/build/<name>.cu``, with ``csrc/`` on
the include path; its name carries a hash of its source and of every
``csrc/*.cu``/``*.cuh``, so a changed source is a new library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from coreth_tpu_torch.nativebuild import BUILD_DIR, BuildLock

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = {
    "transfer_window": "transfer_window.cu",
    "secp_recover": "secp_recover.cu",
    "keccak256_blocks": "keccak256_blocks.cu",
    "u256x_eval": "u256x_eval.cu",
    "step_machine": "step_machine.cu",
    "occ_window": "occ_window.cu",
    "sharded_window": "sharded_window.cu",
}
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# seconds each kernel's nvcc took in this process (0.0: already built)
BUILD_SECONDS: Dict[str, float] = {}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}.log")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header
    of ``csrc/`` (the sources share the device-function headers)."""
    deps = [os.path.join(CSRC, SOURCES[name])] + [
        os.path.join(CSRC, fn) for fn in os.listdir(CSRC)
        if fn.endswith(".cuh")]
    try:
        built = os.path.getmtime(lib_path(name))
        return any(built < os.path.getmtime(d) for d in deps)
    except OSError:
        return True


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the stale kernels in parallel; returns {name: seconds}
    (0.0 for one already fresh).  Raises with nvcc's output on failure.
    ``-Xptxas -v`` (registers, spills) goes to ``csrc/build/<name>.log``."""
    names = list(SOURCES if names is None else names)
    with BuildLock("kernels"):
        todo = {n: os.path.join(CSRC, SOURCES[n]) for n in names
                if _stale(n)}
        return _nvcc_all(names, todo)


def generated_name(prefix: str, source: str) -> str:
    """``<prefix>_<sha12>``: the hash covers the generated source and
    every ``csrc/*.cu``/``*.cuh`` it may include."""
    h = hashlib.sha256(source.encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return f"{prefix}_{h.hexdigest()[:12]}"


def build_generated(sources: Dict[str, str]) -> Dict[str, float]:
    """Write each generated translation unit {name: source} to
    ``csrc/build/<name>.cu`` and build the missing ones in parallel;
    returns {name: seconds} like ``build``."""
    with BuildLock("kernels"):
        todo = {}
        for n, src in sources.items():
            if os.path.exists(lib_path(n)):
                continue
            path = os.path.join(BUILD_DIR, f"{n}.cu")
            with open(path, "w") as f:
                f.write(src)
            todo[n] = path
        return _nvcc_all(list(sources), todo)


def _nvcc_all(names, todo: Dict[str, str]) -> Dict[str, float]:
    """One nvcc per {name: source path} of ``todo``, all started
    together (the caller holds the build lock)."""
    took = {n: 0.0 for n in names}
    if todo:
        nvcc = _nvcc()
        procs = {}
        t0 = time.monotonic()
        for n, src in todo.items():
            tmp = lib_path(n) + f".{os.getpid()}.tmp"
            cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
                   "-o", tmp, src]
            log = open(log_path(n), "w")
            procs[n] = (subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT),
                        log, tmp)
        failed = []
        for n, (proc, log, tmp) in procs.items():
            rc = proc.wait()
            log.close()
            took[n] = time.monotonic() - t0
            if rc != 0:
                failed.append(n)
                continue
            os.replace(tmp, lib_path(n))
        if failed:
            msgs = []
            for n in failed:
                with open(log_path(n)) as f:
                    msgs.append(f"--- {n} ---\n{f.read()}")
            raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    BUILD_SECONDS.update({n: t for n, t in took.items() if t})
    return took


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "transfer_window":
        lib.transfer_window_launch.argtypes = [
            P, P, P, I, I, P, I, P, I, P, I, I, P, I, P, I] + [P] * 9
        lib.transfer_window_launch.restype = I
    elif name == "sharded_window":
        lib.sharded_window_launch.argtypes = [
            I, P, P, P, I, I, P, I, P, I, P, I, I, P, I, P, I, I] + [P] * 12
        lib.sharded_window_launch.restype = I
    elif name == "secp_recover":
        lib.secp_recover_launch.argtypes = [P, P, P, P, P, I, P]
        lib.secp_recover_launch.restype = I
    elif name == "keccak256_blocks":
        lib.keccak256_blocks_launch.argtypes = [P, P, P, I, I, P]
        lib.keccak256_blocks_launch.restype = I
    elif name == "u256x_eval":
        lib.u256x_eval_launch.argtypes = [I, P, P, P, P, I, P]
        lib.u256x_eval_launch.restype = I
    elif name == "step_machine":
        lib.step_machine_launch.argtypes = [P] * 24
        lib.step_machine_launch.restype = I
    elif name == "occ_window" or name.startswith("occ_window_spec_"):
        lib.occ_window_launch.argtypes = [P] * 31
        lib.occ_window_launch.restype = I
        # K9 (n, X, rows, pre, xc, xv, K6's 30, stream) and K9x
        lib.occ_sharded_launch.argtypes = [I, I] + [P] * 35
        lib.occ_sharded_launch.restype = I
        lib.shard_flags_launch.argtypes = [P, P, I, I, I, I, P, P]
        lib.shard_flags_launch.restype = I


def load(name: str, source: Optional[str] = None) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed:
    from ``csrc/`` or, with ``source``, from that generated unit."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if source is None:
                build([name])
            else:
                build_generated({name: source})
            lib = ctypes.CDLL(lib_path(name))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaGetLastError() from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")
