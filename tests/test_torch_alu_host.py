"""K4 (the 256-bit EVM ALU) and K3 (keccak-256) from their CUDA sources,
built for the host with g++, against Python integers and
``keccak256_py``.

``u256x.cuh`` and ``keccak.cuh`` switch to portable C++ off the card
(their carry chains on a flag threaded through ``cf``, the intrinsics in
plain C++); ``tests/secp_host_build.py``'s shims do the rest: the K4
entry's kernel body runs a thread at a time, the K3 entry's (two
threads a message, exchanging halves by shuffles) a warp at a time as
32 host threads.  The build counts the division's rare
paths (``U256_COUNT``), so the tests can show that each was taken.  The
PTX branch of the headers (the same chains as single instructions) is
checked only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

import chip_smoke
import occ_host_build as H
import secp_host_build as SH
import test_torch_alu as TA
from coreth_tpu_torch.crypto import keccak256_py
from coreth_tpu_torch.ops import keccak as tkeccak
from coreth_tpu_torch.ops import u256 as tu256
from coreth_tpu_torch.ops import u256x as tu256x

U256 = (1 << 256) - 1
PATHS = ("zero", "below", "oneword", "norm0", "corr1", "corr2", "addback",
         "topeq", "minneg1", "mod1", "sum257")

UNIT = r"""
#include <sys/mman.h>
#include <unistd.h>
static long long u256_counts[16];
#define U256_COUNT(k, cond) ((cond) ? (void)++u256_counts[k] : (void)0)
#include "u256x_eval.cu"
#include "keccak256_blocks.cu"
struct MemWord { uint32_t w[8]; };
extern "C" {
// every row through the K4 kernel body, a thread a row
int alu_eval(int op, const int32_t* a, const int32_t* b, const int32_t* c,
             int32_t* out, int n) {
  blockDim = {1, 1, 1};
  threadIdx = {0, 0, 0};
  for (int i = 0; i < n; ++i) {
    blockIdx = {(unsigned)i, 0, 0};
    u256x_eval_kernel(op, a, b, c, out, n);
  }
  return 0;
}
void alu_counts(long long* out) {
  for (int k = 0; k < 16; ++k) out[k] = u256_counts[k];
}
// the lane interpreter's SHA3: len bytes at byte a of a lane's memory
void keccak_mem(const uint8_t* mem, int a, int len, uint32_t* dg) {
  keccak256_mem(mem, a, len, dg);
}
// K7's device SHA3: size bytes at byte s of memory-model words
void keccak_be(const uint32_t* mw, int s, int size, uint32_t* dg) {
  keccak256_be_words((const MemWord*)mw, s, size, dg);
}
// keccak_mem on a message at the end of a page followed by a page that
// may not be read: the read stays inside the lane's memory (the page)
int keccak_guarded(const uint8_t* msg, int len, int off, uint32_t* dg) {
  const long page = sysconf(_SC_PAGESIZE);
  uint8_t* m = (uint8_t*)mmap(nullptr, 2 * page, PROT_READ | PROT_WRITE,
                              MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (m == MAP_FAILED) return -1;
  if (mprotect(m + page, page, PROT_NONE) != 0) return -2;
  int a = (int)page - len;
  a -= ((a & 3) - off + 4) & 3;  // the highest start at offset off
  for (int j = 0; j < len; ++j) m[a + j] = msg[j];
  keccak256_mem(m, a, len, dg);
  munmap(m, 2 * page);
  return a;
}
// the K3 entry's kernel, its CTAs (one warp each) in turn
int keccak_blocks(const uint32_t* blocks, const int32_t* nblocks,
                  uint32_t* out, int n, int nb) {
  const int threads = 2 * n;
  return shim_launch(0, (threads + kBlock - 1) / kBlock,
                     kBlock, keccak256_blocks_kernel, blocks, nblocks,
                     out, n, nb);
}
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``u256x_eval.cu`` and ``keccak256_blocks.cu`` built for the host,
    once a module."""
    if H.gxx() is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("alu_host")
    H.write_csrc(str(tmp))
    for fn in ("u256x_eval.cu", "keccak256_blocks.cu"):
        with open(os.path.join(str(tmp), fn)) as f:
            src = H.host_source(f.read())
        with open(os.path.join(str(tmp), fn), "w") as f:
            f.write(src)
    out = str(tmp / "libalu_host.so")
    unit = os.path.join(str(tmp), "unit.cpp")
    with open(unit, "w") as f:
        f.write(SH.SHIM + UNIT)
    import subprocess
    r = subprocess.run([H.gxx(), "-std=c++20", "-w", "-O1", "-shared",
                        "-fPIC", "-I", str(tmp), "-o", out, unit,
                        "-lpthread"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.alu_eval.argtypes = [I, P, P, P, P, I]
    lib.alu_counts.argtypes = [P]
    lib.keccak_mem.argtypes = [P, I, I, P]
    lib.keccak_be.argtypes = [P, I, I, P]
    lib.keccak_guarded.argtypes = [P, I, I, P]
    lib.keccak_blocks.argtypes = [P, P, P, I, I]
    return lib


def _counts(lib) -> dict:
    c = np.zeros(16, dtype=np.int64)
    lib.alu_counts(c.ctypes.data)
    return dict(zip(PATHS, c.tolist()))


def _eval(lib, op, a, b, c):
    rows = [tu256.pack_np(v) for v in (a, b, c)]
    out = np.zeros_like(rows[0])
    lib.alu_eval(tu256x.OP_INDEX[op], *(r.ctypes.data for r in rows),
                 out.ctypes.data, len(a))
    return tu256.to_ints(out)


def _random(seed, n):
    """n operands: random 256-, 128-, 64- and 32-bit values, powers of two
    and their neighbours, and words of all ones or zeros."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = int(rng.integers(6))
        if kind < 4:
            bits = (256, 128, 64, 32)[kind]
            out.append(int.from_bytes(rng.bytes(32), "big") >> (256 - bits))
        elif kind == 4:
            out.append(((1 << int(rng.integers(256)))
                        + int(rng.integers(-2, 3))) & U256)
        else:
            ws = rng.choice([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                            size=8)
            out.append(sum(int(w) << (32 * i) for i, w in enumerate(ws)))
    return out


DIV_OPS = ("div", "mod", "sdiv", "smod", "addmod", "mulmod")


def test_host_build_alu_ops_match_integers(host):
    """All 24 ops of the K4 kernel body, g++-built, against Python
    integers: every pair of the edge values, then seeded random
    operands (EXP on exponents up to 256 bits)."""
    edges = TA.EDGE + [U256 - 2, (1 << 255) - 2, 1 << 224, (1 << 32) - 1]
    a = [x for x in edges for _ in edges] + _random(1, 600)
    b = [y for _ in edges for y in edges] + _random(2, 600)
    c = (edges * len(edges)) + _random(3, 600)
    for op in tu256x.OPS:
        got = _eval(host, op, a, b, c)
        want = [TA._truth(op, x, y, z) for x, y, z in zip(a, b, c)]
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        assert not bad, (op, [(a[i], b[i], c[i]) for i in bad[:3]])


def test_host_build_division_reaches_every_rare_path(host):
    """The division family on operands built for its rare paths
    (``chip_smoke.division_operands``): results equal Python integers,
    and the build's counters show every path taken (digit estimates
    corrected once and twice, the add-back, a normalisation shift of 0,
    one-word divisors, a dividend below the divisor, -2^255 / -1, MULMOD
    by 1, ADDMOD's 257-bit sum)."""
    a, b, c = chip_smoke.division_operands()
    before = _counts(host)
    for op in DIV_OPS:
        got = _eval(host, op, a, b, c)
        want = [TA._truth(op, x, y, z) for x, y, z in zip(a, b, c)]
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        assert not bad, (op, [(a[i], b[i], c[i]) for i in bad[:3]])
    after = _counts(host)
    hits = {k: after[k] - before[k] for k in PATHS}
    assert all(v > 0 for v in hits.values()), hits


def test_host_build_keccak_every_length_and_offset(host):
    """The lane interpreter's SHA3 (32-bit word absorb from a lane's
    memory) and K7's (from memory-model words) against keccak256_py at
    every length 0-271 and start offsets 0-3; the same at the end of the
    lane's memory, with the next page unreadable."""
    rng = np.random.default_rng(7)
    image = np.frombuffer(rng.bytes(1024), dtype=np.uint8).copy()
    # the same bytes as EVM memory words: 32 bytes big-endian each
    mw = image.reshape(-1, 32)[:, ::-1].copy().view(np.uint32)
    dg = np.zeros(8, dtype=np.uint32)
    for n in range(272):
        msg = image[:n].tobytes()
        at_end = keccak256_py(msg)
        for off in range(4):
            a = 4 * (n % 97) + off
            want = keccak256_py(image[a:a + n].tobytes())
            host.keccak_mem(image.ctypes.data, a, n, dg.ctypes.data)
            assert dg.tobytes() == want, ("mem", n, off)
            host.keccak_be(mw.ctypes.data, a, n, dg.ctypes.data)
            assert dg.tobytes() == want, ("memory words", n, off)
            start = host.keccak_guarded(msg, n, off, dg.ctypes.data)
            assert start >= 0 and start % 4 == off
            assert dg.tobytes() == at_end, ("guarded", n, off)


def test_host_build_keccak_blocks_entry(host):
    """The K3 entry's kernel (two threads a message, its warps as 32 host
    threads meeting at every shuffle) on host-padded messages of 0-407
    bytes against keccak256_py: a warp's messages of one, two and three
    blocks."""
    rng = np.random.default_rng(9)
    lens = list(range(0, 408, 3)) + [135, 136, 271, 272]
    msgs = [rng.bytes(n) for n in lens]
    blocks, nblocks = tkeccak.pack_blocks(msgs)
    out = np.zeros((len(msgs), 8), dtype=np.uint32)
    assert host.keccak_blocks(blocks.ctypes.data, nblocks.ctypes.data,
                              out.ctypes.data, len(msgs),
                              blocks.shape[1]) == 0
    assert tkeccak.digests(out) == [keccak256_py(m) for m in msgs]
