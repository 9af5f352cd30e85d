"""The port's sharded transfer replay on the CPU against the JAX reference.

The reference runs its shards on the virtual 8-device CPU mesh of
``tests/conftest.py``; the port runs the plain versions of K8 (the
sharded transfer window, ``replay/shard.py``) and K8r (the sharded
ladder, ``ops/secp.py``) with ``device="cpu"``.  Inputs come from numpy
seeds and from both chain builders; every compared value is an integer
or a hash: tolerance 0.  Mirrors tests/test_shard_replay.py,
tests/test_parallel.py and tests/test_batch_recovery.py at their small
sizes (capacity 256, batch_pad 64, window 4).

The CUDA sources of K1 and K8 cannot run here, but their device code is
plain C++: a host build (g++, CUDA spellings shimmed, each CTA of the
cluster one host thread, the cluster barrier a ``std::barrier``) must
equal the plain versions.  tests/test_torch_cuda.py runs the kernels on
the card.
"""

import ctypes
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from coreth_tpu import parallel as rpar
from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.replay import engine as rengine
from coreth_tpu.replay import shard as rshard
from coreth_tpu.state import Database
from coreth_tpu.types import Block as RBlock
from coreth_tpu.types import StateAccount as RStateAccount

from coreth_tpu_torch import kernels, parallel as tpar
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.ops import secp as S
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import DeviceState, ReplayEngine
from coreth_tpu_torch.replay import engine as tengine
from coreth_tpu_torch.replay import shard as tshard
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block, StateAccount

import chip_smoke
from test_torch_machine_replay import ADDRS, RCFG, _chains, _erc20_txs
from test_torch_occ_replay import _counters, _record_flushes


def _rmesh(n):
    return None if n is None else rpar.make_mesh(jax.devices("cpu")[:n])


def _tmesh(n):
    return None if n is None else tpar.make_mesh(n)


# ------------------------------------------------------ placement helpers
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_placement_helpers_match_reference(n):
    rng = np.random.default_rng(40 + n)
    hashes = [rng.bytes(32) for _ in range(64)]
    for h in hashes:
        assert tpar.account_bucket(h, n) == rpar.account_bucket(h, n)
        assert tpar.contract_bucket(h, n) == rpar.contract_bucket(h, n)
        assert tpar.slot_bucket(h, n) == rpar.slot_bucket(h, n)
    rows = rng.integers(0, 64 * n, size=50).tolist()
    assert tpar.remap_rows(rows, 64, 128) == rpar.remap_rows(rows, 64, 128)
    for touched in (0, 100, 1000, 4096, 5000):
        assert tpar.exchange_mode(touched, 16384, n) == \
            rpar.exchange_mode(touched, 16384, n)


def test_exchange_mode_arguments_match_reference_env(monkeypatch):
    for forced, density in (("psum", 0.25), ("ppermute", 0.25),
                            (None, 0.0), (None, 0.9)):
        monkeypatch.setenv("CORETH_EXCHANGE", forced or "")
        monkeypatch.setenv("CORETH_EXCHANGE_DENSITY", str(density))
        for touched in (0, 3000, 8000):
            assert tpar.exchange_mode(touched, 16384, 4, forced, density) \
                == rpar.exchange_mode(touched, 16384, 4)


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("mode", ["psum", "ppermute"])
def test_collective_reduce_matches_reference(mode, op):
    """Both orders give equal int32 results (wrapping adds included),
    equal to the reference's collective inside a shard_map on the
    virtual mesh, every shard's result compared."""
    n = 8
    rng = np.random.default_rng(7)
    parts = rng.integers(-2**31, 2**31, size=(n, 5, 7), dtype=np.int64)
    parts = parts.astype(np.int32)
    mesh = rpar.make_mesh(jax.devices("cpu")[:n])
    fn = jax.jit(rpar._shard_map(
        lambda x: rpar.collective_reduce(x, "dp", n, mode, op), mesh=mesh,
        in_specs=PS("dp"), out_specs=PS("dp"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(parts)))
    got = tpar.collective_reduce_plain(torch.from_numpy(parts), mode, op)
    assert np.array_equal(got.numpy(), want)
    other = "ppermute" if mode == "psum" else "psum"
    assert torch.equal(got, tpar.collective_reduce_plain(
        torch.from_numpy(parts), other, op))


# ----------------------------------------------------- K8's plain version
def _window(seed, K=6, pad=32, B=24, cap=512, scap=64):
    rng = np.random.default_rng(seed)
    return chip_smoke.random_window(rng, K, pad, B, cap=cap, scap=scap,
                                    n_acct=200, n_slot=10, L=256, SL=16,
                                    t_pad=64, s_pad=16)


@pytest.mark.parametrize("mode", ["psum", "ppermute"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_window_plain_matches_reference(n, mode):
    """Seeded windows with an insolvent block, a nonce-mismatch block,
    token slot amounts and out-of-bounds pad rows: new tables and
    fetches exactly equal to the reference's sharded window; at n = 2
    the fetches also equal K1's plain version on the un-sharded window."""
    win = _window(100 + n)
    bal, non, sv, rows, srows, txds, ti, si = win
    perm = tshard.interleave_txs(txds.shape[1], n)
    assert np.array_equal(perm, rshard.interleave_txs(txds.shape[1], n))
    sharded = (bal, non, sv, rows, srows, txds[:, perm], ti, si)
    want = rshard.sharded_transfer_window(_rmesh(n), mode)(
        *(jnp.asarray(a) for a in sharded))
    got = tshard.sharded_transfer_window(
        *(torch.from_numpy(a) for a in sharded), n=n, mode=mode)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    oks = got[3][:, -1, 0].tolist()
    assert oks[1] == 0 and oks[2] == 0 and sum(oks) == len(oks) - 2
    if n == 2:
        k1 = tengine._transfer_window_plain(
            *(torch.from_numpy(a) for a in win))
        for g, w in zip(got, k1):
            assert torch.equal(g, w)


def test_sharded_window_refuses_bad_widths():
    args = [torch.from_numpy(a) for a in _window(5, cap=510)]
    for n, mode in ((3, "psum"), (16, "psum"), (4, "ring")):
        with pytest.raises(ValueError):
            tshard.sharded_transfer_window(*args, n=n, mode=mode)
    with pytest.raises(ValueError, match="divide"):
        tshard.sharded_transfer_window(*args, n=4, mode="psum")


# ------------------------------------------- host builds of K1 and K8
_SHIM = r"""
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static thread_local
struct Dim3Shim { unsigned x, y, z; };
inline Dim3Shim dim3(unsigned x, unsigned y, unsigned z) { return {x, y, z}; }
static thread_local Dim3Shim threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static Dim3Shim blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
inline void __syncthreads() {}
template <class T> T atomicAdd(T* p, T v) { T o = *p; *p = o + v; return o; }
template <class T> T atomicExch(T* p, T v) { T o = *p; *p = v; return o; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcg(T* p, T v) { *p = v; }
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
inline int cudaGetLastError() { return 0; }
static std::barrier<>* shim_barrier = nullptr;
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return blockIdx.x; }
  unsigned num_blocks() const { return gridDim.x; }
  void sync() const { shim_barrier->arrive_and_wait(); }
};
inline cluster_group this_cluster() { return {}; }
}
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
  gridDim = {n, 1, 1};
  std::barrier<> bar(n);
  shim_barrier = &bar;
  std::vector<std::thread> cta;
  for (unsigned b = 0; b < n; ++b)
    cta.emplace_back([&, b] { blockIdx = {b, 0, 0}; k(args...); });
  for (auto& t : cta) t.join();
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """K1 and K8 built for the host: one thread per CTA (every stride
    loop runs serially), each CTA of K8's cluster a host thread."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("host_kernels")
    with open(os.path.join(kernels.CSRC, "transfer_block.cuh")) as f:
        (tmp / "transfer_block.cuh").write_text(f.read())
    libs = {}
    for name in ("transfer_window", "sharded_window"):
        with open(os.path.join(kernels.CSRC, kernels.SOURCES[name])) as f:
            src = f.read()
        for inc in ("#include <cuda_runtime.h>",
                    "#include <cooperative_groups.h>"):
            src = src.replace(inc, "")
        src = src.replace("<<<1, 1024, 0, (cudaStream_t)stream>>>", "")
        (tmp / f"{name}.cpp").write_text(_SHIM + src)
        out = tmp / f"lib{name}.so"
        r = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", str(tmp), "-o", str(out),
                            str(tmp / f"{name}.cpp"), "-lpthread"],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[:4000]
        libs[name] = ctypes.CDLL(str(out))
        kernels._declare(name, libs[name])
    return libs


def _run_host_k8(lib, args, n, mode):
    bal, non, sv, rows, srows, txds, ti, si = args
    K, P = txds.shape[:2]
    L, SL = rows.shape[0], srows.shape[0]
    nb, nn, nsv = bal.clone(), non.clone(), sv.clone()

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)
    lb, ln, ls = z(n, L, 16), z(n, L), z(n, SL, 16)
    stamp, sstamp = z(n, L), z(n, SL)
    xa, xs, xn = z(2, n, L, tengine.ACCW), z(2, n, SL, 32), z(2, n)
    ra, rs = z(n, L, tengine.ACCW), z(n, SL, 32)
    f = z(K, ti.shape[1] + si.shape[1] + 1, 17)
    rc = lib.sharded_window_launch(
        n, nb.data_ptr(), nn.data_ptr(), nsv.data_ptr(), bal.shape[0] // n,
        sv.shape[0] // n, rows.data_ptr(), L, srows.data_ptr(), SL,
        txds.data_ptr(), K, P, ti.data_ptr(), ti.shape[1], si.data_ptr(),
        si.shape[1], int(mode == "ppermute"), lb.data_ptr(), ln.data_ptr(),
        ls.data_ptr(), stamp.data_ptr(), sstamp.data_ptr(), xa.data_ptr(),
        xs.data_ptr(), xn.data_ptr(), ra.data_ptr(), rs.data_ptr(),
        f.data_ptr(), None)
    assert rc == 0
    return (nb, nn, nsv, f), (lb, ln, ls)


@pytest.mark.parametrize("n,mode", [(1, "psum"), (2, "psum"),
                                    (4, "ppermute"), (8, "psum"),
                                    (8, "ppermute")])
def test_host_build_of_k8_matches_plain(host_kernels, n, mode):
    win = [torch.from_numpy(a) for a in _window(200 + n)]
    perm = torch.from_numpy(tshard.interleave_txs(win[5].shape[1], n))
    args = win[:5] + [win[5][:, perm].contiguous()] + win[6:]
    got, reps = _run_host_k8(host_kernels["sharded_window"], args, n, mode)
    want = tshard._sharded_window_plain(*args, n, mode,
                                        return_replicas=True)
    for g, w in zip(got, want[:4]):
        assert torch.equal(g, w)
    for g, w in zip(reps, want[4]):
        assert torch.equal(g, w)


def test_host_build_of_k1_matches_plain(host_kernels):
    """K1 after its per-block body moved into transfer_block.cuh."""
    bal, non, sv, rows, srows, txds, ti, si = (
        torch.from_numpy(a) for a in _window(300))
    K, P = txds.shape[:2]
    L, SL = rows.shape[0], srows.shape[0]
    nb, nn, nsv = bal.clone(), non.clone(), sv.clone()

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)
    scratch = (z(L, 16), z(L), z(SL, 16), z(L, tengine.ACCW), z(L),
               z(SL, 32), z(SL))
    f = z(K, ti.shape[1] + si.shape[1] + 1, 17)
    rc = host_kernels["transfer_window"].transfer_window_launch(
        nb.data_ptr(), nn.data_ptr(), nsv.data_ptr(), bal.shape[0],
        sv.shape[0], rows.data_ptr(), L, srows.data_ptr(), SL,
        txds.data_ptr(), K, P, ti.data_ptr(), ti.shape[1], si.data_ptr(),
        si.shape[1], *(t.data_ptr() for t in scratch), f.data_ptr(), None)
    assert rc == 0
    want = tengine._transfer_window_plain(bal, non, sv, rows, srows, txds,
                                          ti, si)
    for g, w in zip((nb, nn, nsv, f), want):
        assert torch.equal(g, w)


# ------------------------------------------------- K8r's plain version
def test_sharded_recover_plain_matches_reference():
    """16 signatures over 8 shards, two a shard (tests/test_parallel.py
    test_sharded_recover_matches_single_device)."""
    _packed, kin = chip_smoke.signature_batch(16, 11)
    want = rpar.sharded_recover(_rmesh(8))(*(jnp.asarray(a) for a in kin))
    got = S.sharded_recover(tpar.make_mesh(8))(
        *(torch.from_numpy(a) for a in kin))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- DeviceState growth
@pytest.mark.parametrize("n", [2, 4])
def test_device_state_growth_matches_reference(n):
    """Arena growth in shard mode moves every row (shard-major layout):
    values survive, rows stay in the owning arena, and ``row_of`` /
    ``slot_row_of`` equal the reference DeviceState's for the same
    sequence (tests/test_shard_replay.py
    test_sharded_row_arena_growth_remaps)."""
    ref = rengine.DeviceState(capacity=16, slot_capacity=16, n_shards=n)
    st = DeviceState(capacity=16, slot_capacity=16, device="cpu",
                     n_shards=n)
    addrs = [bytes([i]) * 20 for i in range(12)]
    for i, a in enumerate(addrs):
        ref.ensure(a, RStateAccount(balance=10**18 + i, nonce=i))
        st.ensure(a, StateAccount(balance=10**18 + i, nonce=i))
    st.flush_staged()
    before = st.read_accounts([st.index[a] for a in addrs])
    i = 0
    while st.capacity < 64:
        a = bytes([0x80 + i]) * 20
        ref.ensure(a, RStateAccount(balance=5, nonce=0))
        st.ensure(a, StateAccount(balance=5, nonce=0))
        i += 1
    st.flush_staged()
    ref.flush_staged()
    assert st.row_of == ref.row_of and st.capacity == ref.capacity
    assert st.read_accounts([st.index[a] for a in addrs]) == before
    assert np.array_equal(st.balances.numpy(), np.asarray(ref.balances))
    assert np.array_equal(st.nonces.numpy(), np.asarray(ref.nonces))
    arena = st.capacity // n
    assert len(set(st.row_of)) == len(st.row_of)
    for idx, row in enumerate(st.row_of):
        assert row // arena == tpar.account_bucket(st.addr_hashes[idx], n)
    # slot rows: contract-bucketed arenas, growth keeps them in place
    contracts = [bytes([0x30 + c]) * 20 for c in range(5)]
    for j in range(30):
        c = contracts[j % 5]
        # two statements: allocation may replace slot_row_of
        row = ref._alloc_slot_row(c)
        ref.slot_row_of.append(row)
        row = st._alloc_slot_row(c)
        st.slot_vals[row, 0] = j + 1
        st.slot_row_of.append(row)
    assert st.slot_row_of == ref.slot_row_of
    assert st.slot_capacity == ref.slot_capacity > 16
    sarena = st.slot_capacity // n
    for j, row in enumerate(st.slot_row_of[1:]):
        assert int(st.slot_vals[row, 0]) == j + 1
        assert row // sarena == tpar.contract_bucket(
            keccak256(contracts[j % 5]), n)


# ----------------------------------------------------------- end to end
GWEI = 10**9


def _transfer_chain(n_blocks=6):
    """Six senders to fresh recipients a block (every block crosses
    account buckets), as tests/test_shard_replay.py _gen_transfer."""
    def txs_of(i):
        return [(k, bytes([0x41 + i]) + bytes([k]) * 19, "raw", b"",
                 21_000, 1000 + 7 * i + k) for k in range(6)]
    return _chains(n_blocks, txs_of)


def _engines(rgen, pgen, n, window=4, **port_kw):
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header,
                        window=window, capacity=256, batch_pad=64,
                        mesh=_rmesh(n))
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, window=window, device="cpu",
                        mesh=_tmesh(n), **port_kw)
    return ref, port


def _replay_both(rgen, pgen, rblocks, n, **port_kw):
    """Both engines replay the chain; the roots of every window fold
    must agree (each fold also checks its header)."""
    ref, port = _engines(rgen, pgen, n, **port_kw)
    ref_roots = _record_flushes(ref.commit_pipe)
    port_roots = _record_flushes(port.commit_pipe)
    want = rblocks[-1].header.root
    assert ref.replay([RBlock.decode(b.encode()) for b in rblocks]) == want
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == want
    port.close()
    assert port_roots == ref_roots and port_roots
    assert ref.stats.blocks_fallback == 0
    return ref, port


@pytest.mark.parametrize("n", [None, 2, 4])
def test_transfer_replay_matches_reference(n):
    rgen, pgen, rblocks = _transfer_chain()
    ref, port = _replay_both(rgen, pgen, rblocks, n)
    assert port.stats.blocks_device == ref.stats.blocks_device == 6
    assert port.stats.n_shards == (n or 1)
    assert port.state.row_of == ref.state.row_of
    assert np.array_equal(port.state.balances.numpy(),
                          np.asarray(ref.state.balances))
    if n is None:
        assert port.stats.exchange_psum + port.stats.exchange_ppermute == 0
    else:
        assert port.stats.exchange_psum + port.stats.exchange_ppermute >= 2


def test_from_arrays_carries_the_reference_sharded_tables():
    """A 2-shard reference engine's tables and rows carried into the
    port (``from_arrays`` with ``n_shards``) replay on to the header
    root on a 2-shard port engine, with the arenas' fill equal."""
    rgen, pgen, rblocks = _transfer_chain()
    ref, port = _engines(rgen, pgen, 2)
    ref.replay([RBlock.decode(b.encode()) for b in rblocks[:3]])
    port.replay([Block.decode(b.encode()) for b in rblocks[:3]])
    st = ref.state
    meta = dict(addrs=st.addrs, row_of=st.row_of, has_code=st.has_code,
                multicoin=st.multicoin, code_hashes=st.code_hashes,
                roots=st.roots, slot_row_of=st.slot_row_of, n_shards=2)
    port.state = DeviceState.from_arrays(
        np.asarray(st.balances), np.asarray(st.nonces),
        np.asarray(st.slot_vals), meta, device="cpu")
    assert port.state.n_shards == 2
    assert port.state._arow == st._arow and port.state._srow == st._srow
    rest = [Block.decode(b.encode()) for b in rblocks[3:]]
    assert port.replay(rest) == rblocks[-1].header.root
    assert ref.replay([RBlock.decode(b.encode()) for b in rblocks[3:]]) \
        == rblocks[-1].header.root
    assert port.state.row_of == ref.state.row_of
    port.close()


@pytest.mark.parametrize("mode", ["psum", "ppermute"])
def test_exchange_modes_match_reference(monkeypatch, mode):
    """The forced exchange collective (tests/test_shard_replay.py
    test_exchange_mode_equivalence_classic_paths, transfer case)."""
    monkeypatch.setenv("CORETH_EXCHANGE", mode)
    rgen, pgen, rblocks = _transfer_chain(3)
    _ref, port = _replay_both(rgen, pgen, rblocks, 2, exchange=mode)
    used = port.stats.exchange_psum if mode == "psum" \
        else port.stats.exchange_ppermute
    assert used == 1
    assert port.stats.exchange_psum + port.stats.exchange_ppermute == 1


@pytest.mark.parametrize("shard_recover", [False, True])
def test_shard_recover_matches_reference(monkeypatch, shard_recover):
    """Sharded sender recovery inside the replay loop
    (tests/test_batch_recovery.py:78, :100): with it every signature
    recovers on the sharded ladder's plain version, without it on the
    native batch; ``sigs_device`` equals the reference's either way."""
    monkeypatch.setenv("CORETH_SHARD_RECOVER", "1" if shard_recover else "0")
    rgen, pgen, rblocks = _transfer_chain(3)
    ref, port = _replay_both(rgen, pgen, rblocks, 2,
                             shard_recover=shard_recover)
    assert port.stats.sigs_device == ref.stats.sigs_device
    assert port.stats.sigs_device == (18 if shard_recover else 0)
    assert port.stats.sigs_host == 18 - port.stats.sigs_device


def test_erc20_blocks_on_a_mesh_engine_match_reference(monkeypatch):
    """Machine blocks on a 2-shard engine keep the single-chip window
    runner (the reference's CORETH_SHARD_OCC=0), with a value-transfer
    block between them on K8: fold roots and machine counters equal."""
    for k, v in (("CORETH_SHARD_OCC", "0"), ("CORETH_DEVICE_OCC", "1"),
                 ("CORETH_SPECIALIZE", "0"),
                 ("CORETH_NO_TOKEN_FASTPATH", "1"),
                 ("CORETH_SERIAL_SHORTCIRCUIT", "0")):
        monkeypatch.setenv(k, v)
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()

    def txs_of(i):
        if i == 2:
            return [(k, ADDRS[(k + 3) % 8], "raw", b"", 21_000, 77 + k)
                    for k in range(4)]
        return _erc20_txs(i, 8)
    rgen, pgen, rblocks = _chains(4, txs_of)
    ref, port = _replay_both(rgen, pgen, rblocks, 2, specialize=False,
                             shard_occ=False)
    assert not ref._machine._runner.__class__.__name__.startswith("Sharded")
    assert type(port._machine._runner) is tadapter.MachineWindowRunner
    assert _counters(port, False) == _counters(ref, True)
    assert port._machine.blocks == 3
    assert port.stats.blocks_device == ref.stats.blocks_device == 4
    assert port.stats.exchange_psum + port.stats.exchange_ppermute == 1


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("case", ["width3", "width16", "capacity",
                                  "slot_capacity", "batch_pad",
                                  "shard_recover"])
def test_refusals(case):
    if case in ("width3", "width16"):
        with pytest.raises(ValueError):
            tpar.make_mesh(3 if case == "width3" else 16)
        return
    store = StateStore()
    kw = dict(capacity=256, slot_capacity=256, batch_pad=64,
              mesh=tpar.make_mesh(4))
    if case == "shard_recover":
        kw.update(mesh=None, shard_recover=True)
    else:
        kw[case] = 250
    with pytest.raises(ValueError):
        ReplayEngine(CFG, store, device="cpu", **kw)
