"""The port's sharded machine replay on the CPU against the JAX reference.

The reference runs its shards on the virtual 8-device CPU mesh of
``tests/conftest.py``; the port runs the plain versions of K9 (the
per-shard fused OCC window with the key-range replica sync,
``machine.occ_sharded_plain``) and of the flags reduce (the reference's
K9x, K9's epilogue in the port: ``machine.shard_flags_plain``) through
``ShardedWindowRunner``
(``evm/device/shard.py``) with ``device="cpu"``.  Every compared value
is an integer or a hash: tolerance 0.  Mirrors tests/test_shard_replay.py
(:147, :189, :208, :299, :448-554) at its small sizes (capacity 256,
batch_pad 64, windows of 2 machine blocks), with the reference's
``CORETH_NO_TOKEN_FASTPATH=1`` and ``CORETH_SERIAL_SHORTCIRCUIT=0`` so
token calls and swaps take the machine, as the port's do (its
``token_fastpath=False, serial_shortcircuit=False``); without K7
(``CORETH_SPECIALIZE=0``, ``specialize=False``) but in the key-range
case with K7 (:554), so that the cases share the reference's compiled
programs (tests/test_torch_specialize.py covers K7 itself).

K9's CUDA source cannot run here, but its device code is plain C++: a
host build (g++, CUDA spellings shimmed, each CTA of the cluster one host
thread, the cluster barrier a ``std::barrier``) must equal the plain
version.  tests/test_torch_cuda.py runs the kernels on the card.
"""

import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coreth_tpu import parallel as rpar
from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.evm.device import machine as jM
from coreth_tpu.evm.device import shard as rshard
from coreth_tpu.evm.device import tables as jtables
from coreth_tpu.replay import ReplayEngine as RReplayEngine
from coreth_tpu.state import Database
from coreth_tpu.types import Block as RBlock
from coreth_tpu.workloads import hot_contract as rhot

from coreth_tpu_torch import kernels, parallel as tpar
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.evm.device import machine as tM
from coreth_tpu_torch.evm.device import shard as tshard
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.workloads import hot_contract as thot

import occ_host_build as H
import torch_machine_cases as C
from test_torch_machine_replay import ADDRS, POOL, RCFG, TOKEN, _chains
from test_torch_occ_replay import COUNTERS, _record_flushes

_ALL_FEATURES = frozenset(jtables.FEATURE_OPS.values())
# the sharded runner's counters, on both packages' machine counters
SHARD_COUNTERS = ("kr_lanes", "exchange_psum", "exchange_ppermute",
                  "load_imb_sum", "load_imb_windows", "lanes_specialized",
                  "specialize_escapes", "programs_traced")


# frees JAX's compiled programs in any worker past half of the kernel's
# memory-mapping limit (the reference's sharded programs hold many)
pytest_plugins = ["xla_map_guard"]


@pytest.fixture(autouse=True, scope="module")
def _reference_cache():
    """The reference's sharded programs this module compiles go to a JAX
    disk cache of their own, in its locked mode: ``tests/conftest.py``'s
    shared cache writes an entry in place and unlocked, and two workers
    compiling the same sharded program (this module shares many with
    tests/test_shard_replay.py) could read a half-written entry.  A
    positive size limit makes JAX take a file lock around every read and
    write."""
    from jax.experimental.compilation_cache import compilation_cache as cc
    cfg = jax.config
    old_dir = cfg.jax_compilation_cache_dir
    old_max = cfg.jax_compilation_cache_max_size
    if old_dir:
        cfg.update("jax_compilation_cache_dir",
                   os.path.join(old_dir, "torch_shard_occ"))
        cfg.update("jax_compilation_cache_max_size", 1 << 40)
        cc.reset_cache()
    yield
    if old_dir:
        cfg.update("jax_compilation_cache_dir", old_dir)
        cfg.update("jax_compilation_cache_max_size", old_max)
        cc.reset_cache()


def _rmesh(n):
    return None if n is None else rpar.make_mesh(jax.devices("cpu")[:n])


def _tmesh(n):
    return None if n is None else tpar.make_mesh(n)


# ------------------------------------------- K9's and K9x's plain versions
def _reference_window(w, mode):
    """The reference's sharded window program on ``w``'s inputs."""
    n, p, occ = w["n"], w["p"], w["occ"]
    rp = jM.MachineParams(fork=p.fork, batch=p.batch, code_cap=p.code_cap,
                          data_cap=p.data_cap, scache_cap=p.scache_cap,
                          features=_ALL_FEATURES)
    rocc = jM.OccParams(blocks=occ.blocks, table_cap=occ.table_cap,
                        rounds=occ.rounds)
    rows = w["sync_rows"]
    fn = rshard.get_sharded_occ_machine(
        rp, rocc, _rmesh(n), (), 0 if rows is None else rows.shape[0], mode)
    inputs = {k: jnp.asarray(v.numpy()) for k, v in w["inputs"].items()}
    inputs["active"] = inputs["active"].astype(bool)
    args = [jnp.asarray(w["table"].numpy()), jnp.asarray(w["key_tab"].numpy()),
            inputs]
    if rows is not None:
        args.append(jnp.asarray(rows.numpy()))
    out = fn(*args)
    return np.asarray(out["table"]), np.asarray(out["packed"])


def _plain(w, mode):
    return tM.occ_sharded_plain(w["p"], w["occ"], w["table"], w["key_tab"],
                                w["inputs"], w["spec"], w["n"],
                                w["sync_rows"], mode)


@pytest.mark.parametrize("n,sync,mode", [
    (2, False, "psum"), (2, True, "psum"), (2, True, "ppermute"),
    (4, False, "ppermute"), (4, True, "psum"), (4, True, "ppermute")])
def test_occ_sharded_plain_matches_reference(n, sync, mode):
    """K9's plain version against the reference's
    ``build_sharded_occ_machine`` on n window cases side by side, with
    and without a key-range sync set (``sync_rows``; its copies seeded
    with random values, so the owner seed and the per-block broadcast
    both move values): tables and every packed column equal; K9x's plain
    version on the result equals ``get_shard_exchange``."""
    w = C.sharded_window(n, sync, seed=n)
    got = _plain(w, mode)
    jt, jp = _reference_window(w, mode)
    bad = np.argwhere(got["packed"].numpy() != jp)
    assert bad.size == 0, f"packed differs at (block, lane, col) {bad[:5]}"
    assert np.array_equal(got["table"].numpy(), jt)
    flags = tM.shard_flags_plain(got["packed"], w["inputs"]["active"], n,
                                 mode)
    want = rshard.get_shard_exchange(_rmesh(n), mode)(
        jnp.asarray(jp), jnp.asarray(w["inputs"]["active"].numpy() != 0))
    assert np.array_equal(flags.numpy(), np.asarray(want))
    assert torch.equal(got["flags"], flags)
    if sync:
        # the copies of each key agree after the window
        rows, G = w["sync_rows"].numpy(), w["occ"].table_cap
        tab = got["table"].numpy()
        for r in rows:
            vals = [tab[s * G + g] for s, g in enumerate(r[:n]) if g < G]
            assert all(np.array_equal(v, vals[0]) for v in vals)


def test_occ_sharded_plain_is_k6_per_shard():
    """Without a sync set each shard's slice is K6's plain version on that
    shard's own window; ``run_occ_sharded`` on CPU tensors is the plain
    version and launches nothing."""
    w = C.sharded_window(2, False)
    launches = tM.OCC_SHARDED_LAUNCHES
    got = tM.run_occ_sharded(w["p"], w["occ"], w["table"], w["key_tab"],
                             w["inputs"], w["spec"], 2)
    assert tM.OCC_SHARDED_LAUNCHES == launches
    names = sorted(C.WINDOW_CASES)
    B, G = w["p"].batch, w["occ"].table_cap
    for d in range(2):
        pk = C.pack_window(names[d])
        k6 = tM.occ_run_plain(pk["p"], pk["occ"], pk["table"], pk["key_tab"],
                              pk["inputs"])
        assert torch.equal(got["table"][d * G:(d + 1) * G], k6["table"])
        assert torch.equal(got["packed"][:, d * B:(d + 1) * B], k6["packed"])
        assert torch.equal(got["steps"][:, d * B:(d + 1) * B], k6["steps"])


def test_sharded_wrappers_refuse_bad_shapes():
    w = C.sharded_window(2, True)
    args = (w["p"], w["occ"], w["table"], w["key_tab"], w["inputs"])
    for n, mode in ((3, "psum"), (16, "psum"), (2, "ring")):
        with pytest.raises(ValueError):
            tM.run_occ_sharded(*args, (), n, w["sync_rows"], mode)
    with pytest.raises(ValueError, match="tables"):
        tM.run_occ_sharded(*args, (), 4, None, "psum")
    with pytest.raises(ValueError, match="sync_rows"):
        tM.run_occ_sharded(*args, (), 2, w["sync_rows"][:, :2], "psum")
    with pytest.raises(ValueError):
        tM.shard_flags_plain(torch.zeros((4, 6, 10), dtype=torch.int32),
                             torch.zeros((4, 6), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        tM.shard_flags_plain(torch.zeros((4, 8, 10), dtype=torch.int32),
                             torch.zeros((4, 6), dtype=torch.int32), 4)


# ------------------------------------------------------ host build of K9
@pytest.fixture(scope="module")
def host_k9(tmp_path_factory):
    """K6 and K9 (with its flags epilogue) of ``csrc/occ_window.cu``
    built for the host (``tests/occ_host_build.py``), each CTA of the
    launch's cluster a host thread."""
    if H.gxx() is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("host_k9")
    out = tmp / "libocc_window.so"
    r = H.build(str(tmp), '#include "occ_window.cu"\n', str(out), "-O1")
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(str(out))
    kernels._declare("occ_window", lib)
    return lib


def _run_host_k9(lib, w, mode):
    n, X = w["n"], 0 if w["sync_rows"] is None else w["sync_rows"].shape[0]
    args, out = tM.occ_launch_args(w["p"], w["occ"], w["table"],
                                   w["key_tab"], w["inputs"], n)
    rows = w["sync_rows"] if X else torch.zeros((1, n + 1), dtype=torch.int32)
    pre = torch.zeros((n, max(X, 1), 16), dtype=torch.int32)
    xc = torch.zeros((2, n, max(X, 1)), dtype=torch.int32)
    xv = torch.zeros((2, n, max(X, 1), 16), dtype=torch.int32)
    W = w["occ"].blocks
    # the window's (W, 2) flags, then the kernel's (W, n, 2) slot; -7
    # where nothing was written
    flags = torch.full((2 * W * (n + 1),), -7, dtype=torch.int32)
    rc = lib.occ_sharded_launch(n, X, rows.data_ptr(), pre.data_ptr(),
                                xc.data_ptr(), xv.data_ptr(),
                                flags.data_ptr(), *tM.pointers(args), None)
    assert rc == 0
    return out, flags[:2 * W].view(W, 2)


@pytest.mark.parametrize("sync,mode", [(False, "psum"), (True, "psum"),
                                       (True, "ppermute")])
def test_host_build_of_k9_matches_plain(host_k9, sync, mode):
    """K9 (two CTAs of one cluster, with and without the sync set) with
    its flags epilogue from the CUDA source, built for the host, against
    the plain versions: table, packed rows, lane-steps and the flags
    (``shard_flags_plain`` of the packed rows) equal."""
    w = C.sharded_window(2, sync, seed=7)
    got, flags = _run_host_k9(host_k9, w, mode)
    want = _plain(w, mode)
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(flags, tM.shard_flags_plain(
        want["packed"], w["inputs"]["active"], 2, mode))
    assert torch.equal(flags, want["flags"])


def test_host_build_of_k9_flags_of_a_dirty_window(host_k9):
    """K9's flags epilogue on a window of four shards whose block 0 is
    not clean: shard 0 has escaping lanes (``host_and_miss``), shard 1
    lanes still pending when the rounds run out (``raw_chain`` at 3 of
    its 6 rounds), shards 2 and 3 commit; so block 0's flags are (2, 2),
    not (4, 0).  Equal to ``shard_flags_plain`` and to the plain
    version's."""
    w = C.sharded_window(4, False, names=["host_and_miss", "raw_chain",
                                          "disjoint", "chained_blocks"])
    w["occ"] = tM.OccParams(blocks=w["occ"].blocks,
                            table_cap=w["occ"].table_cap, rounds=3)
    got, flags = _run_host_k9(host_k9, w, "psum")
    want = _plain(w, "psum")
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(flags, want["flags"])
    assert flags[0].tolist() == [2, 2]
    assert flags[1:].tolist() == [[4, 0]] * (w["occ"].blocks - 1)


def test_host_build_of_k9_flags_without_lanes(host_k9):
    """A window whose blocks have no lane (dims' batch 0) launches no
    K9, and its flags are still ``shard_flags_plain``'s: every shard
    clean."""
    w = C.sharded_window(2, False)
    args, _out = tM.occ_launch_args(w["p"], w["occ"], w["table"],
                                    w["key_tab"], w["inputs"], 2)
    dims = next(a for a in args if isinstance(a, np.ndarray))
    dims[0] = 0
    W = w["occ"].blocks
    flags = torch.full((2 * W * 3,), -7, dtype=torch.int32)
    z = torch.zeros((1,), dtype=torch.int32)
    rc = host_k9.occ_sharded_launch(2, 0, z.data_ptr(), z.data_ptr(),
                                    z.data_ptr(), z.data_ptr(),
                                    flags.data_ptr(), *tM.pointers(args),
                                    None)
    assert rc == 0
    want = tM.shard_flags_plain(torch.zeros((W, 0, 8), dtype=torch.int32),
                                torch.zeros((W, 0), dtype=torch.int32), 2)
    assert torch.equal(flags[:2 * W].view(W, 2), want)
    assert want.tolist() == [[2, 0]] * W


def test_host_build_of_k9_runs_k6_unchanged(host_k9):
    """The K6 entry of the same build (K6 and K9 share the group body
    ``occ_group``) equals K6's plain version."""
    pk = C.pack_window("chained_blocks")
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    largs, got = tM.occ_launch_args(*args)
    assert host_k9.occ_window_launch(*tM.pointers(largs), None) == 0
    want = tM.occ_run_plain(*args)
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k


# block 0's rounds, escapes and pending lanes in each sweep case (the
# plain version's), so a case that stopped pinning its shape fails
_SWEEP_SHAPES = {"disjoint_wide": (1, 0, 0),
                 "early_writer_later_reader": (2, 0, 0),
                 "escape_before_dependent": (1, 1, 1),
                 "last_valid_writer_wins": (3, 0, 0),
                 "write_only_overlap": (2, 0, 0)}


@pytest.mark.parametrize("name", sorted(C.SWEEP_CASES))
def test_host_build_sweep_matches_plain(host_k9, name):
    """K6 on blocks of 32 lanes, a group of two CTAs of 16 lanes, each
    case of the sweep that walks in order only the lanes an earlier
    potential writer can touch (``torch_machine_cases.SWEEP_CASES``):
    table, packed rows and lane-steps equal to ``occ_run_plain``
    (tolerance 0)."""
    pk = C.pack_window(name, batch=32)
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    largs, got = tM.occ_launch_args(*args)
    assert host_k9.occ_window_launch(*tM.pointers(largs), None) == 0
    want = tM.occ_run_plain(*args)
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k
    extra = want["packed"][0, :, -4:]
    assert (int(extra[0, 3]), int(extra[:, 1].sum()),
            int(extra[:, 2].sum())) == _SWEEP_SHAPES[name]


def test_host_build_sweep_wide_index_matches_plain(host_k9):
    """K6 on a block of 64 lanes x 1024 cache entries (B*S = 65536: the
    sweep's index columns int32, its area in device memory; a group of
    four CTAs) whose writers and dependent lanes sit past entry 32767
    (``torch_machine_cases.WIDE_INDEX_BLOCKS``): table, packed rows and
    lane-steps equal to ``occ_run_plain`` (tolerance 0), in three rounds
    with every lane committed."""
    pk = C.pack_window(C.WIDE_INDEX_BLOCKS, **C.WIDE_INDEX_SHAPE)
    assert pk["p"].batch * pk["p"].scache_cap > 32768
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    largs, got = tM.occ_launch_args(*args)
    assert host_k9.occ_window_launch(*tM.pointers(largs), None) == 0
    want = tM.occ_run_plain(*args)
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k
    extra = want["packed"][0, :, -4:]
    assert (int(extra[0, 3]), int(extra[:, 0].sum())) == (3, 64)


def test_host_build_of_k9_runs_the_sweep_cases(host_k9):
    """K9 with two shards of 32 lanes (a cluster of 2 x 2 CTAs as host
    threads) over two sweep cases: equal to the plain version."""
    w = C.sharded_window(2, False, names=["early_writer_later_reader",
                                          "last_valid_writer_wins"],
                         batch=32)
    got, flags = _run_host_k9(host_k9, w, "psum")
    want = _plain(w, "psum")
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------ the runner
def test_sharded_table_growth_pads_on_device():
    """A per-shard cap re-bucket pads every arena in place (rows
    s*G_old + g -> s*G + g): the grown tables equal a rebuild from the
    mirror at the new cap, and the reference's
    (tests/test_shard_replay.py:299)."""
    vals = {}
    contracts = [bytes([0x10 + i]) * 20 for i in range(6)]

    def fill(runners, per_contract):
        for c in contracts:
            for j in range(per_contract):
                key = bytes([j]) + b"\x01" * 31
                vals[(c, key)] = 1 + j + c[0]
                for r in runners:
                    r._gid(c, key)

    def resolve(c, k):
        return vals.get((c, k), 0)
    ref = rshard.ShardedWindowRunner("durango", resolve, _rmesh(2))
    port = tshard.ShardedWindowRunner("durango", resolve, _tmesh(2),
                                      device="cpu")
    fill((ref, port), 10)
    for r in (ref, port):
        r._device_tables(64)
        assert r.table_cap == 64 and not r._stale
    fill((ref, port), 20)
    rt, rk = ref._device_tables(128)
    t, k = port._device_tables(128)
    assert port.table_cap == 128
    assert np.array_equal(t.numpy(), np.asarray(rt))
    assert np.array_equal(k.numpy(), np.asarray(rk))
    t, k = t.clone(), k.clone()
    port._stale = True
    tf, kf = port._device_tables(128)
    assert torch.equal(t, tf) and torch.equal(k, kf)
    assert port.copies == ref.copies and port.vals == ref.vals


# ----------------------------------------------------------- end to end
def _machine_env(mp, window=2, specialize=False, **env):
    """The reference's machine path for these chains; its window size,
    and the port's, is ``window`` blocks, with K7 or without."""
    mp.setenv("CORETH_NO_TOKEN_FASTPATH", "1")
    mp.setenv("CORETH_SERIAL_SHORTCIRCUIT", "0")
    mp.setenv("CORETH_MACHINE_WINDOW", str(window))
    mp.setenv("CORETH_SPECIALIZE", "1" if specialize else "0")
    for k, v in env.items():
        mp.setenv(k, v)
    radapter.RECIPES.clear()
    tadapter.RECIPES.clear()


def _replay_both(mp, genesis_pair, rblocks, n, window=2, env=None,
                 specialize=False, **port_kw):
    """Both engines (capacity 256, batch_pad 64, window 4) replay the
    chain at width n (None: one shard), without K7 unless ``specialize``
    (fewer distinct reference programs to compile); every fold's root
    must agree and equal the headers.  Returns (ref, port)."""
    rgen, pgen = genesis_pair
    _machine_env(mp, window, specialize, **(env or {}))
    db = Database()
    rgb = rgen.to_block(db)
    ref = RReplayEngine(RCFG, db, rgb.root, parent_header=rgb.header,
                        window=4, capacity=256, batch_pad=64, mesh=_rmesh(n))
    ref_roots = _record_flushes(ref.commit_pipe)
    want = rblocks[-1].header.root
    assert ref.replay([RBlock.decode(b.encode()) for b in rblocks]) == want
    assert ref.stats.blocks_fallback == 0
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, window=4, device="cpu", mesh=_tmesh(n),
                        specialize=specialize, token_fastpath=False,
                        serial_shortcircuit=False, **port_kw)
    port._machine_executor().WINDOW = window
    port_roots = _record_flushes(port.commit_pipe)
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == want
    port.close()
    assert port_roots == ref_roots and port_roots
    return ref, port


def _assert_counters_equal(ref, port):
    rmx, pmx = ref._machine, port._machine
    rc, pc = rmx.machine_counters(), pmx.counters()
    for k in COUNTERS:
        assert pc[k] == (rc[k] if k in rc else getattr(rmx, k)), k
    for k in SHARD_COUNTERS:
        assert pc[k] == rc[k], k
    assert port.stats.load_imbalance == ref.stats.load_imbalance
    if port.mesh is not None and port.shard_occ:
        assert pmx._runner.cross_shard == rmx._runner.cross_shard


def _txs(kind):
    """tests/test_shard_replay.py's chain shapes as (key, to, kind, arg,
    gas, value) rows."""
    def erc20(i):
        return [(k, TOKEN, "transfer", (ADDRS[(k + 1) % 8], 5 + k),
                 200_000, 0) for k in range(6)]

    def swap(i):
        return [(k, POOL, "swap", 1000 + 17 * i + k, 200_000, 0)
                for k in range(6)]

    def mixed(i):
        return [(0, POOL, "swap", 500 + i, 200_000, 0),
                (1, TOKEN, "transfer", (ADDRS[(i + 3) % 8], 7), 200_000, 0),
                (2, bytes([0x46]) * 20, "raw", b"", 21_000, 5 + i),
                (3, POOL, "swap", 900 + i, 200_000, 0)]
    return {"erc20": erc20, "swap": swap, "mixed": mixed}[kind]


def _chain(kind, n_blocks):
    rgen, pgen, rblocks = _chains(n_blocks, _txs(kind))
    return (rgen, pgen), rblocks


@pytest.mark.parametrize("n", [None, 2, 4])
@pytest.mark.parametrize("kind", ["erc20", "swap", "mixed"])
def test_machine_chains_match_reference(monkeypatch, kind, n):
    """tests/test_shard_replay.py:147 (erc20, swap, mixed; 4 blocks):
    fold roots, window counters and the sharded runner's placement
    counters equal to the reference's at every width; on a mesh the
    machine windows run on the sharded runner and K9x."""
    gens, rblocks = _chain(kind, 4)
    ref, port = _replay_both(monkeypatch, gens, rblocks, n)
    _assert_counters_equal(ref, port)
    runner = port._machine._runner
    assert isinstance(runner, tshard.ShardedWindowRunner) == (n is not None)
    assert port._machine.blocks == ref._machine.blocks > 0
    if n is not None:
        last = runner.last_handle
        assert torch.equal(last["ex"], tM.shard_flags_plain(
            last["out"]["packed"], last["active"], n, last["xchg_mode"]))


def test_sharded_runner_vs_single_chip_runner(monkeypatch):
    """tests/test_shard_replay.py:189: ``shard_occ=False`` keeps the
    single-chip runner on a mesh engine; both land the reference's
    roots."""
    gens, rblocks = _chain("mixed", 3)
    _ref, sharded = _replay_both(monkeypatch, gens, rblocks, 2)
    _ref, single = _replay_both(monkeypatch, gens, rblocks, 2,
                                env={"CORETH_SHARD_OCC": "0"},
                                shard_occ=False)
    assert isinstance(sharded._machine._runner, tshard.ShardedWindowRunner)
    assert type(single._machine._runner) is tadapter.MachineWindowRunner


def test_exchange_overlaps_next_window_dispatch(monkeypatch):
    """tests/test_shard_replay.py:208: when the flags reduce says a
    window is clean, the next window is launched before this one's
    packed rows are fetched; the port's dispatch / fetch order equals
    the reference's (sequence numbers counted from each log's first)."""
    gens, rblocks = _chain("swap", 6)
    rshard.EVENT_LOG.clear()
    tshard.EVENT_LOG.clear()
    try:
        ref, port = _replay_both(monkeypatch, gens, rblocks, 2)
        rev, pev = list(rshard.EVENT_LOG), list(tshard.EVENT_LOG)
    finally:
        rshard.EVENT_LOG.clear()
        tshard.EVENT_LOG.clear()
    assert port._machine.windows >= 3

    def norm(ev):
        base = min(int(e.split(":")[1]) for e in ev)
        return [f"{e.split(':')[0]}:{int(e.split(':')[1]) - base}"
                for e in ev]
    assert norm(pev) == norm(rev)
    seqs = sorted({int(e.split(":")[1]) for e in pev})
    overlapped = [
        s for s in seqs
        if f"exchange_fetch:{s}" in pev and f"dispatch:{s + 1}" in pev
        and f"result_fetch:{s}" in pev
        and pev.index(f"exchange_fetch:{s}")
        < pev.index(f"dispatch:{s + 1}") < pev.index(f"result_fetch:{s}")]
    assert overlapped, f"no overlapped window in {pev}"


# ------------------------------------------------------------- key range
def _hot(n_blocks=6, txs=6, n_keys=8):
    rgen, rblocks = rhot.build_hot_chain(RCFG, n_blocks, txs, n_keys=n_keys,
                                         seed=20260804)
    pgen, pblocks = thot.build_hot_chain(CFG, n_blocks, txs, n_keys=n_keys,
                                         seed=20260804)
    assert [b.hash() for b in pblocks] == [b.hash() for b in rblocks]
    return (rgen, pgen), rblocks


def test_hot_chain_matches_reference_on_one_shard(monkeypatch):
    gens, rblocks = _hot()
    ref, port = _replay_both(monkeypatch, gens, rblocks, None)
    _assert_counters_equal(ref, port)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["psum", "ppermute"])
def test_keyrange_exchange_mode_equivalence(monkeypatch, mode, n):
    """tests/test_shard_replay.py:448: the hot-contract chain (6 blocks of
    6 transfers, 8 keys, threshold 3) at widths 2 and 4 in both forced
    modes: roots and counters equal to the reference's, key-range
    placement active, and only the forced mode counted."""
    gens, rblocks = _hot()
    ref, port = _replay_both(
        monkeypatch, gens, rblocks, n,
        env={"CORETH_KEYRANGE_THRESHOLD": "3", "CORETH_EXCHANGE": mode},
        keyrange_threshold=3, exchange=mode)
    _assert_counters_equal(ref, port)
    mc = port.machine_counters()
    assert mc["kr_lanes"] > 0
    other = "exchange_ppermute" if mode == "psum" else "exchange_psum"
    assert mc[f"exchange_{mode}"] > 0 and mc[other] == 0
    assert port.stats.load_imbalance > 0


def test_keyrange_off_pins_the_hot_contract(monkeypatch):
    """The engine's ``keyrange=False`` against the reference's
    ``CORETH_KEYRANGE=0``: the hot-contract chain at width 2, past the
    threshold, stays on its contract bucket (no key-range lane, no
    sync), roots and counters equal."""
    gens, rblocks = _hot()
    ref, port = _replay_both(
        monkeypatch, gens, rblocks, 2,
        env={"CORETH_KEYRANGE": "0", "CORETH_KEYRANGE_THRESHOLD": "3"},
        keyrange=False, keyrange_threshold=3)
    _assert_counters_equal(ref, port)
    mc = port.machine_counters()
    assert mc["kr_lanes"] == 0
    assert mc["exchange_psum"] == mc["exchange_ppermute"] == 0
    assert not port._machine._runner._kr


@pytest.mark.parametrize("mode", ["psum", "ppermute"])
def test_exchange_modes_on_the_contract_bucket_path(monkeypatch, mode):
    """tests/test_shard_replay.py:479, machine case: with the threshold
    at 64 the token stays on its contract bucket, so only the flags
    reduce changes mode; roots equal in both."""
    gens, rblocks = _chain("erc20", 3)
    ref, port = _replay_both(
        monkeypatch, gens, rblocks, 2,
        env={"CORETH_KEYRANGE_THRESHOLD": "64", "CORETH_EXCHANGE": mode},
        keyrange_threshold=64, exchange=mode)
    _assert_counters_equal(ref, port)
    assert port.machine_counters()["kr_lanes"] == 0


def _hot_genesis_chains(txs_of, n_blocks):
    """Both builders' chains of ``txs_of`` rows on the hot workload's
    genesis (the hot contract funded for ``ADDRS``); asserts they are the
    same blocks."""
    from coreth_tpu.chain import Genesis as RGenesis
    from coreth_tpu.chain import generate_chain as r_generate_chain
    from coreth_tpu_torch.chain import Genesis, generate_chain
    from test_torch_machine_replay import PORT, REF, _gen
    rgen = RGenesis(config=RCFG, gas_limit=8_000_000,
                    alloc=rhot.hot_genesis_alloc(ADDRS))
    pgen = Genesis(config=CFG, gas_limit=8_000_000,
                   alloc=thot.hot_genesis_alloc(ADDRS))
    db = Database()
    rgb = rgen.to_block(db)
    rblocks, _ = r_generate_chain(RCFG, rgb, db, n_blocks,
                                  _gen(REF, txs_of), gap=2)
    store = StateStore()
    pgb = pgen.to_block(store)
    assert pgb.hash() == rgb.hash()
    pblocks, _ = generate_chain(CFG, pgb, store, n_blocks,
                                _gen(PORT, txs_of), gap=2)
    assert [b.hash() for b in pblocks] == [b.hash() for b in rblocks]
    return (rgen, pgen), rblocks


def test_keyrange_empty_sync_set(monkeypatch):
    """tests/test_shard_replay.py:500: hot-contract lanes that never share
    a key (distinct senders to unique fresh recipients): the sync runs in
    every window (``_xchg_hw > 0``) with an empty set, and roots stay
    the reference's."""
    def txs_of(i):
        return [(k, thot.HOT_CONTRACT, "transfer",
                 (bytes([0x51 + i]) + bytes([k]) * 15 + b"\x51" * 4, 3 + k),
                 200_000, 0) for k in range(6)]
    gens, rblocks = _hot_genesis_chains(txs_of, 4)
    ref, port = _replay_both(
        monkeypatch, gens, rblocks, 2,
        env={"CORETH_KEYRANGE_THRESHOLD": "3", "CORETH_EXCHANGE": "ppermute"},
        keyrange_threshold=3, exchange="ppermute")
    _assert_counters_equal(ref, port)
    runner = port._machine._runner
    assert runner._xchg_hw > 0 and runner._sync_last == 0
    assert port.machine_counters()["exchange_ppermute"] > 0


def test_keyrange_dense_falls_back_to_psum(monkeypatch):
    """tests/test_shard_replay.py:536: density 0 reads any nonempty sync
    set as dense, so the mode settles on psum; roots exact."""
    monkeypatch.delenv("CORETH_EXCHANGE", raising=False)
    gens, rblocks = _hot()
    ref, port = _replay_both(
        monkeypatch, gens, rblocks, 2,
        env={"CORETH_KEYRANGE_THRESHOLD": "3",
             "CORETH_EXCHANGE_DENSITY": "0.0"},
        keyrange_threshold=3, exchange_density=0.0)
    _assert_counters_equal(ref, port)
    runner = port._machine._runner
    assert runner._sync_last or runner._xchg_locked
    assert runner._xchg_mode == "psum"
    assert port.machine_counters()["exchange_psum"] > 0


def test_keyrange_with_specialisation(monkeypatch):
    """tests/test_shard_replay.py:554 with K7 on (both packages' default):
    key-range lanes run their traced programs inside K9, and the
    placement's load imbalance reaches ``ReplayStats``."""
    gens, rblocks = _hot()
    ref, port = _replay_both(
        monkeypatch, gens, rblocks, 2,
        env={"CORETH_KEYRANGE_THRESHOLD": "3"}, specialize=True,
        keyrange_threshold=3)
    _assert_counters_equal(ref, port)
    mc = port.machine_counters()
    assert mc["kr_lanes"] > 0 and mc["lanes_specialized"] > 0
    assert port.stats.load_imbalance > 0
