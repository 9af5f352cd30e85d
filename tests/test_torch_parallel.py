"""The port's per-block sharded steps (K8s) and its mesh engine on mixed
transfer and token chains, against the JAX reference on the CPU.

The reference's ``sharded_transfer_step`` and ``sharded_slot_step`` run
as ``shard_map`` programs on ``tests/conftest.py``'s virtual 8-device CPU
mesh; the port's (``coreth_tpu_torch.parallel``) run their plain
versions on CPU tensors.  Both get the same inputs, made from a seed with
numpy, at n = 2, 4 and 8, and their integer results must be equal
exactly.  ``csrc/sharded_step.cu`` has no CPU mode, so a host build of
it (g++, each CTA of the launch a host thread of one thread, as
tests/test_torch_shard.py builds K1) is held against the plain versions
too.  The mixed
transfer+token chain of tests/test_parallel.py:111 replays on both
packages' mesh engines at their defaults (the token fast path on).
Mirrors tests/test_parallel.py.
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

from coreth_tpu.parallel import make_mesh as r_make_mesh
from coreth_tpu.parallel import sharded_slot_step as r_slot_step
from coreth_tpu.parallel import sharded_transfer_step as r_transfer_step
from coreth_tpu.workloads import erc20 as rerc20

from coreth_tpu_torch import kernels
from coreth_tpu_torch import parallel as tpar
from coreth_tpu_torch.ops import u256

import chip_smoke
from test_torch_shard import _SHIM
from test_torch_shard_occ import _reference_cache  # noqa: F401 — autouse
from test_torch_token import (
    ADDRS, KEYS, TOKEN, assert_slots_equal, replay_both, token_chains,
)

# frees JAX's compiled programs in any worker past half of the kernel's
# memory-mapping limit (the reference's sharded programs hold many)
pytest_plugins = ["xla_map_guard"]

WIDTHS = [2, 4, 8]


def _rmesh(n):
    return r_make_mesh(jax.devices("cpu")[:n])


def transfer_inputs(seed, A, B, case="ok"):
    """tests/test_parallel.py's batch: senders in the low half, fresh
    recipients in the high half, nonces in sequence, the last account
    the coinbase.  ``insolvent``: one sender's buyGas requirement past
    its balance; ``bad_nonce``: one tx's nonce off; ``masked``: every
    third tx masked out."""
    rng = np.random.default_rng(seed)
    bal = [int(x) * 10**18 for x in rng.integers(1, 1000, A)]
    nonces = rng.integers(0, 5, A).astype(np.int32)
    sender = rng.integers(0, A // 2, B).astype(np.int32)
    recip = rng.integers(A // 2, A, B).astype(np.int32)
    value = [int(x) for x in rng.integers(1, 10**9, B)]
    fee = [21000 * 25 * 10**9] * B
    required = [v + f for v, f in zip(value, fee)]
    offsets = np.zeros(B, dtype=np.int32)
    tx_nonce = np.zeros(B, dtype=np.int32)
    seen = {}
    for i, s in enumerate(sender):
        offsets[i] = seen.get(s, 0)
        tx_nonce[i] = nonces[s] + offsets[i]
        seen[s] = offsets[i] + 1
    mask = np.ones(B, dtype=bool)
    if case == "insolvent":
        required[B - 1] = bal[sender[B - 1]] + 1
    elif case == "bad_nonce":
        tx_nonce[B // 2] += 7
    elif case == "masked":
        mask[::3] = False
    return (u256.pack_np(bal), nonces, sender, recip, u256.pack_np(value),
            u256.pack_np(fee), u256.pack_np(required), tx_nonce, offsets,
            mask, A - 1)


def slot_inputs(seed, S, B, case="ok"):
    """tests/test_parallel.py's slot batch (slot 0 the reserved dummy);
    ``insolvent``: one slot debited past its value."""
    rng = np.random.default_rng(seed)
    vals = [int(x) for x in rng.integers(10**6, 10**9, S)]
    from_slot = rng.integers(1, S, B).astype(np.int32)
    to_slot = rng.integers(1, S, B).astype(np.int32)
    amounts = [int(x) for x in rng.integers(1, 1000, B)]
    mask = np.ones(B, dtype=bool)
    if case == "insolvent":
        amounts[0] = vals[from_slot[0]] + 1
    elif case == "masked":
        mask[1::4] = False
    return (u256.pack_np(vals), from_slot, to_slot, u256.pack_np(amounts),
            mask)


def transfer_case(seed, A, B, case):
    """``transfer_inputs`` of ``case``, or one of
    ``chip_smoke.K8S_SHAPES`` made from its "ok" inputs."""
    if case not in chip_smoke.K8S_SHAPES:
        return transfer_inputs(seed, A, B, case)
    args = transfer_inputs(seed, A, B)
    t, cb, _s = chip_smoke.k8s_shaped(args[:10], args[10],
                                      slot_inputs(seed, A, B), case)
    return tuple(t) + (cb,)


def slot_case(seed, S, B, case):
    """``slot_inputs`` of ``case``, or one of ``chip_smoke.K8S_SHAPES``
    made from its "ok" inputs."""
    if case not in chip_smoke.K8S_SHAPES:
        return slot_inputs(seed, S, B, case)
    args = transfer_inputs(seed, S, B)
    _t, _cb, s = chip_smoke.k8s_shaped(args[:10], args[10],
                                       slot_inputs(seed, S, B), case)
    return tuple(s)


def _ref(fn, args):
    return [np.asarray(x) for x in fn(*(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))]


def _port(fn, args):
    return [x.numpy() for x in fn(*(
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args))]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.astype(np.int64),
                                                     w.astype(np.int64))


# ----------------------------------------------- K8s's plain versions
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("case", ["ok", "insolvent", "masked",
                                  "same_sender", "all_masked", "negative"])
def test_sharded_transfer_step_matches_reference(n, case):
    """tests/test_parallel.py:18 at its shapes (A = 64, B = 32), with an
    insolvent sender and masked rows beside it, and the shapes of
    ``chip_smoke.k8s_shaped``: every tx from one sender to the coinbase,
    every tx masked, an unmasked sender -2 (the reference's gather wraps
    it to row A - 2, whose nonce the tx carries)."""
    A, B = 64, 32
    args = transfer_case(42, A, B, case)
    want = _ref(r_transfer_step(_rmesh(n), A), args)
    got = _port(tpar.sharded_transfer_step(tpar.make_mesh(n), A), args)
    _equal(got, want)
    assert bool(got[2]) == (case != "insolvent")


@pytest.mark.parametrize("n", WIDTHS)
def test_sharded_step_detects_bad_nonce(n):
    """tests/test_parallel.py:61 (A = 16, B = 8, tx 3's nonce 7)."""
    A, B = 16, 8
    bal = u256.pack_np([10**20] * A)
    nonces = np.zeros(A, dtype=np.int32)
    sender = np.arange(B, dtype=np.int32)
    recip = (np.arange(B, dtype=np.int32) + 8) % A
    value = u256.pack_np([1] * B)
    fee = u256.pack_np([21000] * B)
    required = u256.pack_np([21001] * B)
    tx_nonce = np.zeros(B, dtype=np.int32)
    tx_nonce[3] = 7
    args = (bal, nonces, sender, recip, value, fee, required, tx_nonce,
            np.zeros(B, dtype=np.int32), np.ones(B, dtype=bool), A - 1)
    want = _ref(r_transfer_step(_rmesh(n), A), args)
    got = _port(tpar.sharded_transfer_step(tpar.make_mesh(n), A), args)
    _equal(got, want)
    assert not bool(got[2])


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("case", ["ok", "insolvent", "masked",
                                  "same_sender", "all_masked"])
def test_sharded_slot_step_matches_reference(n, case):
    """tests/test_parallel.py:82 at its shapes (S = 64, B = 32), and
    every tx from one slot to one slot, or every tx masked."""
    S, B = 64, 32
    args = slot_case(11, S, B, case)
    want = _ref(r_slot_step(_rmesh(n), S), args)
    got = _port(tpar.sharded_slot_step(tpar.make_mesh(n), S), args)
    _equal(got, want)
    assert bool(got[1]) == (case != "insolvent")


def test_sharded_steps_refuse_bad_shapes():
    mesh = tpar.make_mesh(4)
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_transfer_step(mesh, 30)
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_slot_step(mesh, 30)
    step = tpar.sharded_transfer_step(mesh, 64)
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in transfer_inputs(1, 64, 30)]
    with pytest.raises(ValueError, match="divide"):
        step(*args)
    big = tpar.mesh.MAX_STEP_TXS * 2
    sstep = tpar.sharded_slot_step(mesh, 64)
    sargs = [torch.from_numpy(a) for a in slot_inputs(1, 64, big)]
    with pytest.raises(ValueError, match="headroom"):
        sstep(*sargs)


# ------------------------------------------- a host build of K8s
@pytest.fixture(scope="module")
def host_k8s(tmp_path_factory):
    """``csrc/sharded_step.cu`` built for the host: one thread per CTA
    (every stride loop runs serially, a warp's shuffles none), each CTA
    of the launch a host thread with its own shared memory."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("host_k8s")
    with open(os.path.join(kernels.CSRC, "transfer_block.cuh")) as f:
        (tmp / "transfer_block.cuh").write_text(f.read())
    with open(os.path.join(kernels.CSRC, kernels.SOURCES["sharded_step"])) \
            as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", "").replace(
        "extern __shared__ __align__(16) unsigned ss_smem[];",
        "unsigned* ss_smem = (unsigned*)shim_smem;")
    (tmp / "sharded_step.cpp").write_text(_SHIM + src)
    out = tmp / "libsharded_step.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-I",
                        str(tmp), "-o", str(out),
                        str(tmp / "sharded_step.cpp"), "-lpthread"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(str(out))
    kernels._declare("sharded_step", lib)
    return lib


def _run_host_transfer(lib, args):
    A, B = args[0].shape[0], args[2].shape[0]
    new_bal, new_non = torch.zeros((A, 16), dtype=torch.int32), \
        torch.zeros((A,), dtype=torch.int32)
    ok = torch.zeros((), dtype=torch.bool)
    rc = lib.sharded_transfer_step_launch(
        *(t.data_ptr() for t in args[:10]), args[10], A, B,
        new_bal.data_ptr(), new_non.data_ptr(), ok.data_ptr(), None)
    assert rc == 0
    return new_bal, new_non, ok


def _i32(args):
    return [torch.from_numpy(np.asarray(a)).to(torch.int32).contiguous()
            if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["ok", "insolvent", "bad_nonce", "masked",
                                  "same_sender", "all_masked", "negative"])
def test_host_build_of_k8s_transfer_matches_plain(host_k8s, n, case):
    """K8s's transfer kernel (a CTA a range of 16 rows: four CTAs) equal
    to the plain version at width n: balances, nonces and ok, on
    ``transfer_inputs``' cases and ``chip_smoke.k8s_shaped``'s."""
    A, B = 64, 32
    args = _i32(transfer_case(7 + n, A, B, case))
    want = tpar.sharded_transfer_step_plain(*args, n)
    got = _run_host_transfer(host_k8s, args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2]) == (case not in ("insolvent", "bad_nonce"))


def test_host_build_of_k8s_transfer_in_chunks(host_k8s):
    """B = 2048 txs (the kernel lists 1024 at a time) over A = 256 rows
    (16 CTAs), one sender in eight insolvent: equal to the plain
    version."""
    A, B = 256, 2048
    args = _i32(transfer_inputs(5, A, B, "insolvent"))
    want = tpar.sharded_transfer_step_plain(*args, 4)
    got = _run_host_transfer(host_k8s, args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[2])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["ok", "insolvent", "masked",
                                  "same_sender", "all_masked"])
def test_host_build_of_k8s_slot_matches_plain(host_k8s, n, case):
    S, B = 64, 32
    args = _i32(slot_case(3 + n, S, B, case))
    want = tpar.sharded_slot_step_plain(*args, n)
    new_vals, ok = torch.zeros((S, 16), dtype=torch.int32), \
        torch.zeros((), dtype=torch.bool)
    rc = host_k8s.sharded_slot_step_launch(
        *(t.data_ptr() for t in args), S, B, new_vals.data_ptr(),
        ok.data_ptr(), None)
    assert rc == 0
    assert torch.equal(new_vals, want[0])
    assert torch.equal(ok, want[1])
    assert bool(ok) == (case != "insolvent")


# ------------------------------------------- the mesh engine, end to end
def _mixed_txs(i, nonces):
    """tests/test_parallel.py:111's blocks: 16 txs, value transfers and
    token ``transfer()`` calls taking turns."""
    out = []
    for j in range(16):
        k = (i * 16 + j) % len(KEYS)
        if j % 2 == 0:
            out.append((k, bytes([0x60 + j]) * 20, 500 + j, 21_000, b""))
        else:
            out.append((k, TOKEN, 0, 100_000, rerc20.transfer_calldata(
                ADDRS[(k + 3) % len(KEYS)], 7 + j)))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_engine_replays_mixed_chain_like_reference(n):
    """Both packages' mesh engines (window 2) replay the mixed chain at
    their defaults: fold roots equal to each other and the headers, every
    block on the window path (the token's slots on its contract bucket's
    arena, carried by K8's slot half), and the same slot keys, mirror
    values and device slot table rows."""
    rgen, pgen, rblocks = token_chains(4, _mixed_txs)
    ref, port = replay_both(rgen, pgen, rblocks, mesh=tpar.make_mesh(n),
                            rmesh=_rmesh(n), window=2)
    assert port.stats.blocks_device == ref.stats.blocks_device == 4
    assert port._machine is None and port.stats.n_shards == n
    assert port.stats.exchange_psum + port.stats.exchange_ppermute == 2
    assert_slots_equal(ref, port)
    assert port.state.slot_row_of == ref.state.slot_row_of
    assert np.array_equal(port.state.slot_vals.numpy(),
                          np.asarray(ref.state.slot_vals))
