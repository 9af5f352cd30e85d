"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (a CUDA kernel has
no CPU mode).  On a machine with a card (``--noconftest``:
``tests/conftest.py`` configures JAX, which that machine does not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest
import torch

import chip_smoke
import torch_machine_cases as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [0, 1])
def test_transfer_window_kernel_matches_plain(cuda, seed):
    from coreth_tpu_torch.replay import engine as E
    rng = np.random.default_rng(seed)
    win = chip_smoke.random_window(rng, 8, 32, 24, cap=512, scap=64,
                                   n_acct=200, n_slot=10, L=256, SL=16,
                                   t_pad=64, s_pad=16)
    args = [torch.from_numpy(a).to(cuda) for a in win]
    launches = E.LAUNCHES
    got = E._transfer_window(*args)
    want = E._transfer_window_plain(*args)
    assert E.LAUNCHES == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_recover_kernel_matches_plain(cuda):
    from coreth_tpu_torch.ops import secp as S
    _packed, kin = chip_smoke.signature_batch(64, 5)
    args = [torch.from_numpy(a).to(cuda) for a in kin]
    launches = S.LAUNCHES
    rows = S.recover_kernel(*args)
    assert S.LAUNCHES == launches + 1
    assert torch.equal(rows, S.recover_kernel_plain(*args))


def test_replay_on_the_card(cuda):
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_chain(4, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, window=2, device=cuda)
    eng.DEVICE_RECOVER_MIN = 1
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    assert eng.stats.sigs_device == 4 * 32


@pytest.mark.parametrize("mode", ["psum", "ppermute"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_window_kernel_matches_plain(cuda, n, mode):
    """K8 (one cluster of n CTAs) against its plain version on a window
    with an insolvent and a nonce-mismatch block: tables, fetches and
    every shard's working set equal, and the n working sets equal."""
    from coreth_tpu_torch.replay import shard as SH
    rng = np.random.default_rng(10 + n)
    win = chip_smoke.random_window(rng, 8, 64, 48, cap=1024, scap=64,
                                   n_acct=300, n_slot=10, L=512, SL=16,
                                   t_pad=128, s_pad=16)
    perm = SH.interleave_txs(64, n)
    win = win[:5] + (np.ascontiguousarray(win[5][:, perm]),) + win[6:]
    args = [torch.from_numpy(a).to(cuda) for a in win]
    launches = SH.LAUNCHES
    got = SH.sharded_transfer_window(*args, n=n, mode=mode,
                                     return_replicas=True)
    assert SH.LAUNCHES == launches + 1
    want = SH._sharded_window_plain(*args, n, mode, return_replicas=True)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    for g, w in zip(got[4], want[4]):
        assert torch.equal(g, w)
        assert torch.equal(g, g[:1].expand_as(g))
    oks = got[3][:, -1, 0].tolist()
    assert oks[1] == 0 and oks[2] == 0 and sum(oks) == 6


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_recover_matches_k2(cuda, n):
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.parallel import make_mesh
    _packed, kin = chip_smoke.signature_batch(256, 6)
    args = [torch.from_numpy(a).to(cuda) for a in kin]
    launches = S.SHARD_LAUNCHES
    rows = S.sharded_recover(make_mesh(n))(*args)
    assert S.SHARD_LAUNCHES == launches + 1
    assert torch.equal(rows, S.recover_kernel(*args))


def test_mesh_replay_on_the_card(cuda):
    """A transfer chain on a 4-shard engine: every window on K8, every
    sender on K8r, K1 never."""
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_chain(6, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, window=4, device=cuda,
                       mesh=make_mesh(4), shard_recover=True)
    k1, k8, k8r = E.LAUNCHES, SH.LAUNCHES, S.SHARD_LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    assert E.LAUNCHES == k1 and SH.LAUNCHES == k8 + 2
    assert S.SHARD_LAUNCHES > k8r
    assert eng.stats.sigs_device == 6 * 32


def test_keccak_kernel_matches_plain(cuda):
    from coreth_tpu_torch.crypto import keccak256_py
    from coreth_tpu_torch.ops import keccak as K
    rng = np.random.default_rng(3)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 272, 120)]
    msgs += [rng.bytes(n) for n in (0, 135, 136, 271, 272, 400)]
    blocks, nblocks = K.pack_blocks(msgs)
    b, n = torch.from_numpy(blocks).to(cuda), torch.from_numpy(nblocks).to(
        cuda)
    launches = K.LAUNCHES
    got = K.keccak256_blocks(b, n)
    assert K.LAUNCHES == launches + 1
    assert torch.equal(got, K.keccak256_blocks_plain(b, n))
    assert K.digests(got) == [keccak256_py(m) for m in msgs]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mod", "sdiv",
                                "smod", "addmod", "mulmod", "exp", "shl",
                                "shr", "sar", "byte", "signextend", "lt",
                                "gt", "slt", "sgt", "eq", "not",
                                "bit_length", "mul_wide_lo",
                                "mul_wide_hi"])
def test_u256x_kernel_matches_plain(cuda, op):
    from coreth_tpu_torch.ops import u256, u256x
    rows = chip_smoke.alu_operands(np.random.default_rng(9), 96)
    a, b, c = (torch.from_numpy(x).to(cuda) for x in rows)
    if op == "exp":
        b = b & 0xFF            # keep the plain bit loop short
    launches = u256x.LAUNCHES
    got = u256x.eval_ops(op, a, b, c)
    assert u256x.LAUNCHES == launches + 1
    assert torch.equal(got, u256x.eval_plain(op, a, b, c))
    assert int(got.max()) <= u256.LIMB_MASK


_SHAPE = dict(batch=8, code_cap=512, data_cap=128, scache_cap=16)


@pytest.mark.parametrize("fork,name", [("durango", n) for n in sorted(
    C.CASES)] + [("cancun", n) for n in sorted(C.CANCUN_CASES)])
def test_step_machine_kernel_matches_plain(cuda, fork, name):
    """Packed rows and step counts of every lane equal the plain
    version's, round by round through the miss-and-rerun runner."""
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.evm.device import machine as M
    lanes = C.CASES.get(name) or C.CANCUN_CASES[name]
    p = M.MachineParams(fork=fork, **_SHAPE)
    runner = A.MachineRunner(fork, C.env(A.BlockEnv),
                             C.resolver_for(lanes), device=cuda)
    runner._params = lambda txs: p
    txs = C.specs(lanes, A.TxSpec)
    launches = M.LAUNCHES
    results = runner.run(txs)
    assert M.LAUNCHES == launches + runner.launches
    inputs = runner.pack(txs, p)
    packed, steps = M.run_machine(p, inputs)
    plain = M.run_plain(p, inputs)
    assert torch.equal(packed, plain["packed"])
    assert torch.equal(steps, plain["steps"])
    assert len(results) == len(lanes)


def test_step_machine_step_bound_on_the_card(cuda):
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.evm.device import machine as M
    p = M.MachineParams(fork="durango", max_steps=300, **_SHAPE)
    lanes = [C.lane("5b" + C.push(0) + "56")] * 3
    runner = A.MachineRunner("durango", C.env(A.BlockEnv),
                             C.resolver_for(lanes), device=cuda)
    inputs = runner.pack(C.specs(lanes, A.TxSpec), p)
    packed, steps = M.run_machine(p, inputs)
    plain = M.run_plain(p, inputs)
    assert torch.equal(packed, plain["packed"])
    assert steps[:3].tolist() == [300] * 3
    assert packed[:3, 3].tolist() == [M.R_STEPS] * 3


@pytest.mark.parametrize("device_occ", [False, True])
def test_erc20_replay_on_the_card(cuda, device_occ):
    """ERC-20 transfer() blocks replay through the machine path, per
    block on the step-machine kernel or in fused windows on K6, to the
    header roots."""
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_erc20_chain(3, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, device=cuda,
                       device_occ=device_occ)
    launches, occ_launches = M.LAUNCHES, M.OCC_LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    mc = eng.machine_counters()
    assert mc["blocks"] == 3 and mc["rounds"] > 0
    assert M.LAUNCHES - launches == mc["launches"]
    assert M.OCC_LAUNCHES - occ_launches == mc["window_launches"]
    if device_occ:
        assert mc["window_launches"] >= mc["windows"] >= 1
        assert mc["launches"] == 0 and mc["dirty_blocks"] == 0
    else:
        assert mc["launches"] > 0 and mc["window_launches"] == 0


def _occ_both(pk, occ=None):
    """K6 (with K7 for the window's program set) and its plain version
    on one packed window (card tensors)."""
    from coreth_tpu_torch.evm.device import machine as M
    args = (pk["p"], occ or pk["occ"], pk["table"], pk["key_tab"],
            pk["inputs"], pk["spec"])
    launches = M.OCC_LAUNCHES, M.SPEC_LAUNCHES
    got = M.run_occ_window(*args)
    assert (M.OCC_LAUNCHES, M.SPEC_LAUNCHES) == (
        launches[0] + 1, launches[1] + bool(pk["spec"]))
    want = M.occ_run_plain(*args)
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.parametrize("name", sorted(C.WINDOW_CASES))
def test_occ_window_kernel_matches_plain(cuda, name):
    """Table, packed rows (trailing columns included) and lane-steps of
    every window case equal the plain version's."""
    _occ_both(C.pack_window(name, device=cuda))


def test_occ_window_kernel_unmapped_entries_and_round_cap(cuda):
    from coreth_tpu_torch.evm.device import machine as M
    pk = C.pack_window("chained_blocks", device=cuda)
    G = pk["occ"].table_cap
    sgid = pk["inputs"]["sgid"]
    sgid[:, :, 8] = G + 1
    sgid[:, :, 10] = 10**6
    _occ_both(pk)
    for name, rounds, pending in (("swap", 3, 3), ("host_and_miss", 1, 1)):
        pk = C.pack_window(name, device=cuda)
        got = _occ_both(pk, M.OccParams(blocks=pk["occ"].blocks,
                                        table_cap=pk["occ"].table_cap,
                                        rounds=rounds))
        assert got["packed"][0, :, -2].sum() == pending  # at the cap


def test_occ_window_kernel_wide_cache_and_many_lanes(cuda):
    """A 64-entry storage cache (entries past the sweep warp's 32
    threads) and 512 lanes (more lanes than the CTA's 256 threads)."""
    from coreth_tpu_torch.evm.device import adapter as A
    blocks = C.wide_cache_window()
    runner = A.MachineWindowRunner(
        "durango", C.resolver_for([ln for b in blocks for ln in b]),
        device=cuda, specialize=False)
    pk = runner.pack(C.window_items(blocks, A.TxSpec, A.BlockEnv))
    assert pk["p"].scache_cap == 64
    _occ_both(pk)
    pk = chip_smoke.escape_window(cuda, np.random.default_rng(3), lanes=300)
    assert pk["p"].batch == 512
    _occ_both(pk)


def test_occ_window_kernel_on_chip_smoke_windows(cuda):
    """The swap and escape windows chip_smoke.py measures, at their full
    shapes (8 swaps a block; 16 lanes with a HOST lane, a missed key and
    trailing inactive blocks)."""
    rng = np.random.default_rng(7)
    for pk in (chip_smoke.swap_window(cuda),
               chip_smoke.escape_window(cuda, rng)):
        _occ_both(pk)


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("name", sorted(C.WINDOW_CASES))
def test_occ_spec_kernel_matches_plain(cuda, name):
    """K6+K7 (the variant for the shared program set) equals the plain
    version with the plain programs on every window case."""
    pk = C.pack_window(name, device=cuda, spec_codes=C.SPEC_CODES)
    assert len(pk["spec"]) == len(C.SPEC_CODES)
    _occ_both(pk)


def test_occ_spec_kernel_on_k7_windows(cuda):
    """The mixed window of the CPU tests with its kdig-overflow and
    full-cache lanes, and chip_smoke.py's K7 windows at small widths:
    traced beside interpreted lanes, REVERT and flush-OOG leaves, device
    keccaks, HOST escapes."""
    rng = np.random.default_rng(11)
    for pk in (C.pack_window(C.k7_window(), device=cuda,
                             spec_codes=C.k7_spec_codes()),
               chip_smoke.swap_window(cuda, specialize=True),
               chip_smoke.mixed_window(cuda, rng, lanes=8),
               chip_smoke.keccak_fan_window(cuda, rng, lanes=6),
               chip_smoke.escape_lanes_window(cuda, rng)):
        assert pk["spec"]
        _occ_both(pk)


def test_spec_replay_on_the_card(cuda):
    """ERC-20 transfer() blocks through the window path with K7: every
    lane traced, every window launch on the specialised variant."""
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_erc20_chain(3, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, device=cuda)
    occ, spec = M.OCC_LAUNCHES, M.SPEC_LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    mc = eng.machine_counters()
    assert mc["lanes_specialized"] == 3 * 32
    assert mc["specialize_escapes"] == 0 and mc["programs_traced"] == 1
    assert M.SPEC_LAUNCHES - spec == M.OCC_LAUNCHES - occ \
        == mc["window_launches"] >= 1


# K9's plain version per (n, sync, spec) on the CPU: it does not depend on
# the mode (integer sums and maxes), and its many small steps run faster
# there than on the card
_SHARDED_PLAIN = {}


def _sharded_case(cuda, n, sync, spec):
    from coreth_tpu_torch.evm.device import machine as M
    key = (n, sync, spec)
    if key not in _SHARDED_PLAIN:
        w = C.sharded_window(n, sync, seed=n,
                             spec_codes=C.SPEC_CODES if spec else None)
        want = M.occ_sharded_plain(w["p"], w["occ"], w["table"],
                                   w["key_tab"], w["inputs"], w["spec"], n,
                                   w["sync_rows"])
        _SHARDED_PLAIN[key] = (w, want)
    w, want = _SHARDED_PLAIN[key]
    dev = dict(w, table=w["table"].to(cuda), key_tab=w["key_tab"].to(cuda),
               inputs={k: v.to(cuda) for k, v in w["inputs"].items()},
               sync_rows=None if w["sync_rows"] is None
               else w["sync_rows"].to(cuda))
    return dev, want


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("mode", ["psum", "ppermute"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_occ_sharded_kernel_matches_plain(cuda, n, mode, sync, spec):
    """K9 (one cluster of n CTAs) against its plain version on n window
    cases side by side, with and without the key-range sync set, on the
    generic library and on the shared program set's variant."""
    from coreth_tpu_torch.evm.device import machine as M
    w, want = _sharded_case(cuda, n, sync, spec)
    assert bool(w["spec"]) == spec
    launches = M.OCC_SHARDED_LAUNCHES
    got = M.run_occ_sharded(w["p"], w["occ"], w["table"], w["key_tab"],
                            w["inputs"], w["spec"], n, w["sync_rows"], mode)
    assert M.OCC_SHARDED_LAUNCHES == launches + 1
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("mode", ["psum", "ppermute"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_flags_kernel_matches_plain(cuda, n, mode):
    """K9x against its plain version on a K9 window's rows, and on random
    flag columns (escapes and pending lanes, inactive lanes)."""
    from coreth_tpu_torch.evm.device import machine as M
    w, want = _sharded_case(cuda, n, True, False)
    rng = np.random.default_rng(n)
    packed = torch.from_numpy(rng.integers(
        0, 2, (6, n * 16, 9)).astype(np.int32)).to(cuda)
    active = torch.from_numpy(rng.integers(
        0, 2, (6, n * 16)).astype(np.int32)).to(cuda)
    for pk, act in ((want["packed"].to(cuda), w["inputs"]["active"]),
                    (packed, active)):
        launches = M.SHARD_FLAGS_LAUNCHES
        got = M.shard_flags(pk, act, n, mode)
        assert M.SHARD_FLAGS_LAUNCHES == launches + 1
        assert torch.equal(got.cpu(), M.shard_flags_plain(
            pk.cpu(), act.cpu(), n, mode))


def test_hot_contract_replay_on_a_4_shard_engine(cuda):
    """The single-hot-contract chain on a 4-shard engine: the token goes
    hot, every machine window runs on K9 with K9x behind it, the
    single-chip K6/K7 never; the root equals the header."""
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    from coreth_tpu_torch.workloads.hot_contract import build_hot_chain
    genesis, blocks = build_hot_chain(CFG, 16, 32, n_keys=64)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(CFG, store, parent_header=gb.header, batch_pad=32,
                       capacity=1024, window=16, device=cuda,
                       mesh=make_mesh(4))
    k6, k9, k9x = M.OCC_LAUNCHES, M.OCC_SHARDED_LAUNCHES, \
        M.SHARD_FLAGS_LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    mc = eng.machine_counters()
    assert mc["blocks"] == 16 and mc["dirty_blocks"] == 0
    assert mc["kr_lanes"] > 0 and eng.stats.load_imbalance > 0
    assert M.OCC_SHARDED_LAUNCHES - k9 == mc["window_launches"] \
        >= mc["windows"] >= 1
    assert M.SHARD_FLAGS_LAUNCHES - k9x == mc["window_launches"]
    assert M.OCC_LAUNCHES == k6
