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


@pytest.mark.parametrize("seed,case", [
    (0, "random"), (1, "random"), (2, "hot"), (3, "pad_rows"), (4, "wrap"),
    (5, "untouched"), (6, "negative")])
def test_transfer_window_kernel_matches_plain(cuda, seed, case):
    """K1 (phases blocks, rows, fetch) against its plain version on random
    windows and on the shapes of ``chip_smoke.shaped_window``: one
    recipient and slot a block, out-of-range pad rows and coinbase,
    wrapping totals with blocks on top of a failed one, fetched rows a
    block does not touch, negative sender and fetch indices (wrapped)."""
    from coreth_tpu_torch.replay import engine as E
    rng = np.random.default_rng(seed)
    kw = dict(cap=512, scap=64, n_acct=200, n_slot=10, L=256, SL=16,
              t_pad=64, s_pad=16)
    win = chip_smoke.random_window(rng, 8, 32, 24, **kw) \
        if case == "random" else \
        chip_smoke.shaped_window(rng, case, 8, 32, 24, **kw)
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


def test_recover_kernel_matches_plain_on_corner_rows(cuda):
    """The ladder's corner rows (chip_smoke.corner_batch: the 2G entry,
    the infinite G+R entry, a doubling collision, zero and top-bit
    scalars) with signature rows behind them: rows equal to the plain
    version's."""
    from coreth_tpu_torch.ops import secp as S
    corner = chip_smoke.corner_batch(17)
    _packed, sigs = chip_smoke.signature_batch(57, 8)
    args = [torch.from_numpy(np.concatenate(p)).to(cuda)
            for p in zip(corner, sigs)]
    want = S.recover_kernel_plain(*args)
    launches = S.LAUNCHES
    assert torch.equal(S.recover_kernel(*args), want)
    assert S.LAUNCHES == launches + 1
    assert want[:7, 100].tolist() == [0, 0, 1, 0, 0, 0, 0]


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


def _k8_window(n, case):
    from coreth_tpu_torch.replay import shard as SH
    kw = dict(cap=1024, scap=64, n_acct=300, n_slot=10, L=512, SL=16,
              t_pad=128, s_pad=16)
    if case == "random":
        win = chip_smoke.random_window(np.random.default_rng(10 + n), 8, 64,
                                       48, **kw)
    else:
        win = chip_smoke.shaped_window(np.random.default_rng(30 + n), case,
                                       8, 64, 48, **kw)
    perm = SH.interleave_txs(64, n)
    return win[:5] + (np.ascontiguousarray(win[5][:, perm]),) + win[6:]


def _k8_params():
    out = [pytest.param(n, m, "random", id=f"{n}-{m}")
           for m in ("psum", "ppermute") for n in (2, 4, 8)]
    return out + [pytest.param(n, m, c, id=f"{c}-{m}-{n}")
                  for c in ("hot", "pad_rows", "negative")
                  for m in ("psum", "ppermute") for n in (2, 4, 8)]


@pytest.mark.parametrize("n,mode,case", _k8_params())
def test_sharded_window_kernel_matches_plain(cuda, n, mode, case):
    """K8 (one cluster of n CTAs) against its plain version on a window
    with an insolvent and a nonce-mismatch block ("random"), with every
    lane of a block paying one recipient and one token slot ("hot"), with
    out-of-range pad rows and coinbase ("pad_rows"), and with a sender and
    fetch indices below zero ("negative"): tables, fetches
    and every shard's working set equal, the n working sets equal; the
    same with the slabs in device memory (the layout of a pad too wide
    for shared memory)."""
    from coreth_tpu_torch.replay import shard as SH
    args = [torch.from_numpy(a).to(cuda) for a in _k8_window(n, case)]
    launches = SH.LAUNCHES
    got = SH.sharded_transfer_window(*args, n=n, mode=mode,
                                     return_replicas=True)
    assert SH.LAUNCHES == launches + 1
    assert SH.window_design(64)["layout"] == "dsmem"
    want = SH._sharded_window_plain(*args, n, mode, return_replicas=True)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    for g, w in zip(got[4], want[4]):
        assert torch.equal(g, w)
        assert torch.equal(g, g[:1].expand_as(g))
    if case == "random":
        oks = got[3][:, -1, 0].tolist()
        assert oks[1] == 0 and oks[2] == 0 and sum(oks) == 6
    glob = SH._launch(args, n, mode, "global")
    for g, w in zip(glob[:4] + glob[4], want[:4] + want[4]):
        assert torch.equal(g, w)


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


@pytest.mark.parametrize("op", ["div", "mod", "sdiv", "smod", "addmod",
                                "mulmod"])
def test_u256x_kernel_division_rare_operands(cuda, op):
    """The division family on ``chip_smoke.division_operands`` (built to
    reach the word-wise division's rare paths: estimate corrections,
    add-back, normalisation shift 0, one-word divisors, dividends below
    the divisor, -2^255 / -1, MULMOD by 1, ADDMOD's 257-bit sum) equals
    the plain version: the PTX carry chains on the card."""
    from coreth_tpu_torch.ops import u256, u256x
    a, b, c = (torch.from_numpy(u256.pack_np(x)).to(cuda)
               for x in chip_smoke.division_operands())
    assert torch.equal(u256x.eval_ops(op, a, b, c),
                       u256x.eval_plain(op, a, b, c))


def test_step_machine_sha3_offsets_and_lengths(cuda):
    """K5's in-lane SHA3 (32-bit word absorb from the lane's memory) on
    ``torch_machine_cases.sha3_lanes``: start offsets 0-3, lengths
    around the 136-byte block, messages ending at the memory's last
    byte; packed rows (the stored digests) and step counts equal the
    plain step machine's, every lane STOP."""
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.evm.device import machine as M
    lanes = C.sha3_lanes()
    runner = A.MachineRunner("durango", C.env(A.BlockEnv),
                             C.resolver_for(lanes), device=cuda)
    txs = C.specs(lanes, A.TxSpec)
    p = runner._params(txs)
    assert p.mem_cap == 4096
    inputs = runner.pack(txs, p)
    launches = M.LAUNCHES
    packed, steps = M.run_machine(p, inputs)
    assert M.LAUNCHES == launches + 1
    plain = M.run_plain(p, inputs)
    assert torch.equal(packed, plain["packed"])
    assert torch.equal(steps, plain["steps"])
    assert (packed[:len(txs), 0] == M.STOP).all()


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


@pytest.mark.parametrize("mem_cap,layout", [(4096, 1), (1 << 18, 0)])
@pytest.mark.parametrize("fork,B", [("durango", 1), ("durango", 17),
                                    ("cancun", 300)])
def test_step_machine_kernel_batches_and_layouts(cuda, fork, B, mem_cap,
                                                 layout):
    """K5 on one mixed batch of every case's lanes (``batch_lanes``) at
    B = 1, 17 (more than a CTA's lanes) and 300, with the lanes' arenas
    in shared-memory slots (mem_cap 4096) and in device memory (256 KiB,
    past a CTA's shared memory): packed rows and step counts equal to
    the plain version's."""
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.evm.device import machine as M
    p = M.MachineParams(fork=fork, mem_cap=mem_cap, **dict(_SHAPE, batch=B))
    assert M.machine_group(p, cuda)[3] == layout
    runner = A.MachineRunner(fork, C.env(A.BlockEnv), lambda a, k: 0,
                             device=cuda)
    inputs = runner.pack(C.batch_lanes(fork, B, A.TxSpec), p)
    launches = M.LAUNCHES
    packed, steps = M.run_machine(p, inputs)
    assert M.LAUNCHES == launches + 1
    plain = M.run_plain(p, inputs)
    assert torch.equal(packed, plain["packed"])
    assert torch.equal(steps, plain["steps"])


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
                       device_occ=device_occ, token_fastpath=False)
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


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("name", sorted(C.SWEEP_CASES))
def test_occ_window_kernel_sweep_cases(cuda, name, spec):
    """The sweep's cases of the host build (tests/test_torch_shard_occ.py
    ``test_host_build_sweep_matches_plain``) on the card: 32 lanes a
    block, a group of two CTAs, generic and on the shared program set's
    variant."""
    _occ_both(C.pack_window(name, device=cuda, batch=32,
                            spec_codes=C.SPEC_CODES if spec else None))


def test_occ_window_kernel_wide_index(cuda):
    """The host build's wide-index window (tests/test_torch_shard_occ.py
    ``test_host_build_sweep_wide_index_matches_plain``: 64 lanes x 1024
    cache entries, the sweep's index columns int32) on the card."""
    _occ_both(C.pack_window(C.WIDE_INDEX_BLOCKS, device=cuda,
                            **C.WIDE_INDEX_SHAPE))


@pytest.mark.parametrize("n", [2, 4])
def test_occ_sharded_kernel_sweep_cases(cuda, n):
    """K9 over n shards of 32 lanes each running a sweep case (a cluster
    of n x 2 CTAs), against the plain version."""
    from coreth_tpu_torch.evm.device import machine as M
    w = C.sharded_window(n, False, names=["early_writer_later_reader",
                                          "last_valid_writer_wins"],
                         batch=32)
    want = M.occ_sharded_plain(w["p"], w["occ"], w["table"], w["key_tab"],
                               w["inputs"], w["spec"], n, None)
    got = M.run_occ_sharded(w["p"], w["occ"], w["table"].to(cuda),
                            w["key_tab"].to(cuda),
                            {k: v.to(cuda) for k, v in w["inputs"].items()},
                            w["spec"], n)
    for k in ("table", "packed", "steps"):
        assert torch.equal(got[k].cpu(), want[k]), k


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


def test_occ_spec_kernel_keccak_fan_window(cuda):
    """chip_smoke.py's K7 window (d) at its full 16 lanes: ten
    host-evaluable keccaks (two past the kdig slots, so on the device)
    and a device keccak of an arithmetic result, through K7's
    ``spec_keccak`` (32-bit words from the memory-model words)."""
    pk = chip_smoke.keccak_fan_window(cuda, np.random.default_rng(17))
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
                       batch_pad=32, capacity=256, device=cuda,
                       token_fastpath=False)
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
    for k in ("table", "packed", "steps", "flags"):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("mode", ["psum", "ppermute"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_flags_kernel_matches_plain(cuda, n, mode):
    """K9's flags epilogue (the reference's K9x) against its plain
    version: on a K9 window with the sync set, and on a window whose
    block 0 has shards with escaping lanes (``host_and_miss``) and with
    lanes still pending when its 3 rounds run out (``raw_chain``)."""
    from coreth_tpu_torch.evm.device import machine as M
    w, want = _sharded_case(cuda, n, True, False)
    dirty = C.sharded_window(n, False, names=[
        "host_and_miss", "raw_chain", "disjoint", "chained_blocks"])
    dirty["occ"] = M.OccParams(blocks=dirty["occ"].blocks,
                               table_cap=dirty["occ"].table_cap, rounds=3)
    dwant = M.occ_sharded_plain(dirty["p"], dirty["occ"], dirty["table"],
                                dirty["key_tab"], dirty["inputs"],
                                dirty["spec"], n, None, mode)
    assert dwant["flags"][0].tolist() != [n, 0]
    for case, plain in ((w, want), (dirty, dwant)):
        launches, fills = M.OCC_SHARDED_LAUNCHES, M.FLAGS_FILL_LAUNCHES
        got = M.run_occ_sharded(
            case["p"], case["occ"], case["table"].to(cuda),
            case["key_tab"].to(cuda),
            {k: v.to(cuda) for k, v in case["inputs"].items()},
            case["spec"], n, None if case["sync_rows"] is None
            else case["sync_rows"].to(cuda), mode)
        assert M.OCC_SHARDED_LAUNCHES == launches + 1
        assert M.FLAGS_FILL_LAUNCHES == fills
        assert torch.equal(got["packed"].cpu(), plain["packed"])
        assert torch.equal(got["flags"].cpu(), M.shard_flags_plain(
            plain["packed"], case["inputs"]["active"].cpu(), n, mode))
        assert torch.equal(got["flags"].cpu(), plain["flags"])


def test_hot_contract_replay_on_a_4_shard_engine(cuda):
    """The single-hot-contract chain on a 4-shard engine: the token goes
    hot, every machine window runs on K9 (its flags reduce inside), the
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
                       mesh=make_mesh(4), token_fastpath=False)
    k6, k9 = M.OCC_LAUNCHES, M.OCC_SHARDED_LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    mc = eng.machine_counters()
    assert mc["blocks"] == 16 and mc["dirty_blocks"] == 0
    assert mc["kr_lanes"] > 0 and eng.stats.load_imbalance > 0
    assert M.OCC_SHARDED_LAUNCHES - k9 == mc["window_launches"] \
        >= mc["windows"] >= 1
    assert M.OCC_LAUNCHES == k6


# ------------------------------------------------------------------ K8s
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["ok", "insolvent", "bad_nonce",
                                  "same_sender", "all_masked", "negative"])
def test_sharded_steps_match_plain(cuda, n, case):
    """K8s's two kernels (the same launch at every n) against their plain
    versions: tables and ok equal; an insolvent sender and slot, or a
    nonce off, clear ok; ``chip_smoke.k8s_shaped``'s one sender paying
    the coinbase, every tx masked, and sender -2 (wrapped) keep it."""
    from coreth_tpu_torch import parallel as P
    from coreth_tpu_torch.parallel import mesh as PM
    rng = np.random.default_rng(n)
    A = S = 1024
    B = 64
    t_np, coinbase, s_np = chip_smoke.k8s_inputs(rng, A, S, B)
    t_np, s_np = [a.copy() for a in t_np], [a.copy() for a in s_np]
    if case == "insolvent":
        t_np[6][5] = t_np[0][t_np[2][5]]          # required = the balance
        t_np[6][5, 0] += 1
        s_np[3][0] = s_np[0][s_np[1][0]]          # amount = the value
        s_np[3][0, 0] += 1
    elif case == "bad_nonce":
        t_np[7][3] += 1
    elif case != "ok":
        t_np, coinbase, s_np = chip_smoke.k8s_shaped(t_np, coinbase, s_np,
                                                     case)
    targs = [torch.from_numpy(a).to(cuda) for a in t_np] + [coinbase]
    sargs = [torch.from_numpy(a).to(cuda) for a in s_np]
    mesh = P.make_mesh(n)
    tl, sl = PM.TRANSFER_STEP_LAUNCHES, PM.SLOT_STEP_LAUNCHES
    got_t = P.sharded_transfer_step(mesh, A)(*targs)
    got_s = P.sharded_slot_step(mesh, S)(*sargs)
    assert PM.TRANSFER_STEP_LAUNCHES == tl + 1
    assert PM.SLOT_STEP_LAUNCHES == sl + 1
    want_t = P.sharded_transfer_step_plain(*targs, n)
    want_s = P.sharded_slot_step_plain(*sargs, n)
    for g, w in zip(got_t + got_s, want_t + want_s):
        assert torch.equal(g, w)
    assert bool(got_t[2]) == (case not in ("insolvent", "bad_nonce"))
    assert bool(got_s[1]) == (case != "insolvent")


@pytest.mark.parametrize("n", [1, 4])
def test_token_fastpath_replay_on_the_card(cuda, n):
    """ERC-20 transfer() blocks through the token fast path (the engine
    default) on K1, or on K8 at n = 4: root equal, every block on the
    window path, the machine never run."""
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_erc20_chain(3, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, window=2, device=cuda,
                       mesh=make_mesh(n) if n > 1 else None)
    k1, k8 = E.LAUNCHES, SH.LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    assert eng.stats.blocks_device == 3 and eng._machine is None
    assert eng.storage_epoch == 3
    assert (SH.LAUNCHES - k8 if n > 1 else E.LAUNCHES - k1) == 2


def test_device_rehash_on_the_card(cuda):
    """The batched rehash on K3's entry (tests/test_replay.py:201's 3,000
    keys, then 500 updated): equal to ``trie.hash()``, K3 launched."""
    from coreth_tpu_torch.mpt import SecureTrie
    from coreth_tpu_torch.mpt.rehash import device_rehash
    from coreth_tpu_torch.ops import keccak as K
    t1, t2 = SecureTrie(), SecureTrie()
    for i in range(3000):
        for t in (t1, t2):
            t.update(i.to_bytes(20, "big"),
                     (b"\x01" + i.to_bytes(8, "big")) * 4)
    launches = K.LAUNCHES
    assert device_rehash(t1, min_batch=64, device=cuda) == t2.hash()
    assert K.LAUNCHES > launches
    for i in range(500):
        for t in (t1, t2):
            t.update(i.to_bytes(20, "big"), b"\x99" * 40)
    assert device_rehash(t1, min_batch=64, device=cuda) == t2.hash()


def test_mixed_segment_replays_on_the_card(cuda):
    """tests/test_mixed_segment.py's 8-block segment, built by the port
    (``torch_mixed_cases``): the import and nativeAssetCall blocks on
    the host path through the atomic callbacks, the transfer blocks on
    K1, the root the last header's."""
    import torch_mixed_cases as M
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.types import Block
    _genesis, blocks = M.build_segment()
    eng, store, backend = M.replay_engine(cuda)
    k1 = E.LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root == store.trie.hash()
    assert (eng.stats.blocks_fallback, eng.stats.blocks_device) == (4, 4)
    assert E.LAUNCHES > k1
    assert len(backend._pending) == 2


def test_py_fold_replay_launches_k3(cuda):
    """The engine's ``trie="py"`` fold on the card: every window's tries
    folded in Python and rehashed level by level, the levels of at
    least ``rehash_min_batch`` (16 here) encodings on K3's entry; the
    root the last header's and K3 launched inside the replay."""
    from coreth_tpu_torch.mpt.trie import SecureTrie
    from coreth_tpu_torch.ops import keccak as K
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_chain(4, 64, 64)
    store = StateStore(backend="py")
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=64, capacity=1024, window=2, device=cuda,
                       trie="py", rehash_min_batch=16)
    launches = K.LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root == store.trie.hash()
    assert isinstance(store.trie, SecureTrie)
    assert K.LAUNCHES > launches
    assert eng.supervisor.strikes == 0


def test_transient_dispatch_fault_retried_on_k1(cuda):
    """A transient ``device/dispatch`` fault at K1's window launch:
    retried once, no strike, every block on the device, K1 launched."""
    from coreth_tpu_torch import faults
    from coreth_tpu_torch.faults import FaultPlan, FaultSpec
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay.supervisor import BackendSupervisor
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_chain(4, 32, 32)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=1024, window=2, device=cuda,
                       supervisor=BackendSupervisor(backoff=0.001))
    k1 = E.LAUNCHES
    with faults.armed(FaultPlan({"device/dispatch":
                                 FaultSpec(times=1, transient=True)})):
        root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    assert (eng.supervisor.retries, eng.supervisor.strikes) == (1, 0)
    assert eng.stats.blocks_device == 4 and E.LAUNCHES - k1 == 2


def test_flat_checked_erc20_replay_on_the_card(cuda):
    """The ERC-20 window chain with ``flat_check=True`` on the card: every
    flat hit re-derived from the tries with no divergence, the root the
    header's, K6+K7 launched, and the flat layer sealed one generation a
    fold."""
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_erc20_chain(4, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, device=cuda,
                       token_fastpath=False, flat_check=True)
    spec = M.SPEC_LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root == store.trie.hash()
    assert M.SPEC_LAUNCHES - spec >= 1
    snap = eng.flat.snapshot()
    assert snap["generations"] == eng.commit_pipe.fold_calls >= 1
    assert snap["fills"] > 0
    assert eng.supervisor.strikes == 0
