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


def test_erc20_replay_on_the_card(cuda):
    """ERC-20 transfer() blocks replay through the machine path with the
    step-machine kernel, to the header roots."""
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_erc20_chain(3, 32, 16)
    store = StateStore()
    gb = genesis.to_block(store)
    eng = ReplayEngine(genesis.config, store, parent_header=gb.header,
                       batch_pad=32, capacity=256, device=cuda)
    launches = M.LAUNCHES
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    mc = eng.machine_counters()
    assert mc["blocks"] == 3 and mc["rounds"] > 0
    assert M.LAUNCHES - launches == mc["launches"] > 0
