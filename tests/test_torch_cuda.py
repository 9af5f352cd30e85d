"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (a CUDA kernel has
no CPU mode).  On a machine with a card (``--noconftest``:
``tests/conftest.py`` configures JAX, which that machine does not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

import chip_smoke

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
    from coreth_tpu_torch.mpt import NativeSecureTrie
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.types import Block
    genesis, blocks = chip_smoke.build_chain(4, 32, 16)
    trie = NativeSecureTrie()
    gb = genesis.to_block(trie)
    eng = ReplayEngine(genesis.config, trie, parent_header=gb.header,
                       batch_pad=32, capacity=256, window=2, device=cuda)
    eng.DEVICE_RECOVER_MIN = 1
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root
    assert eng.stats.sigs_device == 4 * 32
