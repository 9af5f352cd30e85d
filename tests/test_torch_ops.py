"""Port parity of the kernels' plain versions against the JAX reference.

Inputs come from ``np.random.default_rng(seed)`` (or the port's signer)
and go through the JAX function on the CPU and the port's plain PyTorch
version; every result is an integer, so the tolerance is 0.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest
import torch

import chip_smoke
import secp_host_build
from coreth_tpu.ops import secp as jsecp
from coreth_tpu.ops import u256 as ju256
from coreth_tpu.replay import engine as jengine
from coreth_tpu_torch.crypto import native, secp_device
from coreth_tpu_torch.ops import secp as tsecp
from coreth_tpu_torch.ops import u256 as tu256
from coreth_tpu_torch.replay import engine as tengine


# ---------------------------------------------------------------- u256

def _rand_ints(rng, n, bits=256):
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


def test_u256_roundtrip():
    vals = [0, 1, 0xFFFF, 2**255 + 12345, 2**256 - 1, 10**24]
    assert tu256.to_ints(tu256.from_ints(vals, device="cpu")) == vals
    assert np.array_equal(tu256.pack_np(vals), ju256.pack_np(vals))


@pytest.mark.parametrize("seed", [7, 8])
def test_u256_add_sub_gte_match_jax(seed):
    rng = np.random.default_rng(seed)
    a_vals = _rand_ints(rng, 64) + [2**256 - 1, 0, 5]
    b_vals = _rand_ints(rng, 64) + [1, 0, 5]
    a_np, b_np = tu256.pack_np(a_vals), tu256.pack_np(b_vals)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    add = tu256.add(a, b)
    assert np.array_equal(add.numpy(), np.asarray(ju256.add(a_np, b_np)))
    assert tu256.to_ints(add) == [(x + y) % 2**256
                                  for x, y in zip(a_vals, b_vals)]
    sub = tu256.sub(a, b)    # wraps mod 2^256 where a < b
    assert np.array_equal(sub.numpy(), np.asarray(ju256.sub(a_np, b_np)))
    assert tu256.to_ints(sub) == [(x - y) % 2**256
                                  for x, y in zip(a_vals, b_vals)]
    gte = tu256.gte(a, b)
    assert gte.tolist() == np.asarray(ju256.gte(a_np, b_np)).tolist()
    assert gte.tolist() == [x >= y for x, y in zip(a_vals, b_vals)]
    k = torch.from_numpy(rng.integers(0, 1 << 15, size=len(a_vals))
                         .astype(np.int32))
    assert np.array_equal(tu256.mul_small(a, k).numpy(),
                          np.asarray(ju256.mul_small(a_np, k.numpy())))
    assert tu256.is_zero(tu256.sub(a, a)).all()


def test_u256_segment_headroom():
    # sum 4096 maxed values then normalize — no overflow in int32 limbs
    vals = tu256.from_ints([2**256 - 1] * 4096, device="cpu")
    norm = tu256.normalize(vals.sum(0, dtype=torch.int32)[None, :])
    assert tu256.to_ints(norm)[0] == (4096 * (2**256 - 1)) % 2**256


# -------------------------------------------------------- K1 (window)

def _window(seed, K=8, pad=32, B=24):
    rng = np.random.default_rng(seed)
    return chip_smoke.random_window(
        rng, K, pad, B, cap=512, scap=64, n_acct=200, n_slot=10, L=256,
        SL=16, t_pad=64, s_pad=16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transfer_window_plain_matches_jax(seed):
    win = _window(seed)
    want = jengine._transfer_window(*win)
    got = tengine._transfer_window_plain(
        *(torch.from_numpy(a) for a in win))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    ok = got[3][:, -1, 0].tolist()
    # the window covers an insolvent block and a nonce mismatch; the
    # later blocks still run on top of the failed ones
    assert ok[1] == 0 and ok[2] == 0 and ok[0] == 1
    # token slot amounts moved some slot values
    assert not np.array_equal(got[2].numpy(), win[2])


@pytest.mark.parametrize("case", ["hot", "pad_rows", "wrap", "untouched",
                                  "negative"])
def test_transfer_window_plain_matches_jax_on_shaped_windows(case):
    """The windows the kernels' row-parallel walk could get wrong
    (``chip_smoke.shaped_window``): one recipient and slot a block, out
    of range pad rows and coinbase, required totals and balances that
    wrap past 2^256 with blocks on top of a failed one, fetched rows a
    block does not touch, negative sender and fetch indices (a jnp
    gather wraps -2 to the second-last row: block 0's nonce check
    passes on it)."""
    win = chip_smoke.shaped_window(
        np.random.default_rng(40), case, 8, 32, 24, cap=512, scap=64,
        n_acct=200, n_slot=10, L=256, SL=16, t_pad=64, s_pad=16)
    want = jengine._transfer_window(*win)
    got = tengine._transfer_window_plain(
        *(torch.from_numpy(a) for a in win))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[3][:, -1, 0].tolist()[:3] == [1, 0, 0]


def test_transfer_window_wrapper_dispatch():
    win = [torch.from_numpy(a) for a in _window(3, K=2)]
    launches = tengine.LAUNCHES
    got = tengine._transfer_window(*win)       # CPU tensors: plain
    want = tengine._transfer_window_plain(*win)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tengine.LAUNCHES == launches
    with pytest.raises(ValueError):
        tengine._transfer_window(*(t.to("meta") for t in win))
    with pytest.raises(ValueError):
        tengine._transfer_window(win[0].long(), *win[1:])


# ---------------------------------------------------------- K2 (ladder)

@pytest.fixture(scope="module")
def sig_batch():
    return chip_smoke.signature_batch(64, 11)


def test_recover_plain_matches_jax(sig_batch):
    _packed, kin = sig_batch
    want = np.asarray(jsecp.recover_kernel(*kin))
    got = tsecp.recover_kernel_plain(*(torch.from_numpy(a) for a in kin))
    assert np.array_equal(got.numpy(), want)
    # the malformed rows are in there: x >= p and non-residues
    assert got[:, 101].numpy().min() == 0


def test_issue_complete_recover_matches_native(sig_batch):
    packed, _kin = sig_batch
    launches = tsecp.LAUNCHES
    addrs, ok = secp_device.complete_recover(
        secp_device.issue_recover(*packed, torch.device("cpu")))
    want_addrs, want_ok = native.recover_addresses_batch(*packed)
    assert ok == want_ok
    assert 0 < sum(ok) < len(ok)        # valid and malformed rows
    for i in range(len(ok)):
        if ok[i]:
            assert addrs[20 * i:20 * i + 20] == want_addrs[20 * i:20 * i + 20]
    assert tsecp.LAUNCHES == launches   # the CPU ran the plain version


def test_recover_wrapper_rejects_bad_input(sig_batch):
    _packed, kin = sig_batch
    args = [torch.from_numpy(a) for a in kin]
    with pytest.raises(ValueError):
        tsecp.recover_kernel(*(t.to("meta") for t in args))
    with pytest.raises(ValueError):
        tsecp.recover_kernel(args[0], args[1].long(), args[2], args[3])


@pytest.fixture(scope="module")
def corner_rows():
    return chip_smoke.corner_batch(17)


def test_recover_plain_matches_jax_on_corner_rows(corner_rows, sig_batch):
    """R = G (the 2G entry), R = -G (the infinite G+R entry), a doubling
    collision, u1 = 0, u2 = 0, u1 = u2 = 0 and top-bit scalars: rows equal
    to the reference's, with the collision and infinity flags where the
    rows put them.  Signature rows fill the batch to the fixture's 64, the
    shape the reference's program is already compiled for."""
    n = len(corner_rows[0])
    kin = [np.concatenate([c, s[:64 - n]])
           for c, s in zip(corner_rows, sig_batch[1])]
    want = np.asarray(jsecp.recover_kernel(*kin))
    got = tsecp.recover_kernel_plain(*(torch.from_numpy(a) for a in kin))
    assert np.array_equal(got.numpy(), want)
    got = got[:n].numpy()
    assert got[:, 100].tolist() == [0, 0, 1, 0, 0, 0, 0]   # collision
    assert got[:, 99].tolist() == [0, 0, 0, 0, 0, 1, 0]    # at infinity
    assert got[:, 101].all()                                # residues


# ------------------------------------------- host build of K2's source

@pytest.fixture(scope="module")
def host_k2(tmp_path_factory):
    """The host builds at group widths 1 and 4, by width."""
    if secp_host_build.gxx() is None:
        pytest.skip("needs g++")
    tmp = str(tmp_path_factory.mktemp("host_k2"))
    return {g: secp_host_build.build(tmp, g) for g in (1, 4)}


@pytest.mark.parametrize("g", [1, 4])
def test_host_build_of_k2_matches_plain(host_k2, corner_rows, sig_batch, g):
    """``csrc/secp_recover.cu`` built for the host (tests/secp_host_build.py:
    the PTX carry chains on a portable flag; at group width 4 each lane a
    host thread and every shuffle and vote a barrier) equals the plain
    version byte for byte on the corner rows and on the signature batch
    with its malformed rows (its last 8 rows at width 4).  The shuffle
    path as the card schedules it is checked only on the card
    (tests/test_torch_cuda.py, chip_smoke.py phase k2)."""
    sigs = sig_batch[1] if g == 1 else [a[-8:] for a in sig_batch[1]]
    for kin in (corner_rows, sigs):
        want = tsecp.recover_kernel_plain(*(torch.from_numpy(a) for a in kin))
        got = secp_host_build.run(host_k2[g], *kin)
        assert np.array_equal(got, want.numpy())


_P = tsecp.P
_WRAP = 2**32 + 977                      # 2^256 mod p
_FE_EDGES = [0, 1, 2, 977, _WRAP, 2**64 - 1, 2**64, 2**255, _P - 1, _P,
             _P + 1, 2**256 - 2, 2**256 - 1]


def _fe_operands():
    """Every pair of edge values, seeded random pairs, and products whose
    fold leaves the low 64-bit digit within 2^32 + 977 of 2^64 after the
    wrap: (p - 1) * (p - (2^32 + 977 + r)) = 2^32 + 977 + r (mod p)."""
    rng = np.random.default_rng(31)
    pairs = [(a, b) for a in _FE_EDGES for b in _FE_EDGES]
    pairs += [(int.from_bytes(rng.bytes(32), "little"),
               int.from_bytes(rng.bytes(32), "little")) for _ in range(16)]
    pairs += [(_P - 1, _P - (_WRAP + r))
              for r in (2**64 - 1, 2**64 - 977, 2**64 - _WRAP, 2**65 - 1,
                        3 * 2**64 - 5)]
    return [a for a, _ in pairs], [b for _, b in pairs]


_FE_WANT = {
    "mul": lambda a, b: (a * b, 0),
    "add": lambda a, b: (a + b, 0),
    "sub": lambda a, b: (a - b, 0),
    "mul2": lambda a, b: (a * b, a * a),
    "subadd": lambda a, b: (a - b, a + b),
    "wrap": lambda a, b: (a + (b & 15) * 2**256, 0),
}


@pytest.mark.parametrize("op", list(secp_host_build.FE_OPS))
@pytest.mark.parametrize("g", [1, 4])
def test_host_build_field_ops_match_integers(host_k2, g, op):
    """K2's field operations, one a row, at group widths 1 and 4 on edge
    operands (0, 1, p - 1, p, p + 1, 2^256 - 1, ...), random ones, and
    products built to carry out of the low digit after the fold's wrap:
    each result below 2^256 and equal mod p to Python's integers ("canon":
    exactly a mod p, with the zero flag).  These operands take the carry
    paths that random signatures never reach: an add's or subtract's
    second wrap, the multiply's carry out of the low digit after the wrap,
    and the x unpack's second wrap (a copy of the source with any one of
    them removed fails here).  The shuffle path as the card schedules it is
    checked only on the card."""
    a, b = _fe_operands()
    got = secp_host_build.run_fe(host_k2[g], op, a, b)
    for x, y, r in zip(a, b, got):
        if op == "canon":
            assert r == (x % _P, int(x % _P == 0)), (x, y)
        else:
            w = _FE_WANT[op](x, y)
            assert (r[0] - w[0]) % _P == 0 and (r[1] - w[1]) % _P == 0, (x, y)
