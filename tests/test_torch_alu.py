"""K4 (the 256-bit EVM ALU) and K3 (batched keccak-256): the port's plain
PyTorch versions against the JAX reference and big-int ground truth.

Operands are random (numpy, seeded) plus the edge values of the EVM
ALU; every result is an integer, so the tolerance is 0.  The CUDA
kernels are held against these same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coreth_tpu.ops import keccak as jkeccak
from coreth_tpu.ops import u256 as ju256
from coreth_tpu.ops import u256x as ju256x
from coreth_tpu_torch.crypto import keccak256_py
from coreth_tpu_torch.ops import keccak as tkeccak
from coreth_tpu_torch.ops import u256 as tu256
from coreth_tpu_torch.ops import u256x as tu256x

U256 = (1 << 256) - 1
U255 = 1 << 255
EDGE = [0, 1, 2, 3, U256, U256 - 1, U255, U255 - 1, U255 + 1,
        (1 << 128) - 1, 1 << 128, 0xFFFF, 0x10000, 30, 31, 32, 255, 256]


def _operands(seed: int, n: int = 40):
    """n values: the edges, then random 256/64/8-bit and power-of-two
    neighbours (the reference test's mix)."""
    rng = np.random.default_rng(seed)
    vals = list(EDGE)
    while len(vals) < n:
        kind = int(rng.integers(4))
        if kind == 0:
            vals.append(int.from_bytes(rng.bytes(32), "big"))
        elif kind == 1:
            vals.append(int.from_bytes(rng.bytes(8), "big"))
        elif kind == 2:
            vals.append(int(rng.integers(256)))
        else:
            vals.append((1 << int(rng.integers(256)))
                        + int(rng.integers(256)))
    order = rng.permutation(len(vals))
    return [vals[i] for i in order[:n]]


A, B, C = _operands(1), _operands(2), _operands(3)
# EXP exponents stay small enough to keep the bit loop short
E = [0, 1, 2, 3, 5, 16, 255, 256, 257, 0xFFFF] + [
    int(v) for v in np.random.default_rng(4).integers(0, 1 << 16, 30)]


def _both(vals):
    return tu256.from_ints(vals, device="cpu"), ju256.from_ints(vals)


def _signed(x):
    return x - (1 << 256) if x >= U255 else x


def _truth(op, a, b, c):
    """Big-int ground truth of one u256x_eval op."""
    if op == "add":
        return (a + b) & U256
    if op == "sub":
        return (a - b) & U256
    if op == "mul":
        return (a * b) & U256
    if op == "div":
        return a // b if b else 0
    if op == "mod":
        return a % b if b else 0
    if op in ("sdiv", "smod"):
        sa, sb = _signed(a), _signed(b)
        if sb == 0:
            return 0
        if op == "sdiv":
            q = abs(sa) // abs(sb)
            return (-q if (sa < 0) != (sb < 0) else q) & U256
        r = abs(sa) % abs(sb)
        return (-r if sa < 0 else r) & U256
    if op == "addmod":
        return (a + b) % c if c else 0
    if op == "mulmod":
        return (a * b) % c if c else 0
    if op == "exp":
        return pow(a, b, 1 << 256)
    if op == "shl":
        return (b << a) & U256 if a < 256 else 0
    if op == "shr":
        return b >> a if a < 256 else 0
    if op == "sar":
        return (_signed(b) >> min(a, 256)) & U256
    if op == "byte":
        return (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0
    if op == "signextend":
        if a > 30:
            return b
        bits = 8 * (a + 1)
        v = b & ((1 << bits) - 1)
        return v | (U256 ^ ((1 << bits) - 1)) if v >> (bits - 1) else v
    if op == "lt":
        return int(a < b)
    if op == "gt":
        return int(a > b)
    if op == "slt":
        return int(_signed(a) < _signed(b))
    if op == "sgt":
        return int(_signed(a) > _signed(b))
    if op == "eq":
        return int(a == b)
    if op == "not":
        return a ^ U256
    if op == "bit_length":
        return a.bit_length()
    if op == "mul_wide_lo":
        return (a * b) & U256
    if op == "mul_wide_hi":
        return (a * b) >> 256
    raise ValueError(op)


# the JAX function behind each u256x_eval op (same operand order)
_JAX = {
    "add": lambda a, b, c: ju256.add(a, b),
    "sub": lambda a, b, c: ju256.sub(a, b),
    "mul": lambda a, b, c: ju256x.mul(a, b),
    "div": lambda a, b, c: ju256x.divmod_(a, b)[0],
    "mod": lambda a, b, c: ju256x.divmod_(a, b)[1],
    "sdiv": lambda a, b, c: ju256x.sdiv(a, b),
    "smod": lambda a, b, c: ju256x.smod(a, b),
    "addmod": lambda a, b, c: ju256x.addmod(a, b, c),
    "mulmod": lambda a, b, c: ju256x.mulmod(a, b, c),
    "exp": lambda a, b, c: ju256x.exp_(a, b),
    "shl": lambda a, b, c: ju256x.shl(b, a),
    "shr": lambda a, b, c: ju256x.shr(b, a),
    "sar": lambda a, b, c: ju256x.sar(b, a),
    "byte": lambda a, b, c: ju256x.byte_op(a, b),
    "signextend": lambda a, b, c: ju256x.signextend(a, b),
    "lt": lambda a, b, c: ju256x.bool_word(ju256x.lt(a, b)),
    "gt": lambda a, b, c: ju256x.bool_word(ju256x.gt(a, b)),
    "slt": lambda a, b, c: ju256x.bool_word(ju256x.slt(a, b)),
    "sgt": lambda a, b, c: ju256x.bool_word(ju256x.sgt(a, b)),
    "eq": lambda a, b, c: ju256x.bool_word(ju256x.eq(a, b)),
    "not": lambda a, b, c: ju256x.not_(a),
    "bit_length": lambda a, b, c: jnp.zeros_like(a).at[:, 0].set(
        ju256x.bit_length(a)),
    "mul_wide_lo": lambda a, b, c: ju256x.mul_wide(a, b)[:, :16],
    "mul_wide_hi": lambda a, b, c: ju256x.mul_wide(a, b)[:, 16:],
}

# shift/byte/signextend amounts: small values and the >= 256 edges
SHIFTS = [0, 1, 8, 15, 16, 17, 31, 32, 100, 255, 256, 257, 1 << 200,
          30, 33] + [int(v) for v in
                     np.random.default_rng(5).integers(0, 300, 25)]


def _inputs(op):
    if op == "exp":
        return A, E, C
    if op in ("shl", "shr", "sar", "byte", "signextend"):
        return SHIFTS, A, C
    return A, B, C


@pytest.mark.parametrize("op", tu256x.OPS)
def test_u256x_op_matches_jax_and_bigint(op):
    a, b, c = _inputs(op)
    (ta, ja), (tb, jb), (tc, jc) = _both(a), _both(b), _both(c)
    got = tu256x.eval_ops(op, ta, tb, tc)   # CPU tensors: the plain version
    want = np.asarray(_JAX[op](ja, jb, jc))
    assert got.dtype == torch.int32 and int(got.max()) <= 0xFFFF
    assert np.array_equal(got.numpy(), want)
    assert tu256.to_ints(got) == [_truth(op, x, y, z)
                                  for x, y, z in zip(a, b, c)]


def test_u256x_carry_ripple_regression():
    """Full-width carry chains (2^256-1 + 1) through add and addmod."""
    cases = [(U256, 1), (U256, U256), ((1 << 240) - 1, 1),
             (0xFFFF_FFFF_FFFF, 0xFFFF)]
    mods = [U256, 7, 13, U256 - 1]
    ta = tu256.from_ints([a for a, _ in cases], device="cpu")
    tb = tu256.from_ints([b for _, b in cases], device="cpu")
    tn = tu256.from_ints(mods, device="cpu")
    s = tu256.add(ta, tb)
    assert int(s.max()) <= 0xFFFF
    assert tu256.to_ints(s) == [(a + b) & U256 for a, b in cases]
    got = tu256x.addmod(ta, tb, tn)
    want = ju256x.addmod(ju256.from_ints([a for a, _ in cases]),
                         ju256.from_ints([b for _, b in cases]),
                         ju256.from_ints(mods))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert tu256.to_ints(got) == [(a + b) % n
                                  for (a, b), n in zip(cases, mods)]


def test_u256x_rejects_malformed_operands():
    a = tu256.from_ints([1, 2], device="cpu")
    with pytest.raises(ValueError):
        tu256x.eval_ops("add", a, a[:1], a)
    with pytest.raises(ValueError):
        tu256x.eval_ops("nope", a, a, a)


# ---------------------------------------------------------------- keccak

def _messages(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lengths]


@pytest.mark.parametrize("lengths", [
    [0, 1, 31, 32, 64, 135],                  # one block
    [136, 137, 200, 271],                     # two blocks (the SHA3 cap)
    [272, 300, 407, 0, 135, 136],             # up to three, mixed
])
def test_keccak256_blocks_matches_jax(lengths):
    msgs = _messages(len(lengths), lengths)
    blocks, nblocks = tkeccak.pack_blocks(msgs)
    got = tkeccak.keccak256_blocks(torch.from_numpy(blocks),
                                   torch.from_numpy(nblocks))
    want = jkeccak.keccak256_blocks(blocks.view(np.uint32), nblocks)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert tkeccak.digests(got) == [keccak256_py(m) for m in msgs]


def test_keccak_f1600_matches_jax_permutation():
    rng = np.random.default_rng(11)
    lanes = rng.integers(0, 1 << 63, size=(3, 25), dtype=np.int64) \
        * 2 + rng.integers(0, 2, size=(3, 25))
    got = tkeccak.keccak_f1600(torch.from_numpy(lanes)).numpy()
    pairs = np.stack([lanes & 0xFFFFFFFF, (lanes >> 32) & 0xFFFFFFFF],
                     axis=-1).astype(np.uint32)
    want = np.asarray(jkeccak.keccak_f1600(jnp.asarray(pairs)))
    want64 = want[..., 0].astype(np.uint64) \
        | (want[..., 1].astype(np.uint64) << np.uint64(32))
    assert np.array_equal(got.view(np.uint64), want64)
