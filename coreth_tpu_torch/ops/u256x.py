"""Extended 256-bit arithmetic — the plain PyTorch version of K4.

Port of reference ``ops/u256x.py``: the EVM ALU ops the step machine
needs beyond add/sub/compare (full and wide multiply, division and
modulo by restoring bit-serial division, signed variants, modular ops
over arbitrary moduli, EXP, shifts, BYTE, SIGNEXTEND), on the same
(..., 16) int32 tensors of 16-bit limbs as ``ops/u256`` (reference
semantics: core/vm/instructions.go opMul/opDiv/opSdiv/opAddmod/...).

Everything stays in int32: 16x16-bit limb products are kept inside
int32 by splitting one operand into 8-bit halves.  The CUDA twin is
``csrc/u256x.cuh`` (device functions on 8 x 32-bit words in registers,
carry chains, word-wise long division; called by the lane interpreters);
``eval_ops`` below is the wrapper of its standalone launch entry
``u256x_eval``, which holds the two against each other one op at a
time.
"""

from __future__ import annotations

import torch

from coreth_tpu_torch import kernels
from coreth_tpu_torch.ops import u256

L = u256.LIMBS
MASK = u256.LIMB_MASK


def _zeros_head(a: torch.Tensor, extra=()) -> torch.Tensor:
    return torch.zeros(tuple(a.shape[:-1]) + tuple(extra),
                       dtype=torch.int32, device=a.device)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^256 (b split into bytes keeps partial sums < 2^29)."""
    bl = b & 0xFF
    bh = (b >> 8) & 0xFF
    outs = []
    carry = _zeros_head(a)
    p1_hi = _zeros_head(a)
    for k in range(L):
        p0 = _zeros_head(a)
        p1 = _zeros_head(a)
        for i in range(k + 1):
            ai = a[..., i]
            p0 = p0 + ai * bl[..., k - i]
            p1 = p1 + ai * bh[..., k - i]
        v = p0 + ((p1 & 0xFF) << 8) + p1_hi + carry
        outs.append(v & MASK)
        carry = v >> 16
        p1_hi = p1 >> 8
    return torch.stack(outs, dim=-1)


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 512-bit product as (..., 32) limbs (for MULMOD)."""
    bl = b & 0xFF
    bh = (b >> 8) & 0xFF
    outs = []
    carry = _zeros_head(a)
    p1_hi = _zeros_head(a)
    for k in range(2 * L - 1):
        p0 = _zeros_head(a)
        p1 = _zeros_head(a)
        for i in range(max(0, k - L + 1), min(k + 1, L)):
            ai = a[..., i]
            p0 = p0 + ai * bl[..., k - i]
            p1 = p1 + ai * bh[..., k - i]
        v = p0 + ((p1 & 0xFF) << 8) + p1_hi + carry
        outs.append(v & MASK)
        carry = v >> 16
        p1_hi = p1 >> 8
    outs.append(carry + p1_hi)  # true top limb, already < 2^16
    return torch.stack(outs, dim=-1)


def _shift1_add_bit(r: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """r*2 + bit with one carry pass (entry limbs are < 2^16)."""
    r = r * 2
    r[..., 0] += bit
    c = r >> 16
    return (r & MASK) + torch.cat(
        [torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def _mod_bits(x: torch.Tensor, nbits: int, n: torch.Tensor,
              with_quotient: bool = False):
    """x mod n by restoring division over x's top ``nbits`` bits.

    x: (..., ceil(nbits/16)) limbs; n: (..., 16).  n == 0 -> 0.
    Returns (q (..., 16) if with_quotient else None, r (..., 16)).
    The quotient is only valid when it fits 256 bits (DIV)."""
    n17 = torch.cat([n, _zeros_head(n, (1,))], dim=-1)
    r = _zeros_head(n, (17,))
    q = torch.zeros_like(n) if with_quotient else None
    for i in range(nbits):
        bitpos = nbits - 1 - i
        limb, sh = bitpos // 16, bitpos % 16
        bit = (x[..., limb] >> sh) & 1
        r = _shift1_add_bit(r, bit)
        ge = u256.gte(r, n17)
        r = torch.where(ge[..., None], u256.sub(r, n17), r)
        if q is not None:
            q[..., limb] += ge.to(torch.int32) << sh
    nz = ~u256.is_zero(n)
    r16 = torch.where(nz[..., None], r[..., :L], 0)
    if with_quotient:
        return torch.where(nz[..., None], q, 0), r16
    return None, r16


def divmod_(a: torch.Tensor, b: torch.Tensor):
    """(a // b, a % b); b == 0 -> (0, 0) (EVM DIV/MOD semantics)."""
    return _mod_bits(a, 256, b, with_quotient=True)


def neg(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement negation mod 2^256."""
    return u256.sub(torch.zeros_like(a), a)


def _sign(a: torch.Tensor) -> torch.Tensor:
    """1 where a's 255th bit is set (negative as signed)."""
    return (a[..., L - 1] >> 15) & 1


def _abs(a: torch.Tensor) -> torch.Tensor:
    return torch.where(_sign(a)[..., None] == 1, neg(a), a)


def sdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed division truncating toward zero (opSdiv)."""
    q, _ = divmod_(_abs(a), _abs(b))
    negate = _sign(a) ^ _sign(b)
    return torch.where(negate[..., None] == 1, neg(q), q)


def smod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed modulo: the result takes the dividend's sign (opSmod)."""
    _, r = divmod_(_abs(a), _abs(b))
    return torch.where(_sign(a)[..., None] == 1, neg(r), r)


def addmod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a + b) % n over the full 257-bit sum (opAddmod)."""
    s = u256.normalize(torch.cat([a + b, _zeros_head(a, (1,))], dim=-1))
    _, r = _mod_bits(s, 17 * 16, n)
    return r


def mulmod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a * b) % n over the 512-bit product (opMulmod)."""
    _, r = _mod_bits(mul_wide(a, b), 512, n)
    return r


def bit_length(a: torch.Tensor) -> torch.Tensor:
    """Bit length per element (0 for zero), via a 16-bit limb scan."""
    v = a
    bl = torch.zeros_like(v)
    for shift in (8, 4, 2, 1):
        big = v >= (1 << shift)
        bl = bl + torch.where(big, shift, 0)
        v = torch.where(big, v >> shift, v)
    bl = bl + (v > 0).to(torch.int32)  # v now 0 or 1
    idx = torch.arange(L, dtype=torch.int32, device=a.device)
    per_limb = torch.where(a > 0, idx * 16 + bl, 0)
    return per_limb.max(dim=-1).values


def exp_(b: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """b ** e mod 2^256 by right-to-left square-and-multiply, bounded by
    the batch's largest exponent bit length (opExp)."""
    maxbits = int(bit_length(e).max()) if e.numel() else 0
    res = torch.zeros_like(b)
    res[..., 0] = 1
    cur = b
    for i in range(maxbits):
        bit = (e[..., i // 16] >> (i % 16)) & 1
        res = torch.where(bit[..., None] == 1, mul(res, cur), res)
        cur = mul(cur, cur)
    return res


def _shift_amount(n: torch.Tensor):
    """(effective shift in [0, 255], overflow >= 256 flag)."""
    over = (n[..., 0] > 255) | (n[..., 1:] != 0).any(dim=-1)
    return torch.where(over, 0, n[..., 0]), over


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.clamp(0, L - 1).long())


def shl(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    s, over = _shift_amount(n)
    limb_sh, bit_sh = s // 16, s % 16
    idx = torch.arange(L, dtype=torch.int32, device=x.device) \
        - limb_sh[..., None]
    g = torch.where(idx >= 0, _take(x, idx), 0)
    prev = torch.cat([torch.zeros_like(g[..., :1]), g[..., :-1]], dim=-1)
    out = ((g << bit_sh[..., None]) & MASK) \
        | (prev >> (16 - bit_sh)[..., None])
    return torch.where(over[..., None], 0, out)


def shr(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    s, over = _shift_amount(n)
    limb_sh, bit_sh = s // 16, s % 16
    idx = torch.arange(L, dtype=torch.int32, device=x.device) \
        + limb_sh[..., None]
    g = torch.where(idx <= L - 1, _take(x, idx), 0)
    nxt = torch.cat([g[..., 1:], torch.zeros_like(g[..., :1])], dim=-1)
    out = (g >> bit_sh[..., None]) \
        | ((nxt << (16 - bit_sh)[..., None]) & MASK)
    return torch.where(over[..., None], 0, out)


def sar(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    sign = _sign(x)
    base = shr(x, n)
    s, over = _shift_amount(n)
    t = 256 - s  # first filled bit position; s == 0 -> no fill
    k16 = torch.arange(L, dtype=torch.int32, device=x.device) * 16
    rel = t[..., None] - k16
    fill_mask = torch.where(
        rel <= 0, MASK,
        torch.where(rel >= 16, 0, (MASK << rel.clamp(0, 16)) & MASK))
    filled = base | torch.where(sign[..., None] == 1, fill_mask, 0)
    over_val = torch.where(sign[..., None] == 1,
                           torch.full_like(x, MASK), torch.zeros_like(x))
    return torch.where(over[..., None], over_val, filled)


def byte_op(i: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """BYTE: big-endian byte i of x, 0 when i >= 32 (opByte)."""
    over = (i[..., 0] > 31) | (i[..., 1:] != 0).any(dim=-1)
    p = 31 - i[..., 0].clamp(0, 31)  # little-endian byte position
    limb = _take(x, (p // 2)[..., None])[..., 0]
    byte = torch.where(over, 0, (limb >> ((p % 2) * 8)) & 0xFF)
    out = torch.zeros_like(x)
    out[..., 0] = byte
    return out


def signextend(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SIGNEXTEND: extend from byte b (0 = lowest byte)."""
    over = (b[..., 0] > 30) | (b[..., 1:] != 0).any(dim=-1)
    t = 8 * b[..., 0].clamp(0, 30) + 7  # sign bit position
    limb = _take(x, (t // 16)[..., None])[..., 0]
    sign = (limb >> (t % 16)) & 1
    k16 = torch.arange(L, dtype=torch.int32, device=x.device) * 16
    rel = (t + 1)[..., None] - k16  # bits below rel are kept
    keep_mask = torch.where(
        rel >= 16, MASK,
        torch.where(rel <= 0, 0, MASK >> (16 - rel).clamp(0, 16)))
    ext = torch.where(sign[..., None] == 1, x | (keep_mask ^ MASK),
                      x & keep_mask)
    return torch.where(over[..., None], x, ext)


# ----------------------------------------------------------- comparisons

def eq(a, b):
    return torch.all(a == b, dim=-1)


def lt(a, b):
    return ~u256.gte(a, b)


def gt(a, b):
    return ~u256.gte(b, a)


def _flip_sign(a):
    out = a.clone()
    out[..., L - 1] ^= 0x8000
    return out


def slt(a, b):
    return lt(_flip_sign(a), _flip_sign(b))


def sgt(a, b):
    return gt(_flip_sign(a), _flip_sign(b))


def bool_word(m: torch.Tensor) -> torch.Tensor:
    """Bool (...,) -> u256 0/1 word."""
    out = torch.zeros(tuple(m.shape) + (L,), dtype=torch.int32,
                      device=m.device)
    out[..., 0] = m.to(torch.int32)
    return out


def not_(a):
    return a ^ MASK


# ------------------------------------------- the K4 standalone launch entry
# Op codes of ``u256x_eval`` (shared with csrc/u256x_eval.cu).  Every op
# reads (a, b, c) and returns one word; comparisons and BIT_LENGTH
# return their result in limb 0.
OPS = ("add", "sub", "mul", "div", "mod", "sdiv", "smod", "addmod",
       "mulmod", "exp", "shl", "shr", "sar", "byte", "signextend", "lt",
       "gt", "slt", "sgt", "eq", "not", "bit_length", "mul_wide_lo",
       "mul_wide_hi")
OP_INDEX = {name: i for i, name in enumerate(OPS)}


def eval_plain(op: str, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """The plain version of one ``u256x_eval`` op over operand rows."""
    if op == "add":
        return u256.add(a, b)
    if op == "sub":
        return u256.sub(a, b)
    if op == "mul":
        return mul(a, b)
    if op == "div":
        return divmod_(a, b)[0]
    if op == "mod":
        return divmod_(a, b)[1]
    if op == "sdiv":
        return sdiv(a, b)
    if op == "smod":
        return smod(a, b)
    if op == "addmod":
        return addmod(a, b, c)
    if op == "mulmod":
        return mulmod(a, b, c)
    if op == "exp":
        return exp_(a, b)
    if op == "shl":
        return shl(b, a)   # EVM operand order: shift amount on top
    if op == "shr":
        return shr(b, a)
    if op == "sar":
        return sar(b, a)
    if op == "byte":
        return byte_op(a, b)
    if op == "signextend":
        return signextend(a, b)
    if op in ("lt", "gt", "slt", "sgt", "eq"):
        return bool_word(globals()[op](a, b))
    if op == "not":
        return not_(a)
    if op == "bit_length":
        out = torch.zeros_like(a)
        out[..., 0] = bit_length(a)
        return out
    if op == "mul_wide_lo":
        return mul_wide(a, b)[..., :L]
    if op == "mul_wide_hi":
        return mul_wide(a, b)[..., L:]
    raise ValueError(f"unknown u256x op {op!r}")


LAUNCHES = 0


def eval_ops(op: str, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """One ALU op over rows of operands: the CUDA launch entry
    ``u256x_eval`` (``csrc/u256x_eval.cu``, the device functions of
    ``csrc/u256x.cuh``) for CUDA tensors, the plain version for CPU
    tensors.  a, b, c: (n, 16) int32 limbs; returns (n, 16)."""
    dev = a.device
    for t in (a, b, c):
        if (t.dtype != torch.int32 or t.device != dev or t.dim() != 2
                or t.shape != a.shape or t.shape[1] != L):
            raise ValueError("u256x.eval_ops: operands must be (n, 16) "
                             f"int32 on {dev}")
    if op not in OP_INDEX:
        raise ValueError(f"unknown u256x op {op!r}")
    if dev.type == "cpu":
        return eval_plain(op, a, b, c)
    if dev.type != "cuda":
        raise ValueError(f"u256x.eval_ops: unsupported device {dev}")
    global LAUNCHES
    lib = kernels.load("u256x_eval")
    a, b, c = (t.contiguous() for t in (a, b, c))
    out = torch.empty_like(a)
    rc = lib.u256x_eval_launch(
        OP_INDEX[op], a.data_ptr(), b.data_ptr(), c.data_ptr(),
        out.data_ptr(), a.shape[0], kernels.raw_stream(a.get_device()))
    kernels.check(rc, "u256x_eval")
    LAUNCHES += 1
    return out
