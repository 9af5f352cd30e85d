"""Batched secp256k1 public-key recovery ladder.

Port of reference ``ops/secp.py``.  The host (``crypto/secp_device.py``)
does the cheap per-signature scalar math; this module runs the expensive
part — y = sqrt(x^3 + 7), the parity select, the G+R table entry and
the 256-step Shamir ladder u1*G + u2*R — for a whole batch:

- ``recover_kernel`` is the wrapper: CUDA tensors launch the hand-written
  kernel (``csrc/secp_recover.cu``), CPU tensors run the plain version,
  anything else raises.  ``LAUNCHES`` counts kernel launches.
- ``recover_kernel_plain`` is the plain PyTorch version: the same
  formulas, selection rules and output bytes, vectorized over the batch.

Plain-version field elements are (B, 16) int64 tensors of 16-bit limbs
reduced lazily (``_reduce``): congruent mod p, limbs a little above
2^16 allowed, canonicalized only where a value is compared or emitted.
p = 2^256 - 2^32 - 977, so a part above 2^256 folds back as 2^32 + 977.

I/O (both versions): x_bytes (B, 33) uint8 little-endian x (< 2^257),
parity (B,) int32, u1w/u2w (B, 8) int32 little-endian scalar words ->
(B, 102) uint8: X(33) ++ Y(33) ++ Z(33) canonical Jacobian little-endian
++ [inf, collision, is_residue].
"""

from __future__ import annotations

import torch

from coreth_tpu_torch import kernels

P = 2**256 - 2**32 - 977
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

LIMBS = 16
MASK = 0xFFFF

# affine 2G, for the R == G corner of the G+R table entry
_G2_LAM = (3 * GX * GX) * pow(2 * GY, P - 2, P) % P
G2X = (_G2_LAM * _G2_LAM - 2 * GX) % P
G2Y = (_G2_LAM * (GX - G2X) - GY) % P

# MSB-first exponent bits: (p+1)/4 (square root, p = 3 mod 4), p-2
# (Fermat inversion)
_SQRT_BITS = [(((P + 1) // 4) >> (255 - i)) & 1 for i in range(256)]
_INV_BITS = [((P - 2) >> (255 - i)) & 1 for i in range(256)]

LAUNCHES = 0


def _const(v: int, device, limbs: int = LIMBS) -> torch.Tensor:
    return torch.tensor([(v >> (16 * i)) & MASK for i in range(limbs)],
                        dtype=torch.int64, device=device)


# A lazy field element: (B, 16) int64 limbs, each in [0, LAZY], value
# congruent mod p.  Its value stays below 2^256 * 1.04 < 2p, and limb
# products stay below 2^33, so a product's column sums fit int64 easily.
LAZY = MASK + (1 << 11)


def _reduce(cols: torch.Tensor, bounds) -> torch.Tensor:
    """Columns with known per-column upper bounds (Python ints) -> a
    lazy element.  Folds columns past 16 (2^256 = 2^32 + 977 mod p) and
    runs parallel carry passes, on a schedule fixed by the bounds alone
    (never by the data), until 16 columns each <= LAZY remain."""
    bounds = list(bounds)
    while True:
        w = len(bounds)
        if w > LIMBS:
            h = w - LIMBS
            nw = max(LIMBS, h + 2)
            out = torch.zeros((cols.shape[0], nw), dtype=torch.int64,
                              device=cols.device)
            out[:, :LIMBS] += cols[:, :LIMBS]
            out[:, :h] += cols[:, LIMBS:] * 977
            out[:, 2:h + 2] += cols[:, LIMBS:]
            nb = bounds[:LIMBS] + [0] * (nw - LIMBS)
            for k in range(h):
                nb[k] += 977 * bounds[LIMBS + k]
                nb[k + 2] += bounds[LIMBS + k]
            cols, bounds = out, nb
            continue
        if max(bounds) <= LAZY:
            return cols
        carry = cols >> 16
        top = bounds[-1] >> 16
        out = cols & MASK
        if top:
            out = torch.cat([out, carry[:, -1:]], dim=1)
        out[:, 1:w] += carry[:, :w - 1]
        nb = [min(b, MASK) for b in bounds] + ([top] if top else [])
        for k in range(1, w):
            nb[k] += bounds[k - 1] >> 16
        cols, bounds = out, nb


def _normalize17(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry of a lazy element to 17 limbs in [0, 2^16)
    (the value is < 2^257, so the 17th limb is 0 or 1)."""
    out = []
    carry = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(LIMBS):
        t = x[:, i] + carry
        out.append(t & MASK)
        carry = t >> 16
    out.append(carry)
    return torch.stack(out, dim=1)


class _Field:
    """Arithmetic mod p on lazy (B, 16) int64 limb tensors."""

    def __init__(self, device):
        self.device = device
        self.p17 = _const(P, device, LIMBS + 1)
        # product (i, j) lands in column i + j
        self.diag = (torch.arange(LIMBS)[:, None]
                     + torch.arange(LIMBS)[None, :]).reshape(-1).to(device)
        # 4p with every limb >= 2^17 - 2 (> LAZY): a - b + K4P never
        # has a negative column
        k = [(4 * P >> (16 * i)) & MASK for i in range(LIMBS + 1)]
        for i in range(LIMBS):
            k[i] += 1 << 17
            k[i + 1] -= 2
        self.k4p = torch.tensor(k, dtype=torch.int64, device=device)
        self.k4p_bounds = [v + LAZY for v in k[:LIMBS]] + [k[LIMBS]]

    def const(self, v: int, batch: int) -> torch.Tensor:
        return _const(v, self.device).expand(batch, LIMBS)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        prod = (a[:, :, None] * b[:, None, :]).reshape(-1, LIMBS * LIMBS)
        cols = torch.zeros((a.shape[0], 2 * LIMBS - 1), dtype=torch.int64,
                           device=a.device)
        cols.index_add_(1, self.diag, prod)   # column i + j
        bounds = [LAZY * LAZY * (min(k, 2 * LIMBS - 2 - k) + 1)
                  for k in range(2 * LIMBS - 1)]
        return _reduce(cols, bounds)

    def sq(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _reduce(a + b, [2 * LAZY] * LIMBS)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        cols = torch.cat([a, torch.zeros_like(a[:, :1])], dim=1) \
            + self.k4p
        cols[:, :LIMBS] -= b
        return _reduce(cols, self.k4p_bounds)

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """The canonical representative in [0, p), 16 limbs."""
        x = _normalize17(a)                     # value < 2p
        out = []
        borrow = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for i in range(LIMBS + 1):
            t = x[:, i] - self.p17[i] + borrow
            out.append(t & MASK)
            borrow = t >> 16
        d = torch.stack(out, dim=1)
        return torch.where((borrow == 0)[:, None], d, x)[:, :LIMBS]

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        x = _normalize17(a)                     # value < 2p: 0 or p
        return torch.all(x == 0, dim=1) | torch.all(x == self.p17, dim=1)

    def pow(self, base: torch.Tensor, bits) -> torch.Tensor:
        acc = self.const(1, base.shape[0])
        for bit in bits:
            acc = self.sq(acc)
            if bit:
                acc = self.mul(acc, base)
        return acc


def _pt_double(F: _Field, X, Y, Z):
    """Jacobian doubling, a = 0 (reference pt_double, same order)."""
    A = F.sq(X)
    Bb = F.sq(Y)
    C = F.sq(Bb)
    t = F.sub(F.sub(F.sq(F.add(X, Bb)), A), C)
    D = F.add(t, t)
    E = F.add(F.add(A, A), A)
    Fq = F.sq(E)
    nX = F.sub(Fq, F.add(D, D))
    C2 = F.add(C, C)
    C8 = F.add(F.add(C2, C2), F.add(C2, C2))
    nY = F.sub(F.mul(E, F.sub(D, nX)), C8)
    nZ = F.mul(F.add(Y, Y), Z)
    return nX, nY, nZ


def _mixed_add(F: _Field, X, Y, Z, inf, ax, ay, a_inf, do):
    """Complete branchless Jacobian += affine (reference _mixed_add):
    returns (X', Y', Z', inf', collision)."""
    z1z1 = F.sq(Z)
    u2 = F.mul(ax, z1z1)
    s2 = F.mul(ay, F.mul(Z, z1z1))
    h = F.sub(u2, X)
    r = F.sub(s2, Y)
    h0 = F.is_zero(h)
    r0 = F.is_zero(r)
    hh = F.sq(h)
    hhh = F.mul(h, hh)
    v = F.mul(X, hh)
    nx = F.sub(F.sub(F.sq(r), hhh), F.add(v, v))
    ny = F.sub(F.mul(r, F.sub(v, nx)), F.mul(Y, hhh))
    nz = F.mul(Z, h)

    eff = do & ~a_inf
    take = eff & inf
    general = eff & ~inf
    collision = general & h0 & r0
    to_inf = general & h0 & ~r0
    ta, ge = take[:, None], general[:, None]
    one = F.const(1, X.shape[0])
    Xo = torch.where(ta, ax, torch.where(ge, nx, X))
    Yo = torch.where(ta, ay, torch.where(ge, ny, Y))
    Zo = torch.where(ta, one, torch.where(ge, nz, Z))
    info = torch.where(take, False, torch.where(general, to_inf, inf))
    return Xo, Yo, Zo, info, collision


def _unpack_x(F: _Field, x_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 33) uint8 -> x mod p from bits 0..259, like the reference's
    20 x 13-bit unpack (inputs are < 2^257)."""
    b = x_bytes.to(torch.int64)
    limbs = b[:, 0:32:2] | (b[:, 1:32:2] << 8)
    top = (b[:, 32] & 0xF)[:, None]
    return _reduce(torch.cat([limbs, top], dim=1), [MASK] * LIMBS + [15])


def _pack(x: torch.Tensor) -> torch.Tensor:
    """(B, 16) canonical limbs -> (B, 33) uint8 little-endian."""
    lo = (x & 0xFF).to(torch.uint8)
    hi = (x >> 8).to(torch.uint8)
    out = torch.stack([lo, hi], dim=-1).reshape(x.shape[0], 32)
    return torch.cat([out, torch.zeros((x.shape[0], 1), dtype=torch.uint8,
                                       device=x.device)], dim=1)


def recover_kernel_plain(x_bytes: torch.Tensor, parity: torch.Tensor,
                         u1w: torch.Tensor, u2w: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of the recovery kernel (see module doc)."""
    dev = x_bytes.device
    F = _Field(dev)
    Bsz = x_bytes.shape[0]
    x = _unpack_x(F, x_bytes)
    ysq = F.add(F.mul(F.mul(x, x), x), F.const(7, Bsz))
    y = F.canon(F.pow(ysq, _SQRT_BITS))
    residue = torch.all(F.canon(F.sq(y)) == F.canon(ysq), dim=-1)
    yneg = F.canon(F.sub(torch.zeros_like(y), y))
    flip = (y[:, 0] & 1) != parity.to(torch.int64)
    y = torch.where(flip[:, None], yneg, y)

    gx, gy = F.const(GX, Bsz), F.const(GY, Bsz)
    dx = F.sub(x, gx)
    x_eq = F.is_zero(dx)
    lam = F.mul(F.sub(y, gy), F.pow(dx, _INV_BITS))
    gqx = F.sub(F.sub(F.mul(lam, lam), gx), x)
    gqy = F.sub(F.mul(lam, F.sub(gx, gqx)), gy)
    y_eq = F.is_zero(F.sub(y, gy))
    is_2g = (x_eq & y_eq)[:, None]
    gqx = torch.where(is_2g, F.const(G2X, Bsz), gqx)
    gqy = torch.where(is_2g, F.const(G2Y, Bsz), gqy)
    gq_inf = x_eq & ~y_eq

    u1 = u1w.to(torch.int64) & 0xFFFFFFFF
    u2 = u2w.to(torch.int64) & 0xFFFFFFFF
    zero = torch.zeros((Bsz, LIMBS), dtype=torch.int64, device=dev)
    X, Y, Z = zero, zero, zero
    inf = torch.ones(Bsz, dtype=torch.bool, device=dev)
    bad = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    for pos in range(255, -1, -1):
        X, Y, Z = _pt_double(F, X, Y, Z)
        w, s = pos // 32, pos % 32
        b1 = ((u1[:, w] >> s) & 1).bool()
        b2 = ((u2[:, w] >> s) & 1).bool()
        both = (b1 & b2)[:, None]
        q_only = b2[:, None]
        ax = torch.where(both, gqx, torch.where(q_only, x, gx))
        ay = torch.where(both, gqy, torch.where(q_only, y, gy))
        X, Y, Z, inf, coll = _mixed_add(F, X, Y, Z, inf, ax, ay,
                                        b1 & b2 & gq_inf, b1 | b2)
        bad = bad | coll
    flags = torch.stack([inf, bad, residue], dim=-1).to(torch.uint8)
    return torch.cat([_pack(F.canon(X)), _pack(F.canon(Y)),
                      _pack(F.canon(Z)), flags], dim=1)


def _check_inputs(x_bytes, parity, u1w, u2w) -> int:
    B = x_bytes.shape[0]
    want = ((x_bytes, (B, 33), torch.uint8), (parity, (B,), torch.int32),
            (u1w, (B, 8), torch.int32), (u2w, (B, 8), torch.int32))
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"recover_kernel: expected {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x_bytes.device:
            raise ValueError("recover_kernel: inputs on different devices")
    return B


def recover_kernel(x_bytes: torch.Tensor, parity: torch.Tensor,
                   u1w: torch.Tensor, u2w: torch.Tensor) -> torch.Tensor:
    """Recovery ladder over a batch: the CUDA kernel for CUDA tensors
    (asynchronous on the current stream), the plain version for CPU
    tensors.  Returns (B, 102) uint8 on the inputs' device."""
    B = _check_inputs(x_bytes, parity, u1w, u2w)
    dev = x_bytes.device
    if dev.type == "cpu":
        return recover_kernel_plain(x_bytes, parity, u1w, u2w)
    if dev.type != "cuda":
        raise ValueError(f"recover_kernel: unsupported device {dev}")
    global LAUNCHES
    lib = kernels.load("secp_recover")
    args = [t.contiguous() for t in (x_bytes, parity, u1w, u2w)]
    out = torch.empty((B, 102), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.secp_recover_launch(*(t.data_ptr() for t in args),
                                 out.data_ptr(), B, stream)
    kernels.check(rc, "secp_recover")
    LAUNCHES += 1
    return out


def kernel_design() -> dict:
    """The built kernel's group width ``g`` (threads a signature) and its
    block size in threads."""
    import ctypes
    lib = kernels.load("secp_recover")
    g, block = ctypes.c_int(), ctypes.c_int()
    lib.secp_recover_info(ctypes.byref(g), ctypes.byref(block))
    return {"g": g.value, "block": block.value}


# ------------------------------------------------ sharded ladder (K8r)
# Port of reference parallel/mesh.py:202 sharded_recover: the batch
# splits into n contiguous equal slices (the reference's PS("dp")), and
# each shard runs the ladder on its slice with no collective.  On one
# card a shard is K2's kernel on its own CUDA stream, forked from the
# current stream and joined back with events.

SHARD_LAUNCHES = 0


def sharded_recover_plain(x_bytes, parity, u1w, u2w, n: int) -> torch.Tensor:
    """Plain version of the sharded ladder: ``recover_kernel_plain`` on
    each of the n slices, the rows concatenated."""
    B = x_bytes.shape[0]
    m = B // n
    return torch.cat([recover_kernel_plain(x_bytes[i:i + m], parity[i:i + m],
                                           u1w[i:i + m], u2w[i:i + m])
                      for i in range(0, B, m)])


def sharded_recover(mesh):
    """The recovery ladder over ``mesh.n_shards`` slices of the batch
    (the reference's ``sharded_recover(mesh)``): returns a function with
    ``recover_kernel``'s signature.  On CUDA tensors it launches K2 once
    per slice, each on its own stream (``SHARD_LAUNCHES`` counts the
    sharded calls); on CPU tensors it runs the plain version.  The batch
    must divide by the width."""
    n = mesh.n_shards
    streams = {}     # device -> the shards' streams, made at first use

    def recover(x_bytes, parity, u1w, u2w):
        global SHARD_LAUNCHES
        B = _check_inputs(x_bytes, parity, u1w, u2w)
        if B % n:
            raise ValueError(f"sharded_recover: a batch of {B} does not "
                             f"divide by {n} shards")
        dev = x_bytes.device
        if dev.type == "cpu":
            return sharded_recover_plain(x_bytes, parity, u1w, u2w, n)
        if dev.type != "cuda":
            raise ValueError(f"sharded_recover: unsupported device {dev}")
        args = [t.contiguous() for t in (x_bytes, parity, u1w, u2w)]
        main = torch.cuda.current_stream(dev)
        fork = torch.cuda.Event()
        fork.record(main)
        m = B // n
        outs = []
        if dev not in streams:
            streams[dev] = [torch.cuda.Stream(dev) for _ in range(n)]
        for i, s in enumerate(streams[dev]):
            s.wait_event(fork)
            with torch.cuda.stream(s):
                part = [t[i * m:(i + 1) * m] for t in args]
                out = recover_kernel(*part)
                for t in part:
                    t.record_stream(s)
                out.record_stream(main)
                done = torch.cuda.Event()
                done.record(s)
            main.wait_event(done)
            outs.append(out)
        SHARD_LAUNCHES += 1
        return torch.cat(outs)
    return recover
