"""secp256k1 ECDSA — host reference implementation.

Role parity with the reference's cgo libsecp256k1 binding (geth
crypto/secp256k1, used by types.Sender for every transaction and by the
ecrecover precompile, reference core/vm/contracts.go:60).  The pure-Python
code here is the correctness anchor; a C++ native fast path (native/
secp256k1.cc, batched recovery) is installed by coreth_tpu_torch.crypto.native.

Signing is RFC6979-deterministic (same scheme libsecp256k1 uses), with
Ethereum's low-s normalization (EIP-2) and 0/1 recovery ids.
"""

from __future__ import annotations

import hashlib
import hmac

from coreth_tpu_torch.crypto.keccak import keccak256

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

# ---------------------------------------------------------------------------
# Jacobian point arithmetic (None = point at infinity)


def _jac_double(pt):
    if pt is None:
        return None
    x, y, z = pt
    if y == 0:
        return None
    ysq = (y * y) % P
    s = (4 * x * ysq) % P
    m = (3 * x * x) % P  # a = 0 for secp256k1
    nx = (m * m - 2 * s) % P
    ny = (m * (s - nx) - 8 * ysq * ysq) % P
    nz = (2 * y * z) % P
    return (nx, ny, nz)


def _jac_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1sq = (z1 * z1) % P
    z2sq = (z2 * z2) % P
    u1 = (x1 * z2sq) % P
    u2 = (x2 * z1sq) % P
    s1 = (y1 * z2sq * z2) % P
    s2 = (y2 * z1sq * z1) % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jac_double(p1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hsq = (h * h) % P
    hcu = (hsq * h) % P
    v = (u1 * hsq) % P
    nx = (r * r - hcu - 2 * v) % P
    ny = (r * (v - nx) - s1 * hcu) % P
    nz = (h * z1 * z2) % P
    return (nx, ny, nz)


def _jac_mul(pt, k: int):
    k %= N
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return acc


# Fixed-base acceleration for G: 8-bit windows of precomputed multiples,
# built lazily on first signature (32 windows x 255 points).  Signing and
# pubkey derivation drop from ~256 doublings to ~32 additions.
_G_WINDOWS = None


def _g_windows():
    global _G_WINDOWS
    if _G_WINDOWS is None:
        windows = []
        base = (Gx, Gy, 1)
        for _ in range(32):
            row = [None] * 256
            acc = None
            for j in range(1, 256):
                acc = _jac_add(acc, base)
                row[j] = acc
            windows.append(row)
            # base <<= 8
            for _ in range(8):
                base = _jac_double(base)
        _G_WINDOWS = windows
    return _G_WINDOWS


def _g_mul(k: int):
    """k*G via the fixed-base window table."""
    k %= N
    windows = _g_windows()
    acc = None
    i = 0
    while k:
        byte = k & 0xFF
        if byte:
            acc = _jac_add(acc, windows[i][byte])
        k >>= 8
        i += 1
    return acc


def _to_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zinv = pow(z, P - 2, P)
    zinv2 = (zinv * zinv) % P
    return ((x * zinv2) % P, (y * zinv2 * zinv) % P)


# ---------------------------------------------------------------------------
# RFC6979 deterministic nonce (SHA-256)


def _rfc6979_k(priv: int, msg_hash: bytes) -> int:
    x = priv.to_bytes(32, "big")
    h1 = (int.from_bytes(msg_hash, "big") % N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# ---------------------------------------------------------------------------
# Public API


def pubkey(priv: int) -> tuple[int, int]:
    pt = _to_affine(_g_mul(priv))
    assert pt is not None
    return pt


def pubkey_to_address(pub: tuple[int, int]) -> bytes:
    raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    return keccak256(raw)[12:]


def priv_to_address(priv: int) -> bytes:
    return pubkey_to_address(pubkey(priv))


def sign(msg_hash: bytes, priv: int) -> tuple[int, int, int]:
    """Sign a 32-byte hash.  Returns (r, s, recid) with low-s and recid in {0,1}."""
    z = int.from_bytes(msg_hash, "big")
    while True:
        k = _rfc6979_k(priv, msg_hash)
        R = _to_affine(_g_mul(k))
        assert R is not None
        r = R[0] % N
        if r == 0:
            continue
        s = (pow(k, N - 2, N) * ((z + r * priv) % N)) % N
        if s == 0:
            continue
        recid = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > N // 2:  # EIP-2 low-s
            s = N - s
            recid ^= 1
        return r, s, recid


def recover_pubkey(msg_hash: bytes, r: int, s: int, recid: int) -> tuple[int, int]:
    """Recover the signer's public key.  Raises ValueError on invalid input.

    Matches libsecp256k1 ecdsa_recover semantics (reference
    crypto.SigToPub / the ecrecover precompile): requires 0 < r,s < N.
    """
    if not (0 < r < N and 0 < s < N and 0 <= recid <= 3):
        raise ValueError("invalid signature values")
    x = r + N if recid & 2 else r
    if x >= P:
        raise ValueError("r out of field range")
    ysq = (pow(x, 3, P) + B) % P
    y = pow(ysq, (P + 1) // 4, P)
    if (y * y) % P != ysq:
        raise ValueError("r is not an x coordinate on the curve")
    if (y & 1) != (recid & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    rinv = pow(r, N - 2, N)
    u1 = (-z * rinv) % N
    u2 = (s * rinv) % N
    Q = _jac_add(_g_mul(u1), _jac_mul((x, y, 1), u2))
    pt = _to_affine(Q)
    if pt is None:
        raise ValueError("recovered point at infinity")
    return pt


def recover_address_py(msg_hash: bytes, r: int, s: int, recid: int) -> bytes:
    return pubkey_to_address(recover_pubkey(msg_hash, r, s, recid))


def _bootstrap_recover(msg_hash: bytes, r: int, s: int,
                       recid: int) -> bytes:
    """First call: install the C++ fast path, else stay on Python."""
    from coreth_tpu_torch.crypto import native
    if not native.install():
        set_recover_impl(recover_address_py)
    return _recover_impl(msg_hash, r, s, recid)


# Resolved on first use, so importing this module builds nothing.
_recover_impl = _bootstrap_recover


def recover_address(msg_hash: bytes, r: int, s: int, recid: int) -> bytes:
    return _recover_impl(msg_hash, r, s, recid)


def set_recover_impl(fn) -> None:
    global _recover_impl
    _recover_impl = fn
