"""Keccak-256 — host reference implementation.

Ethereum uses the *original* Keccak padding (delimited suffix 0x01), not the
NIST SHA-3 suffix (0x06), so :mod:`hashlib`'s sha3_256 cannot be used.

This is the correctness anchor for the whole framework: trie hashing
(reference trie/hasher.go:195 hashData), tx/receipt roots (reference
core/types/hashing.go:97 DeriveSha), CREATE2 addresses, secure-trie key
hashing, and the SHA3 opcode all bottom out here.

Structure follows the Keccak team's public-domain CompactFIPS202 Python
(round constants derived by LFSR rather than hard-coded, eliminating a class
of transcription bugs).  A C++ native fast path lives in native/keccak.cc and
is preferred automatically when built (see coreth_tpu_torch.crypto.native).
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _rol(v: int, n: int) -> int:
    n &= 63
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes):
    """Permute a 5x5 list-of-lists of 64-bit lanes; returns the new state
    (the input list must not be reused afterwards)."""
    R = 1
    for _round in range(24):
        # theta
        C = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        D = [C[(x + 4) % 5] ^ _rol(C[(x + 1) % 5], 1) for x in range(5)]
        lanes = [[lanes[x][y] ^ D[x] for y in range(5)] for x in range(5)]
        # rho and pi
        x, y = 1, 0
        current = lanes[x][y]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            current, lanes[x][y] = lanes[x][y], _rol(current, (t + 1) * (t + 2) // 2)
        # chi
        for y in range(5):
            T = [lanes[x][y] for x in range(5)]
            for x in range(5):
                lanes[x][y] = T[x] ^ ((~T[(x + 1) % 5]) & T[(x + 2) % 5] & _MASK)
        # iota
        for j in range(7):
            R = ((R << 1) ^ ((R >> 7) * 0x71)) % 256
            if R & 2:
                lanes[0][0] ^= 1 << ((1 << j) - 1)
    return lanes


def _keccak(rate_bytes: int, suffix: int, data: bytes, out_len: int) -> bytes:
    lanes = [[0] * 5 for _ in range(5)]

    def absorb_block(block: bytes) -> None:
        for i in range(rate_bytes // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            lanes[i % 5][i // 5] ^= lane

    # absorb full blocks
    off = 0
    n = len(data)
    while n - off >= rate_bytes:
        absorb_block(data[off:off + rate_bytes])
        lanes = keccak_f1600(lanes)
        off += rate_bytes
    # pad10*1 with the keccak suffix
    block = bytearray(data[off:])
    block.append(suffix)
    block.extend(b"\x00" * (rate_bytes - len(block)))
    block[-1] ^= 0x80
    absorb_block(bytes(block))
    lanes = keccak_f1600(lanes)
    # squeeze (out_len <= rate for all our uses)
    out = bytearray()
    for i in range(rate_bytes // 8):
        out.extend(lanes[i % 5][i // 5].to_bytes(8, "little"))
        if len(out) >= out_len:
            break
    return bytes(out[:out_len])


def keccak256_py(data: bytes) -> bytes:
    """Pure-python keccak-256 (rate 136, suffix 0x01)."""
    return _keccak(136, 0x01, data, 32)


def _bootstrap(data: bytes) -> bytes:
    """First call: install the C++ fast path (building the native
    library if needed), else stay on the pure-Python path."""
    from coreth_tpu_torch.crypto import native
    if not native.install():
        set_impl(keccak256_py)
    return _impl(data)


# Resolved on first use, so importing this module builds nothing.
_impl = _bootstrap


def keccak256(data: bytes) -> bytes:
    return _impl(data)


def set_impl(fn) -> None:
    global _impl
    _impl = fn


def keccak256_many(msgs) -> list:
    """Digests for a batch of messages in ONE native call
    (``coreth_keccak256_batch``).  The fused OCC window's premap
    predictor hashes every predicted (source word || slot) pair of a
    window through this: one ctypes crossing per window instead of one
    keccak call per candidate key."""
    msgs = list(msgs)
    if not msgs:
        return []
    from coreth_tpu_torch.crypto import native
    if len(msgs) == 1:
        return [keccak256(msgs[0])]
    stride = max(len(m) for m in msgs)
    blob = b"".join(m.ljust(stride, b"\x00") for m in msgs)
    out = native.keccak256_batch(blob, [len(m) for m in msgs], stride)
    return [out[32 * i:32 * i + 32] for i in range(len(msgs))]


EMPTY_KECCAK = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")

