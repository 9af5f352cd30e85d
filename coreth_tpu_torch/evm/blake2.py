"""BLAKE2b compression function F (EIP-152, RFC 7693).

Backs the 0x09 precompile (reference core/vm/contracts.go blake2F).
"""

from __future__ import annotations

import struct

MASK64 = (1 << 64) - 1

IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def blake2f_compress(rounds: int, h: list, m: list, t: tuple,
                     final: bool) -> list:
    """One F invocation: h (8 u64), m (16 u64), t (2 u64 counters)."""
    v = h[:8] + IV[:8]
    v[12] ^= t[0]
    v[13] ^= t[1]
    if final:
        v[14] ^= MASK64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & MASK64
        v[d] = _rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & MASK64
        v[b] = _rotr(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & MASK64
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & MASK64
        v[b] = _rotr(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [(h[i] ^ v[i] ^ v[i + 8]) & MASK64 for i in range(8)]


def blake2f_precompile(input_: bytes):
    """EIP-152 wire format -> output bytes, or None on malformed input."""
    if len(input_) != 213:
        return None
    rounds = struct.unpack(">I", input_[0:4])[0]
    final_byte = input_[212]
    if final_byte not in (0, 1):
        return None
    h = list(struct.unpack("<8Q", input_[4:68]))
    m = list(struct.unpack("<16Q", input_[68:196]))
    t = struct.unpack("<2Q", input_[196:212])
    out = blake2f_compress(rounds, h, m, t, final_byte == 1)
    return struct.pack("<8Q", *out)
