"""Linear-codec wire format for atomic transactions.

Port of reference ``wire.py``, byte for byte the same format.

Follows the avalanchego linearcodec/wrappers layout the reference
registers in plugin/evm/codec.go: a u16 codec version, a u32 type id
for interface values, then struct fields in declaration order —
fixed-width big-endian ints, 32-byte ids raw, variable byte strings
u32-length-prefixed, slices u32-count-prefixed.  Type ids 0/1 =
UnsignedImportTx/UnsignedExportTx (the registration order in
codec.go), 2+ = fx types in secp256k1fx registration order.
"""

from __future__ import annotations

import struct

CODEC_VERSION = 0

TYPE_IMPORT_TX = 0
TYPE_EXPORT_TX = 1
TYPE_SECP_TRANSFER_INPUT = 2
TYPE_SECP_TRANSFER_OUTPUT = 3
TYPE_SECP_CREDENTIAL = 4


class Packer:
    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int):
        self.buf += struct.pack(">B", v)

    def u16(self, v: int):
        self.buf += struct.pack(">H", v)

    def u32(self, v: int):
        self.buf += struct.pack(">I", v)

    def u64(self, v: int):
        self.buf += struct.pack(">Q", v)

    def fixed(self, b: bytes, n: int):
        if len(b) != n:
            raise ValueError(f"expected {n} bytes, got {len(b)}")
        self.buf += b

    def var_bytes(self, b: bytes):
        self.u32(len(b))
        self.buf += b

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Unpacker:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("short buffer")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def fixed(self, n: int) -> bytes:
        return self._take(n)

    def var_bytes(self) -> bytes:
        return self._take(self.u32())

    def done(self) -> bool:
        return self.off == len(self.data)
