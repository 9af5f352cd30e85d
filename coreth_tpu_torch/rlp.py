"""RLP (Recursive Length Prefix) codec.

Behavioral twin of the geth ``rlp`` package the reference imports everywhere
(trie node encoding trie/committer.go, tx/header/receipt serialization
core/types/*, DeriveSha core/types/hashing.go).  Items are ``bytes`` or
(nested) lists of items; integers are encoded big-endian with no leading
zeros (the caller uses :func:`encode_uint`).
"""

from __future__ import annotations

from typing import Union

Item = Union[bytes, list]


def encode_uint(value: int) -> bytes:
    """Canonical integer -> byte-string payload (empty for zero)."""
    if value == 0:
        return b""
    length = (value.bit_length() + 7) // 8
    return value.to_bytes(length, "big")


def decode_uint(data: bytes) -> int:
    if data[:1] == b"\x00":
        raise ValueError("leading zero in canonical RLP integer")
    return int.from_bytes(data, "big")


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    blen = encode_uint(length)
    return bytes([offset + 55 + len(blen)]) + blen


def encode(item: Item) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    if isinstance(item, int):
        return encode(encode_uint(item))
    raise TypeError(f"cannot RLP-encode {type(item)!r}")


def _decode_at(data: bytes, pos: int):
    """Decode one item at pos, return (item, next_pos)."""
    if pos >= len(data):
        raise ValueError("RLP input too short")
    b0 = data[pos]
    if b0 < 0x80:
        return bytes([b0]), pos + 1
    if b0 < 0xB8:  # short string
        length = b0 - 0x80
        end = pos + 1 + length
        s = data[pos + 1:end]
        if len(s) != length:
            raise ValueError("RLP string truncated")
        if length == 1 and s[0] < 0x80:
            raise ValueError("non-canonical single byte")
        return s, end
    if b0 < 0xC0:  # long string
        lenlen = b0 - 0xB7
        length = decode_uint(data[pos + 1:pos + 1 + lenlen])
        if length < 56:
            raise ValueError("non-canonical long string length")
        start = pos + 1 + lenlen
        end = start + length
        if end > len(data):
            raise ValueError("RLP string truncated")
        return data[start:end], end
    if b0 < 0xF8:  # short list
        length = b0 - 0xC0
        end = pos + 1 + length
        items = []
        cur = pos + 1
        while cur < end:
            item, cur = _decode_at(data, cur)
            items.append(item)
        if cur != end:
            raise ValueError("RLP list payload overrun")
        return items, end
    # long list
    lenlen = b0 - 0xF7
    length = decode_uint(data[pos + 1:pos + 1 + lenlen])
    if length < 56:
        raise ValueError("non-canonical long list length")
    start = pos + 1 + lenlen
    end = start + length
    if end > len(data):
        raise ValueError("RLP list truncated")
    items = []
    cur = start
    while cur < end:
        item, cur = _decode_at(data, cur)
        items.append(item)
    if cur != end:
        raise ValueError("RLP list payload overrun")
    return items, end


def decode(data: bytes) -> Item:
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise ValueError("trailing bytes after RLP item")
    return item
