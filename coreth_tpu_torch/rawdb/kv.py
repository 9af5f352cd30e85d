"""Durable key-value store.

Port of reference ``rawdb/kv.py``, the role of leveldb/pebble under
geth's ethdb: an append-only log file with an in-memory index, rebuilt
on open.  Records are
[u32 klen][u32 vlen][key][value]; vlen == 0xFFFFFFFF marks a
tombstone.  A torn tail record (crash mid-write) is truncated away on
open, so every committed batch before the crash survives intact.
compact() rewrites the live set when garbage accumulates.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Iterator, Optional, Tuple

_TOMB = 0xFFFFFFFF
_HDR = struct.Struct("<II")


class KVStore:
    """Interface: dict-like over bytes keys/values + close/flush."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def __contains__(self, key: bytes) -> bool:
        return self.get(key) is not None

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemDB(KVStore):
    """In-memory store (memdb role)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}

    def get(self, key):
        return self._data.get(key)

    def put(self, key, value):
        self._data[key] = bytes(value)

    def delete(self, key):
        self._data.pop(key, None)

    def items(self):
        return iter(list(self._data.items()))


class FileDB(KVStore):
    """Append-only-log store with crash-safe reopen."""

    def __init__(self, path: str):
        self.path = path
        self._index: Dict[bytes, bytes] = {}
        self._garbage = 0
        # put() frames a record as three file writes; the checkpoint
        # exporter's thread and the execute thread (write-through code
        # dict) both write, so framing must be atomic per record
        self._wlock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._recover()
        self._f = open(path, "ab")

    def _recover(self) -> None:
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        n = len(data)
        while off + _HDR.size <= n:
            klen, vlen = _HDR.unpack_from(data, off)
            body = vlen if vlen != _TOMB else 0
            end = off + _HDR.size + klen + body
            if end > n:
                break  # torn tail record
            key = data[off + _HDR.size:off + _HDR.size + klen]
            if vlen == _TOMB:
                if self._index.pop(key, None) is not None:
                    self._garbage += 1
            else:
                if key in self._index:
                    self._garbage += 1
                self._index[key] = data[off + _HDR.size + klen:end]
            off = end
            good = end
        if good != n:
            with open(self.path, "r+b") as f:
                f.truncate(good)

    def get(self, key):
        return self._index.get(key)

    def put(self, key, value):
        with self._wlock:
            if key in self._index:
                self._garbage += 1
            self._index[key] = bytes(value)
            self._f.write(_HDR.pack(len(key), len(value)))
            self._f.write(key)
            self._f.write(value)

    def delete(self, key):
        with self._wlock:
            if self._index.pop(key, None) is None:
                return
            self._garbage += 1
            self._f.write(_HDR.pack(len(key), _TOMB))
            self._f.write(key)

    def items(self):
        return iter(list(self._index.items()))

    def flush(self):
        with self._wlock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self):
        self.flush()
        with self._wlock:
            self._f.close()

    def compact(self) -> None:
        """Rewrite only the live set (freezer-lite)."""
        with self._wlock:
            tmp = self.path + ".compact"
            with open(tmp, "wb") as f:
                for k, v in self._index.items():
                    f.write(_HDR.pack(len(k), len(v)))
                    f.write(k)
                    f.write(v)
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._garbage = 0
            self._f = open(self.path, "ab")
