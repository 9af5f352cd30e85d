"""ctypes bridge to the repo's C++ host runtime (native/libcoreth_native.so).

The port's own copy of the reference loader, cut to the symbols the
port calls: keccak-256 (single and batched), batched secp256k1 recovery
(and the prep/finish halves around the device ladder), and the
receipt-root fold.  The library is built lazily by
``coreth_tpu_torch.nativebuild``; every caller here needs it, so a
missing library raises.
"""

from __future__ import annotations

import ctypes
import threading

from coreth_tpu_torch import nativebuild

_lib = None
_lock = threading.Lock()


def load():
    """Load (building first if needed) the native library, or None."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = nativebuild.ensure_built()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.coreth_keccak256.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
        lib.coreth_keccak256.restype = None
        lib.coreth_keccak256_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
        lib.coreth_keccak256_batch.restype = None
        lib.coreth_ecrecover.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_char_p]
        lib.coreth_ecrecover.restype = ctypes.c_int
        lib.coreth_ecrecover_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_char_p]
        lib.coreth_ecrecover_batch.restype = None
        lib.coreth_recover_prep.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.coreth_recover_prep.restype = None
        lib.coreth_recover_finish.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.coreth_recover_finish.restype = None
        lib.coreth_receipt_root.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.coreth_receipt_root.restype = None
        _lib = lib
        return _lib


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(
            "coreth native library unavailable: `make -C native` failed "
            "(no C++ toolchain?)")
    return lib


def keccak256_native(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    _require().coreth_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(data: bytes, lens, stride: int) -> bytes:
    """Batched fixed-stride keccak-256: item i occupies
    ``data[i*stride : i*stride + lens[i]]``.  Returns the packed
    32-byte digests."""
    n = len(lens)
    arr = (ctypes.c_uint64 * n)(*lens)
    out = ctypes.create_string_buffer(32 * n)
    _require().coreth_keccak256_batch(data, arr, stride, n, out)
    return out.raw


def recover_address_native(msg_hash: bytes, r: int, s: int,
                           recid: int) -> bytes:
    out = ctypes.create_string_buffer(20)
    ok = _require().coreth_ecrecover(
        msg_hash, r.to_bytes(32, "big"), s.to_bytes(32, "big"), recid, out)
    if not ok:
        raise ValueError("invalid signature values")
    return out.raw


def recover_addresses_batch(hashes: bytes, rs: bytes, ss: bytes,
                            recids: bytes):
    """Batched recovery over packed buffers.  Returns (addresses, ok)."""
    n = len(recids)
    if len(hashes) != 32 * n or len(rs) != 32 * n or len(ss) != 32 * n:
        raise ValueError("packed signature buffers disagree with n")
    out = ctypes.create_string_buffer(20 * n)
    ok = ctypes.create_string_buffer(n)
    _require().coreth_ecrecover_batch(hashes, rs, ss, recids, n, out, ok)
    return out.raw, ok.raw


def recover_prep(hashes: bytes, rs: bytes, ss: bytes, recids: bytes):
    """C++ host prep for the device recovery kernel: range checks, the
    x coordinate, and u1/u2 via one Montgomery batch inversion.
    Returns (xs_le33, u1_le32, u2_le32, ok) packed bytes; rejected rows
    carry x = u1 = u2 = 0 and ok = 0."""
    n = len(recids)
    if len(hashes) != 32 * n or len(rs) != 32 * n or len(ss) != 32 * n:
        raise ValueError("packed signature buffers disagree with n")
    xs = ctypes.create_string_buffer(33 * n)
    u1 = ctypes.create_string_buffer(32 * n)
    u2 = ctypes.create_string_buffer(32 * n)
    ok = ctypes.create_string_buffer(n)
    _require().coreth_recover_prep(hashes, rs, ss, recids, n, xs, u1, u2,
                                   ok)
    return xs.raw, u1.raw, u2.raw, ok.raw


def recover_finish(rows: bytes, n: int, ok_in: bytes):
    """C++ finish for the device recovery kernel: batched Jacobian ->
    affine + keccak address derivation over the (n, 102) kernel rows.
    Returns (addrs, ok) where ok[i] == 2 marks ladder-collision rows
    the caller re-runs on the exact host path."""
    if len(rows) != 102 * n or len(ok_in) != n:
        raise ValueError("recover rows disagree with n")
    out = ctypes.create_string_buffer(20 * n)
    ok = ctypes.create_string_buffer(n)
    _require().coreth_recover_finish(rows, n, ok_in, out, ok)
    return out.raw, ok.raw


def receipt_root(cum_gas, tx_types: bytes, has_log: bytes,
                 log_blob: bytes):
    """Receipt-trie root + header bloom for a device-path block in one
    C++ call.  Receipts are status-1 with 0 or 1 Transfer-shaped log
    (addr20 ++ 3*topic32 ++ data32 = 148B).  Returns (root32, bloom256)."""
    n = len(tx_types)
    if len(has_log) != n or len(cum_gas) != n \
            or len(log_blob) != 148 * sum(has_log):
        raise ValueError("receipt buffers disagree with n")
    cg = (ctypes.c_uint64 * n)(*cum_gas)
    root = ctypes.create_string_buffer(32)
    bloom = ctypes.create_string_buffer(256)
    _require().coreth_receipt_root(cg, tx_types, has_log, log_blob, n,
                                   root, bloom)
    return root.raw, bloom.raw


def install() -> bool:
    """Route the pure-Python keccak/recover entry points through C++."""
    if load() is None:
        return False
    from coreth_tpu_torch.crypto import keccak as _k
    from coreth_tpu_torch.crypto import secp256k1 as _s
    _k.set_impl(keccak256_native)
    _s.set_recover_impl(recover_address_native)
    return True
