"""ctypes boundary to the native hostexec session (native/evm.cc).

Port of reference ``evm/hostexec/backend.py``, loaded through the port's
own native loader (``crypto/native.py``).  One ``HostExecBackend`` wraps
one C++ session: registered contract codes, a committed-storage cache
fed by a Python resolver callback, and per-call outputs (status / gas /
refund / logs / writes / return data).  The caller decides when cached
storage is stale (``clear_storage``, ``reset_contracts``) and when a
call's writes become the next call's committed base (``commit``): the
chain builder and the serial short-circuit (``replay/machine_block``)
carry state call by call, the StateDB bridge (``evm/hostexec/bridge``)
takes a fresh view per tx unless nothing outside it moved the state.

A session that cannot be had (the library missing, or without the
session ABI, or the session not created) raises :class:`SessionError`:
the fault the supervisor's ``native`` scope strikes on, with the
injected ``native/error_rc`` point (``PT_ERROR_RC``, fired at every
call).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Tuple

from coreth_tpu_torch import faults
from coreth_tpu_torch.crypto import native
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.hostexec.eligibility import (
    REFUND_FORKS, native_optable,
)

_FETCH_SLOT = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8))
_FETCH_CODE = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8))

_declared = False

# Injection point: the session returns an error rc mid-call (the ABI's
# failure mode for a corrupted session).  Armed plans raise here; the
# bridge and the serial short-circuit both treat it as a per-tx escape
# plus a native-scope strike.
PT_ERROR_RC = faults.declare(
    "native/error_rc", "hostexec session call returns a fault rc")


class SessionError(RuntimeError):
    """The native hostexec session is unavailable or failed."""


def _lib():
    """The native library with the hostexec ABI declared; raises when
    the library is missing or predates the session symbols."""
    global _declared
    lib = native.load()
    if lib is None:
        raise SessionError("coreth native library unavailable")
    if not hasattr(lib, "coreth_hostexec_new"):
        raise SessionError("native library lacks the hostexec session ABI")
    if _declared:
        return lib
    P, C = ctypes.c_void_p, ctypes.c_char_p
    u64 = ctypes.c_uint64
    sig = {
        "coreth_hostexec_new": ([u64, _FETCH_SLOT, _FETCH_CODE, C,
                                 ctypes.c_int], P),
        "coreth_hostexec_free": ([P], None),
        "coreth_hostexec_env": ([P, C, u64, u64, u64, u64, C], None),
        "coreth_hostexec_set_code": ([P, C, C, ctypes.c_uint32], None),
        "coreth_hostexec_clear_storage": ([P], None),
        "coreth_hostexec_reset": ([P], None),
        "coreth_hostexec_reset_kinds": ([P], None),
        "coreth_hostexec_seed_slot": ([P, C, C, C], None),
        "coreth_hostexec_warm_addr": ([P, C], None),
        "coreth_hostexec_warm_slot": ([P, C, C], None),
        "coreth_hostexec_call": ([P, C, C, C, C, C, ctypes.c_uint32,
                                  ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64)],
                                 ctypes.c_int),
        "coreth_hostexec_out_writes": ([P, C, C, C], None),
        "coreth_hostexec_out_logs": ([P, C, ctypes.POINTER(ctypes.c_int32),
                                      C, ctypes.POINTER(ctypes.c_int32), C],
                                     None),
        "coreth_hostexec_out_ret": ([P, C], None),
        "coreth_hostexec_commit": ([P], None),
    }
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _declared = True
    return lib


class NativeCallResult:
    """One native tx execution: machine-coded status + writeback set."""

    __slots__ = ("status", "gas_left", "refund", "writes", "logs",
                 "ret", "host_reason")

    def __init__(self, status: int, gas_left: int, refund: int,
                 writes: Dict[Tuple[bytes, bytes], bytes],
                 logs: List[Tuple[bytes, List[bytes], bytes]],
                 ret: bytes, host_reason: int):
        self.status = status          # M.STOP / M.REVERT / M.ERR / M.HOST
        self.gas_left = gas_left
        self.refund = refund
        self.writes = writes          # (contract, masked key) -> value32
        self.logs = logs              # (address, topics, data), in order
        self.ret = ret
        self.host_reason = host_reason

    @property
    def needs_host(self) -> bool:
        return self.status == M.HOST


class HostExecBackend:
    """One native session bound to resolver callbacks.

    slot_resolver(contract20, masked_key32) -> 32-byte committed value.
    code_resolver(addr20) -> runtime bytecode, b"" for a known EOA, or
    None when the session cannot take the callee (precompile, existing
    but empty account, ineligible bytecode): the call returns HOST."""

    def __init__(self, fork: str, chain_id: int,
                 slot_resolver: Callable[[bytes, bytes], bytes],
                 code_resolver: Callable[[bytes], Optional[bytes]]):
        lib = _lib()
        self._lib = lib
        self.fork = fork
        self._registered: Dict[bytes, bytes] = {}
        # a resolver exception cannot unwind through the C stack: it is
        # parked here and re-raised when the call returns
        self._cb_error: Optional[BaseException] = None

        def _fetch(addr_p, key_p, out_p):
            try:
                v = slot_resolver(bytes(addr_p[:20]), bytes(key_p[:32]))
            except Exception as exc:  # noqa: BLE001 — re-raised after the call
                self._cb_error = exc
                return 0
            for i in range(32):
                out_p[i] = v[i]
            return 1

        def _code(addr_p):
            addr = bytes(addr_p[:20])
            try:
                code = code_resolver(addr)
            except Exception as exc:  # noqa: BLE001 — re-raised after the call
                self._cb_error = exc
                return -1
            if code is None:
                return -1
            if not code:
                return 0
            self.set_code(addr, code)
            return 1

        # the CFUNCTYPE trampolines must outlive the session
        self._fetch_cb = _FETCH_SLOT(_fetch)
        self._code_cb = _FETCH_CODE(_code)
        self._h = lib.coreth_hostexec_new(
            chain_id, self._fetch_cb, self._code_cb,
            native_optable(fork), 1 if fork in REFUND_FORKS else 0)
        if not self._h:
            self._h = None
            raise SessionError("coreth_hostexec_new returned no session")

    def close(self) -> None:
        if self._h is not None:
            self._lib.coreth_hostexec_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown may have dropped ctypes already
            pass

    def set_env(self, coinbase: bytes, timestamp: int, number: int,
                gas_limit: int, base_fee: int, difficulty: int = 1) -> None:
        self._lib.coreth_hostexec_env(
            self._h, coinbase, timestamp, number, gas_limit, difficulty,
            (base_fee or 0).to_bytes(32, "big"))

    def set_code(self, addr: bytes, code: bytes) -> None:
        if self._registered.get(addr) == code:
            return
        self._lib.coreth_hostexec_set_code(self._h, addr, code, len(code))
        self._registered[addr] = code

    def clear_storage(self) -> None:
        """Drop the committed-slot cache (underlying state moved)."""
        self._lib.coreth_hostexec_clear_storage(self._h)

    def reset_contracts(self) -> None:
        """Drop codes, EOA/contract kinds AND storage: per-tx hygiene
        for the StateDB bridge, where a mid-block deploy can change
        what an address resolves to between txs."""
        self._lib.coreth_hostexec_reset(self._h)
        self._registered.clear()

    def reset_eoa_kinds(self) -> None:
        """Drop ONLY cached EOA verdicts: existence/emptiness
        transitions happen through pure balance moves the bridge's
        storage generation cannot see, so EOA callees re-resolve while
        contract code/storage caches survive."""
        self._lib.coreth_hostexec_reset_kinds(self._h)

    def seed_slot(self, contract: bytes, key: bytes, value: bytes) -> None:
        """Install a committed value (OCC prefix overlay)."""
        self._lib.coreth_hostexec_seed_slot(self._h, contract, key, value)

    def commit(self) -> None:
        """Fold the last call's writes into the committed cache."""
        self._lib.coreth_hostexec_commit(self._h)

    def call(self, caller: bytes, to: bytes, value: int, gas_price: int,
             data: bytes, gas: int, warm_addrs=(),
             warm_slots=()) -> NativeCallResult:
        faults.fire(PT_ERROR_RC)
        lib = self._lib
        for a in warm_addrs:
            lib.coreth_hostexec_warm_addr(self._h, a)
        for a, k in warm_slots:
            lib.coreth_hostexec_warm_slot(self._h, a, k)
        out = (ctypes.c_int64 * 7)()
        status = lib.coreth_hostexec_call(
            self._h, caller, to, value.to_bytes(32, "big"),
            gas_price.to_bytes(32, "big"), data, len(data), gas, out)
        if self._cb_error is not None:
            exc, self._cb_error = self._cb_error, None
            raise exc
        n_writes, n_logs = int(out[2]), int(out[3])
        log_data_total, ret_len = int(out[4]), int(out[5])
        writes: Dict[Tuple[bytes, bytes], bytes] = {}
        if n_writes:
            wa = ctypes.create_string_buffer(20 * n_writes)
            wk = ctypes.create_string_buffer(32 * n_writes)
            wv = ctypes.create_string_buffer(32 * n_writes)
            lib.coreth_hostexec_out_writes(self._h, wa, wk, wv)
            for i in range(n_writes):
                writes[(wa.raw[20 * i:20 * i + 20],
                        wk.raw[32 * i:32 * i + 32])] = \
                    wv.raw[32 * i:32 * i + 32]
        logs: List[Tuple[bytes, List[bytes], bytes]] = []
        if n_logs:
            la = ctypes.create_string_buffer(20 * n_logs)
            lnt = (ctypes.c_int32 * n_logs)()
            lt = ctypes.create_string_buffer(4 * 32 * n_logs)
            ld = (ctypes.c_int32 * n_logs)()
            blob = ctypes.create_string_buffer(max(1, log_data_total))
            lib.coreth_hostexec_out_logs(self._h, la, lnt, lt, ld, blob)
            off = 0
            for i in range(n_logs):
                topics = [lt.raw[(4 * i + j) * 32:(4 * i + j) * 32 + 32]
                          for j in range(int(lnt[i]))]
                dn = int(ld[i])
                logs.append((la.raw[20 * i:20 * i + 20], topics,
                             blob.raw[off:off + dn]))
                off += dn
        ret = b""
        if ret_len:
            rb = ctypes.create_string_buffer(ret_len)
            lib.coreth_hostexec_out_ret(self._h, rb)
            ret = rb.raw
        return NativeCallResult(
            status=status, gas_left=int(out[0]), refund=int(out[1]),
            writes=writes, logs=logs, ret=ret, host_reason=int(out[6]))
