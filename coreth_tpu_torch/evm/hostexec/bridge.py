"""StateDB bridge: route depth-0 EVM calls through the native engine.

Port of reference ``evm/hostexec/bridge.py``.  ``try_call`` is invoked
by EVM.call for root frames (evm.py).  When the target bytecode fits
the compiled opcode set, the tx executes in C++ against the live
StateDB (storage/code resolved through callbacks) and the results —
storage writes, logs, return data, gas — are journaled back through the
normal StateDB mutators, so receipts, roots, and revert semantics are
bit-identical to the interpreted path.  Any ineligibility (host-only
opcode, precompile callee, value-carrying subcall) returns None and the
caller proceeds on the Python interpreter — per-tx fallback, never a
wrong answer.

This single seam serves every host execution site: the ReplayEngine's
``_fallback`` (through Processor/apply_message) and the OCC conflict
suffix (replay/machine_block._host_resolve builds EVM.call directly).
The native engine is always the first choice (the reference's default
``CORETH_HOST_EXEC=native``).

Faults on the native boundary go to the replay engine's supervisor
(``replay/supervisor.py``), found through the StateDB's store
(``store.fault_observer``, which the engine sets; ``set_fault_observer``
installs a process-wide one for an EVM with no engine behind it): a
demoted ``native`` scope sends every call to the interpreter, an
injected session loss (``native/session_loss``), a session error or an
error rc (``native/error_rc``) is a per-tx interpreter fallback plus a
strike.  With ``store.host_exec_check`` (the engine's
``host_exec_check=True``, the reference's ``CORETH_HOST_EXEC_CHECK=1``)
the Python interpreter stays in the loop as a differential oracle:
every native result is re-derived on a copy of the StateDB
(``StateDB.copy``, which leaves the StateDB as it was) and compared
(status, gas, return data, writes, logs, refund) before it is taken; a
divergence hard-demotes ``native`` and the interpreter serves the tx,
or, with no supervisor, raises.
"""

from __future__ import annotations

from typing import Dict, Optional

from coreth_tpu_torch import faults
from coreth_tpu_torch.evm import vmerrs
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device.tables import fork_key
from coreth_tpu_torch.evm.hostexec.backend import (
    HostExecBackend, SessionError,
)
from coreth_tpu_torch.evm.hostexec.eligibility import native_eligible
from coreth_tpu_torch.obs import span as _trace_span
from coreth_tpu_torch.types.receipt import Log

# which executor served depth-0 calls
_COUNTERS: Dict[str, int] = {}

# Injection points on the native boundary:
PT_SESSION_LOSS = faults.declare(
    "native/session_loss",
    "hostexec session unavailable at bridge setup")
PT_DIVERGE = faults.declare(
    "native/oracle_divergence",
    "armed differential oracle reports a native/interpreter divergence")

# the process-wide fault observer, for EVMs whose store no engine set
_OBSERVER = None


def set_fault_observer(observer) -> None:
    global _OBSERVER
    _OBSERVER = observer


def _store_of(evm):
    return getattr(getattr(evm, "statedb", None), "store", None)


def _observer_for(evm):
    """The supervisor of THIS evm's engine (its store's), else the
    process-wide one."""
    observer = getattr(_store_of(evm), "fault_observer", None)
    return observer if observer is not None else _OBSERVER


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


def _bump(key: str) -> None:
    _COUNTERS[key] = _COUNTERS.get(key, 0) + 1


def _backend_for(evm, fork: str) -> HostExecBackend:
    """Session cached on the EVM object (one fork per EVM instance)."""
    be = getattr(evm, "_hostexec_backend", None)
    if be is not None:
        return be

    def slot_resolver(contract: bytes, key: bytes) -> bytes:
        # pre-tx view: current == committed at tx start (earlier txs
        # of the block were finalised into pending_storage)
        return evm.statedb.get_state(contract, key)

    def code_resolver(addr: bytes) -> Optional[bytes]:
        # counted so tests can pin when cached verdicts actually
        # short-circuit this callback (the EOA-verdict reuse path)
        _bump("code_resolves")
        if evm.precompile(addr) is not None:
            return None  # precompile callees run on the host only
        db = evm.statedb
        code = db.get_code(addr)
        if code:
            ok, _ = native_eligible(code, fork)
            return code if ok else None
        if db.exist(addr) and db.empty(addr):
            # calling an existing-but-empty account touches it into
            # EIP-158 deletion — StateDB journal semantics the native
            # engine does not model
            return None
        return b""

    be = HostExecBackend(fork, evm.chain_id, slot_resolver, code_resolver)
    evm._hostexec_backend = be
    return be


def try_call(evm, caller: bytes, addr: bytes, input_: bytes, gas: int,
             value: int, snapshot: int):
    """Native execution of one root call; None -> interpreter path."""
    observer = _observer_for(evm)
    if observer is not None and not observer.allows("native"):
        # the supervisor demoted the native engine: the interpreter
        # serves until the cooldown lapses (then the next call probes)
        _bump("supervisor_demoted")
        return None
    fork = fork_key(evm.rules)
    if fork is None:
        return None
    if gas >= (1 << 62):
        return None  # int64 ABI headroom (eth_call-style giant gas)
    statedb = evm.statedb
    code = statedb.get_code(addr)
    if not code:
        return None
    eligible, _reason = native_eligible(code, fork)
    if not eligible:
        _bump("py_ineligible")
        return None
    try:
        faults.fire(PT_SESSION_LOSS)
        be = _backend_for(evm, fork)
    except (faults.FaultInjected, SessionError) as exc:
        if observer is not None:
            observer.strike("native", exc)
        _bump("session_faults")
        return None
    ctx = evm.block_ctx
    # Cross-tx cache reuse: resolved (contract, slot) values and
    # code/kind verdicts survive from the previous native tx of the
    # SAME StateDB as long as nothing outside this bridge mutated it
    # (statedb.storage_gen counts storage writes, deploys, reverts,
    # suicides).  Any foreign mutation — an interpreter-path tx, a
    # mid-block CREATE — forces the full reset.
    seen = getattr(evm, "_hostexec_seen", None)
    if (seen is not None and seen[0] is statedb
            and seen[1] == statedb.storage_gen):
        if seen[2] == statedb.account_gen:
            # nothing changed any account's existence/emptiness either
            # (statedb.account_gen counts creations, balance/nonce
            # zero-crossings, deploys, suicides, EIP-158 deletions,
            # reverts): cached EOA verdicts are still exact
            _bump("eoa_cache_reuse")
        else:
            # account shape moved through something storage_gen cannot
            # see (a pure balance transfer creating an account, say):
            # drop ONLY the EOA verdicts so the code_resolver's
            # EIP-158 exist-and-empty host guard re-fires
            be.reset_eoa_kinds()
        _bump("storage_cache_reuse")
    else:
        be.reset_contracts()
    evm._hostexec_seen = None  # re-armed only on a clean hand-back
    be.set_env(ctx.coinbase, ctx.time, ctx.number, ctx.gas_limit,
               ctx.base_fee or 0, ctx.difficulty)
    be.set_code(addr, code)
    try:
        with _trace_span("hostexec/native_call", gas=gas):
            res = be.call(
                caller, addr, value, evm.tx_ctx.gas_price, input_, gas,
                warm_addrs=sorted(statedb.access_list_addresses),
                warm_slots=sorted(statedb.access_list_slots))
    except (faults.FaultInjected, SessionError) as exc:
        # an error rc from the session: a per-tx interpreter fallback
        # and a native strike (repeated ones demote the scope)
        if observer is not None:
            observer.strike("native", exc)
        _bump("native_faults")
        return None
    if res.needs_host:
        _bump("host_escapes")
        return None
    if getattr(_store_of(evm), "host_exec_check", False):
        try:
            faults.fire(PT_DIVERGE)
            _differential_check(evm, caller, addr, input_, gas, value,
                                res)
        except (faults.FaultInjected, AssertionError) as exc:
            if observer is None:
                raise  # unsupervised oracle mode: fail loudly
            # a backend that DISAGREES with the interpreter is wrong,
            # not slow: hard-demote at once; the interpreter (whose
            # result is authoritative) serves the tx
            observer.strike("native", exc, hard=True)
            _bump("oracle_divergences")
            return None
        _bump("oracle_checks")
    if observer is not None:
        observer.note_ok("native")  # strike reset + probe success
    if res.status == M.ERR:
        # the outcome (all gas burned, status-0 receipt) is already
        # proven equal, but callers pin the exact error TAXONOMY
        # (ErrInvalidOpCode vs ErrOutOfGas vs ErrInvalidJump...) that
        # only the interpreter derives — re-run the dead tx there.
        # Error txs are rare and bounded by their own burned gas.
        _bump("err_fallbacks")
        return None
    _bump("native_calls")
    if res.status == M.STOP:
        for (contract, key), v in res.writes.items():
            statedb.set_state(contract, key, v)
        for log_addr, topics, data in res.logs:
            statedb.add_log(Log(address=log_addr, topics=list(topics),
                                data=data, block_number=ctx.number))
        if res.refund > 0:
            statedb.add_refund(res.refund)
        elif res.refund < 0:
            statedb.sub_refund(-res.refund)
        # fold this call's writes into the session's committed cache
        # and record the StateDB generations they correspond to — the
        # next tx of this block reuses the cache iff both still match
        be.commit()
        evm._hostexec_seen = (statedb, statedb.storage_gen,
                              statedb.account_gen)
        return res.ret, res.gas_left, None
    # REVERT: the payload + surviving gas carry all the information
    # the caller needs; no interpreter re-run required.  The session's
    # committed cache never saw the discarded overlay, and the journal
    # revert restores exactly the entry state, so the cache stays
    # valid for the next tx.
    statedb.revert_to_snapshot(snapshot)
    evm._hostexec_seen = (statedb, statedb.storage_gen,
                          statedb.account_gen)
    err = vmerrs.ErrExecutionReverted()
    err.data = res.ret
    return res.ret, res.gas_left, err


def _differential_check(evm, caller, addr, input_, gas, value,
                        res) -> None:
    """Re-derive the call on the Python interpreter over a copy of the
    StateDB and assert equality (raises AssertionError on the first
    divergence).  The copy shares the store read-only and takes the
    journaled overlay, so the StateDB itself is left as it was."""
    from coreth_tpu_torch.evm.evm import EVM
    copy = evm.statedb.copy()
    evm2 = EVM(evm.block_ctx, evm.tx_ctx, copy, evm.chain_config,
               evm.config)
    snap2 = copy.snapshot()
    n_logs0 = len(copy.logs)
    refund0 = copy.refund
    ret2, gas2, err2 = evm2._execute(
        None, caller, addr, addr, input_, gas, value, False, snap2)
    if err2 is None:
        status2 = M.STOP
    elif isinstance(err2, vmerrs.ErrExecutionReverted):
        status2 = M.REVERT
    else:
        status2 = M.ERR
    if (res.status, res.gas_left) != (status2, gas2):
        raise AssertionError(
            f"hostexec divergence: native (status={res.status}, "
            f"gas={res.gas_left}) != py (status={status2}, gas={gas2})")
    if res.status != M.ERR and res.ret != ret2:
        raise AssertionError("hostexec divergence: return data")
    if res.status == M.STOP:
        for (contract, key), v in res.writes.items():
            got = copy.get_state(contract, key)
            if got != v:
                raise AssertionError(
                    f"hostexec divergence: write {key.hex()}: "
                    f"native {v.hex()} != py {got.hex()}")
        py_logs = copy.logs[n_logs0:]
        if len(py_logs) != len(res.logs):
            raise AssertionError("hostexec divergence: log count")
        for lg, (la, topics, data) in zip(py_logs, res.logs):
            if (bytes(lg.address), [bytes(t) for t in lg.topics],
                    bytes(lg.data)) != (la, topics, data):
                raise AssertionError("hostexec divergence: log body")
        if copy.refund - refund0 != res.refund:
            raise AssertionError(
                f"hostexec divergence: refund native {res.refund} != "
                f"py {copy.refund - refund0}")
