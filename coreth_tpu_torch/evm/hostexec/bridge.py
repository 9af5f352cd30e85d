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
"""

from __future__ import annotations

from typing import Dict, Optional

from coreth_tpu_torch.evm import vmerrs
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device.tables import fork_key
from coreth_tpu_torch.evm.hostexec.backend import HostExecBackend
from coreth_tpu_torch.evm.hostexec.eligibility import native_eligible
from coreth_tpu_torch.types.receipt import Log

# which executor served depth-0 calls
_COUNTERS: Dict[str, int] = {}


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
    be = _backend_for(evm, fork)
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
    res = be.call(caller, addr, value, evm.tx_ctx.gas_price, input_, gas,
                  warm_addrs=sorted(statedb.access_list_addresses),
                  warm_slots=sorted(statedb.access_list_slots))
    if res.needs_host:
        _bump("host_escapes")
        return None
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
