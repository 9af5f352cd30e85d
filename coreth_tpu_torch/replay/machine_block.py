"""Machine blocks: general contract blocks on the device step machine,
with an optimistic execute-validate-retry scheduler.

Port of reference ``replay/machine_block.py``.  Every call tx whose
callee bytecode is device-eligible executes on the step machine against
block-start state, and cross-tx ordering is repaired Block-STM style.
Two execution paths, chosen by the engine's ``device_occ``:

- ``execute_run`` (``device_occ=True``, the reference's default
  ``CORETH_DEVICE_OCC=1``; with the engine's ``specialize``, its default
  ``CORETH_SPECIALIZE=1``): WINDOWS of up to ``WINDOW`` consecutive
  machine blocks run in one launch of the fused OCC kernel (K6,
  ``adapter.MachineWindowRunner``; lanes of traced contracts run their
  straight-line programs inside it, K7): the round loop, validation and
  the cross-block state fold stay on the device, against a slot table
  that lives there.  The next window is launched before the
  previous one's tries fold.  A block the kernel marks dirty (a lane
  that escaped) goes to ``execute`` and ends the run; if ``execute``
  cannot finish it either, the engine's host path takes it.  On a mesh engine
  the windows run per shard (``evm/device/shard.ShardedWindowRunner``,
  K9 with its flags reduce inside; ``shard_occ=False`` keeps the single-card
  runner), and a window whose flags say clean lets the next one launch
  before its packed rows are fetched.
- ``execute`` (``device_occ=False``, the reference's
  ``CORETH_DEVICE_OCC=0``, and the dirty-block route): one block at a
  time on K5 —

  1. round 0 executes the block's calls in one device batch;
  2. a sequential host sweep validates each tx's observed read set
     against the in-block state the valid prefix produced; txs whose
     reads diverge re-execute with the best-known pre-state snapshot;
  3. after ``DEVICE_ROUNDS`` device rounds, the conflict suffix (every
     call from the first still-pending one on) runs sequentially through
     ``EVM.call`` on a scratch ``StateDB`` carrying the device-valid
     prefix's writes (the native session serves each call it can, the
     host interpreter the rest).

With the engine's ``serial_shortcircuit`` (the reference's
``CORETH_SERIAL_SHORTCIRCUIT=1``) a run of provably serial blocks — two
or more calls into one contract whose storage keys are PUSH constants,
the swap shape, where every tx conflicts with every other — goes
straight to the native session, one tx after another, with no device
launch (``_execute_serial_run``); a serial block in the middle of a
run ends the window batch before it.

Account effects (nonces, buyGas solvency, value moves, fees) are a host
sweep over Python ints, O(txs).  A block this executor cannot finish —
a lane that escapes the machine (``HOST``) — goes back to the engine's
exact host path (``ReplayEngine._fallback``).  Reference semantics:
core/state_processor.go:95, core/state_transition.go TransitionDb.

Faults: the serial short-circuit needs the engine's supervisor to allow
the ``native`` scope, and an injected error rc or a session error on a
serial call strikes it and sends that block to the per-block path.  A
FAULT injected in the middle of a windowed run (at a later window's
dispatch or a shard exchange) keeps the blocks already finished, folds
them, strikes ``device`` and hands the rest of the run back; at the
first dispatch it propagates to the engine's supervised call.  Any
other exception propagates unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from coreth_tpu_torch import faults, obs, vmerrs
from coreth_tpu_torch.consensus.engine import ConsensusError
from coreth_tpu_torch.crypto import native
from coreth_tpu_torch.evm import EVM, BlockContext, Config, TxContext
from coreth_tpu_torch.evm.census import static_storage_keys
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device import tables as DT
from coreth_tpu_torch.evm.device.adapter import (
    BlockEnv, MachineRunner, MachineWindowRunner, TxResult, TxSpec,
)
from coreth_tpu_torch.evm.hostexec import bridge
from coreth_tpu_torch.evm.hostexec.backend import HostExecBackend, SessionError
from coreth_tpu_torch.evm.hostexec.eligibility import (
    COINBASE_WARM_FORKS, native_eligible,
)
from coreth_tpu_torch.evm.precompiles import (
    is_prohibited, special_call_targets,
)
from coreth_tpu_torch.mpt import derive_hasher
from coreth_tpu_torch.processor.state_transition import intrinsic_gas
from coreth_tpu_torch.state import StateDB
from coreth_tpu_torch.types import (
    Block, Log, Receipt, StateAccount, create_bloom, derive_sha,
)

# optimistic device rounds before the conflict suffix goes to the
# native session (the reference's CORETH_OCC_DEVICE_ROUNDS default)
DEVICE_ROUNDS = 2

# window-runner counters that accumulate across runner rebuilds: the
# premap, discovery and specialisation counts (reported as they are),
# then K6's launches, lane-steps and host-clock split
_PREMAP_COUNTERS = ("premap_predicted", "premap_hits", "premap_nested",
                    "premap_array", "discovery_dispatches",
                    "lanes_specialized", "specialize_escapes",
                    "programs_traced")
# the sharded runner's placement and exchange counters (0 on one card)
_SHARD_COUNTERS = ("kr_lanes", "cross_shard", "exchange_psum",
                   "exchange_ppermute", "load_imb_sum", "load_imb_windows")
_RUNNER_COUNTERS = _PREMAP_COUNTERS + _SHARD_COUNTERS + (
    "launches", "steps", "t_pack", "t_machine", "t_unpack")


@dataclass
class TxPlan:
    kind: str                  # "xfer" | "call"
    sender: bytes
    to: bytes
    nonce: int
    value: int
    gas_limit: int
    intrinsic: int
    price: int                 # effective gas price
    fee_cap: int
    data: bytes = b""
    code: bytes = b""


class MachineBlockExecutor:
    """Classification and execution of machine blocks for one
    ReplayEngine (shares its tries, code store and device tables)."""

    # machine blocks per fused window launch, and how many blocks ahead
    # the engine classifies for one run (the reference's
    # CORETH_MACHINE_WINDOW / CORETH_MACHINE_LOOKAHEAD defaults)
    WINDOW = 8
    LOOKAHEAD = 32

    def __init__(self, engine):
        self.e = engine
        self.rounds = 0            # OCC re-execution rounds
        self.blocks = 0
        self.host_txs = 0          # conflict-suffix txs resolved on the host
        self.native_txs = 0        # host-side txs the native session served
        self.serial_blocks = 0     # blocks the serial short-circuit took
        self.launches = 0          # step-machine runs (miss rounds included)
        self.steps = 0             # lane-steps those runs executed
        # host-clock seconds of the runners (adapter.MachineRunner and
        # MachineWindowRunner) and of the native conflict suffix
        self.t_pack = self.t_machine = self.t_unpack = self.t_suffix = 0.0
        self.windows = 0           # fused OCC windows completed
        self.window_attempts = 0   # launches those windows took
        self.dirty_blocks = 0      # blocks the fused path escalated
        self.last_writes: Dict[Tuple[bytes, bytes], int] = {}
        self._fork: Optional[str] = None
        self._runner: Optional[MachineWindowRunner] = None
        self._runner_fork: Optional[str] = None
        self._runner_epoch = 0
        self._runner_totals = dict.fromkeys(_RUNNER_COUNTERS, 0)
        # blocks of the current windowed run finished and staged (what a
        # mid-run fault keeps)
        self._inflight_consumed = 0

    def counters(self) -> dict:
        """The machine path's counters.  ``launches`` / ``steps`` are K5's
        (per-block path), ``window_launches`` / ``window_steps`` K6's;
        the ``t_*`` times sum both runners."""
        w = dict(self._runner_totals)
        if self._runner is not None:
            for k in w:
                w[k] += getattr(self._runner, k)
        return dict(blocks=self.blocks, rounds=self.rounds,
                    host_txs=self.host_txs, native_txs=self.native_txs,
                    serial_blocks=self.serial_blocks,
                    launches=self.launches, steps=self.steps,
                    window_launches=w["launches"],
                    window_steps=w["steps"],
                    t_pack=self.t_pack + w["t_pack"],
                    t_machine=self.t_machine + w["t_machine"],
                    t_unpack=self.t_unpack + w["t_unpack"],
                    t_suffix=self.t_suffix, windows=self.windows,
                    window_attempts=self.window_attempts,
                    dirty_blocks=self.dirty_blocks,
                    **{k: w[k] for k in _PREMAP_COUNTERS + _SHARD_COUNTERS})

    # ------------------------------------------------------------ classify
    def classify(self, block: Block) -> Optional[List[TxPlan]]:
        """TxPlans if every tx is a pure transfer or a device-eligible
        contract call, else None."""
        e = self.e
        if block.ext_data():
            return None  # atomic ExtData needs the host engine hooks
        rules = e.config.rules(block.number, block.time)
        fork = DT.fork_key(rules)
        if fork is None:
            return None
        base_fee = block.base_fee
        avoid = special_call_targets(rules)
        state = e.state
        plans: List[TxPlan] = []
        for tx in block.transactions:
            if tx.to is None or tx.access_list:
                return None
            if tx.to in avoid or is_prohibited(tx.to):
                return None
            try:
                sender = e.signer.sender(tx)
            except ValueError:
                return None
            s_idx = e._account(sender)
            if state.has_code[s_idx] or state.multicoin[s_idx]:
                return None
            gas_fee_cap = tx.gas_fee_cap
            if base_fee is not None:
                tip = tx.gas_tip_cap
                if gas_fee_cap < base_fee or gas_fee_cap < tip:
                    return None
                price = min(base_fee + tip, gas_fee_cap)
            else:
                price = tx.gas_price
            r_idx = e._account(tx.to)
            if state.multicoin[r_idx]:
                return None
            intrinsic = intrinsic_gas(tx.data, [], False, rules)
            if tx.gas < intrinsic:
                return None
            if not state.has_code[r_idx]:
                # data to an EOA burns intrinsic only: a transfer shape
                plans.append(TxPlan(
                    kind="xfer", sender=sender, to=tx.to, nonce=tx.nonce,
                    value=tx.value, gas_limit=tx.gas, intrinsic=intrinsic,
                    price=price, fee_cap=gas_fee_cap))
                continue
            code = e.store.code(state.code_hashes[r_idx])
            if not DT.scan_code(code, fork).eligible:
                return None
            if len(tx.data) > 4096:
                return None
            plans.append(TxPlan(
                kind="call", sender=sender, to=tx.to, nonce=tx.nonce,
                value=tx.value, gas_limit=tx.gas, intrinsic=intrinsic,
                price=price, fee_cap=gas_fee_cap, data=tx.data,
                code=code))
        self._fork = fork
        return plans

    # ------------------------------------------------- conflict suffix
    def _host_resolve(self, block: Block, plans, call_idx, results,
                      first: int) -> None:
        """Sequentially re-execute every call tx at index >= ``first``
        through ``EVM.call`` against a scratch StateDB on the engine's
        folded store, carrying the device-valid prefix's storage writes
        (the hostexec bridge serves each call the native session can
        take, the host interpreter the rest).  One pass resolves an
        arbitrarily deep conflict chain; results slot into the same
        validation sweep (reads empty: exact by construction).  The
        scratch StateDB is never hashed, so the store is not written."""
        e = self.e
        hx0 = bridge.counters().get("native_calls", 0)
        rules = e.config.rules(block.number, block.time)
        e.commit_pipe.flush()   # the scratch StateDB reads the folded store
        scratch = StateDB(e.store, flat=e._flat_view())
        block_ctx = BlockContext(
            coinbase=block.header.coinbase, number=block.number,
            time=block.time, gas_limit=block.header.gas_limit,
            base_fee=block.base_fee)
        # ONE EVM for the whole suffix (reset per tx): the bridge caches
        # its native session on the EVM object
        evm = EVM(block_ctx, TxContext(), scratch, e.config, Config())
        boosted = set()
        for i in call_idx:
            pl = plans[i]
            if i < first:
                res = results[i]
                if res is not None and res.status == M.STOP:
                    for key, v in res.writes.items():
                        scratch.set_state(pl.to, key, v.to_bytes(32, "big"))
                    scratch.finalise(True)
                continue
            # solvency is validated later by the account sweep over exact
            # sequential balances; the scratch StateDB carries block-START
            # balances, so boost the sender to keep the interpreter's
            # CanTransfer from mis-failing mid-block
            if pl.sender not in boosted:
                scratch.add_balance(pl.sender, 1 << 200)
                boosted.add(pl.sender)
            scratch.prepare(rules, pl.sender, block.header.coinbase, pl.to,
                            list(rules.active_precompiles), [])
            evm.reset(TxContext(origin=pl.sender, gas_price=pl.price),
                      scratch)
            n_logs = len(scratch.logs)
            _ret, gas_left, err = evm.call(
                pl.sender, pl.to, pl.data, pl.gas_limit - pl.intrinsic,
                pl.value)
            if err is None:
                status = M.STOP
            elif isinstance(err, vmerrs.ErrExecutionReverted):
                status = M.REVERT
            else:
                status = M.ERR
            logs = []
            writes = {}
            if status == M.STOP:
                logs = [([bytes(t) for t in lg.topics], bytes(lg.data))
                        for lg in scratch.logs[n_logs:]]
                obj = scratch._objects.get(pl.to)
                if obj is not None:
                    for key in list(obj.dirty_storage):
                        cur = scratch.get_state(pl.to, key, _normalize=False)
                        writes[key] = int.from_bytes(cur, "big")
            else:
                del scratch.logs[n_logs:]
            scratch.finalise(True)
            results[i] = TxResult(
                status=status, gas_left=gas_left, refund=0, logs=logs,
                reads={}, writes=writes)
            self.host_txs += 1
        # which executor served the suffix: EVM.call routes eligible txs
        # through the native session (evm/hostexec/bridge)
        self.native_txs += bridge.counters().get("native_calls", 0) - hx0

    # ------------------------------------------------------------- storage
    def _base_value(self, contract: bytes, key: bytes) -> int:
        """Committed value at block start: staged-but-unfolded writes
        first, then the flat layer (the window runner's table fills and
        the serial session's reads hit a dict; checked under the
        engine's ``flat_check``), then the storage trie, which fills the
        flat layer."""
        return self.e.committed_value(contract, key, "machine-slot")

    # ------------------------------------------------------------- execute
    def execute(self, block: Block,
                plans: List[TxPlan]) -> Optional[bytes]:
        """Run the block; returns the post-state root, or None when a
        lane escapes the machine (HOST).  Raises ReplayError on a
        consensus validation failure."""
        e = self.e
        e.commit_pipe.flush()
        t0 = time.monotonic()
        env = BlockEnv(
            coinbase=block.header.coinbase, timestamp=block.time,
            number=block.number, gas_limit=block.header.gas_limit,
            chain_id=e.config.chain_id, base_fee=block.base_fee or 0)
        call_idx = [i for i, pl in enumerate(plans) if pl.kind == "call"]
        results: Dict[int, TxResult] = {}
        base_cache: Dict[Tuple[bytes, bytes], int] = {}

        def base(contract, key):
            v = base_cache.get((contract, key))
            if v is None:
                v = base_cache[(contract, key)] = self._base_value(
                    contract, key)
            return v

        pending: List[Tuple[int, Dict]] = [(i, {}) for i in call_idx]
        # the round at DEVICE_ROUNDS resolves every pending tx, so the
        # loop always ends in its break
        for rnd in range(DEVICE_ROUNDS + 1):
            if pending and rnd == DEVICE_ROUNDS:
                # the conflict suffix re-executes sequentially at its
                # exact position on the host; the device keeps the valid
                # prefix
                t_s = time.monotonic()
                self._host_resolve(block, plans, call_idx, results,
                                   pending[0][0])
                self.t_suffix += time.monotonic() - t_s
                pending = []
            if pending:
                specs = []
                for i, overlay in pending:
                    pl = plans[i]
                    storage = {k: (v, v) for (c, k), v in overlay.items()
                               if c == pl.to}
                    specs.append(TxSpec(
                        code=pl.code, calldata=pl.data,
                        gas=pl.gas_limit - pl.intrinsic, value=pl.value,
                        caller=pl.sender, address=pl.to, origin=pl.sender,
                        gas_price=pl.price, storage=storage))
                runner = MachineRunner(self._fork, env, base,
                                       device=e.device)
                batch = runner.run(specs)
                self.launches += runner.launches
                self.steps += runner.steps
                self.t_pack += runner.t_pack
                self.t_machine += runner.t_machine
                self.t_unpack += runner.t_unpack
                for (i, _), res in zip(pending, batch):
                    results[i] = res
            # sequential validation sweep
            state: Dict[Tuple[bytes, bytes], int] = {}
            pending = []
            for i in call_idx:
                pl = plans[i]
                res = results.get(i)
                if res is None:
                    pending.append((i, dict(state)))
                    continue
                if res.needs_host:
                    e.stats.t_device += time.monotonic() - t0
                    return None
                ok = True
                for key, observed in res.reads.items():
                    cur = state.get((pl.to, key))
                    if cur is None:
                        cur = base(pl.to, key)
                    if cur != observed:
                        ok = False
                        break
                if not ok:
                    pending.append((i, dict(state)))
                    continue
                if res.status == M.STOP:
                    for key, v in res.writes.items():
                        state[(pl.to, key)] = v
            if not pending:
                break
            self.rounds += 1
        e.stats.t_device += time.monotonic() - t0
        return self._finish_block(block, plans, results)

    # --------------------------------------------------------- finish
    def _finish_block(self, block: Block, plans: List[TxPlan],
                      results: Dict[int, TxResult],
                      defer: bool = False) -> Optional[bytes]:
        """Account sweep + receipts + staged trie commit for one block
        whose call results are final; folds and root-checks it, unless
        ``defer``: then the caller owns the flush, so a fused window
        folds once while the next window's launch is in flight.  The
        block's storage writes are left in ``last_writes``."""
        e = self.e
        t1 = time.monotonic()
        accounts: Dict[bytes, List[int]] = {}  # addr -> [bal, nonce]

        def acct(addr: bytes) -> List[int]:
            st = accounts.get(addr)
            if st is None:
                pend = e.commit_pipe.account_view(addr)
                if pend is not None:
                    st = [pend[0], pend[1]]
                else:
                    raw = e.trie.get(addr)
                    if raw is not None:
                        a = StateAccount.from_rlp(raw)
                        st = [a.balance, a.nonce]
                    else:
                        st = [0, 0]
                accounts[addr] = st
            return st

        from coreth_tpu_torch.replay.engine import _block_error
        # rows: (tx_type, status, used, cum, logs); the uniform Transfer
        # shape (status 1, <= 1 log of 3 topics + 32 data bytes) derives
        # root and bloom in one C++ call
        rows: List[tuple] = []
        uniform = True
        cum = 0
        writes_final: Dict[Tuple[bytes, bytes], int] = {}
        for i, pl in enumerate(plans):
            s = acct(pl.sender)
            if pl.nonce != s[1]:
                raise _block_error(
                    f"machine block: nonce mismatch tx {i}", block)
            if s[0] < pl.gas_limit * pl.fee_cap + pl.value:
                raise _block_error(
                    f"machine block: insufficient funds tx {i}", block)
            logs: List[Log] = []
            if pl.kind == "xfer":
                used = pl.intrinsic
                status = 1
                value_moves = True
            else:
                res = results[i]
                used = pl.gas_limit - res.gas_left
                status = 1 if res.status == M.STOP else 0
                value_moves = res.status == M.STOP
                if status == 1:
                    logs = [Log(address=pl.to, topics=topics, data=data)
                            for topics, data in res.logs]
                    for key, v in res.writes.items():
                        writes_final[(pl.to, key)] = v
            s[1] += 1
            s[0] -= used * pl.price
            if value_moves:
                s[0] -= pl.value
                acct(pl.to)[0] += pl.value
            acct(block.header.coinbase)[0] += used * pl.price
            cum += used
            if uniform and not (
                    status == 1 and len(logs) <= 1
                    and (not logs or (len(logs[0].topics) == 3
                                      and all(len(t) == 32
                                              for t in logs[0].topics)
                                      and len(logs[0].data) == 32))):
                uniform = False
            rows.append((block.transactions[i].tx_type, status, used, cum,
                         logs))
        if cum != block.header.gas_used:
            raise _block_error("machine block: gas used mismatch", block)
        if uniform:
            root, bloom = native.receipt_root(
                [r[3] for r in rows], bytes(r[0] for r in rows),
                bytes(1 if r[4] else 0 for r in rows),
                b"".join(lg.address + b"".join(lg.topics) + lg.data
                         for r in rows for lg in r[4]))
        else:
            receipts = [Receipt(tx_type=t, status=st,
                                cumulative_gas_used=c, gas_used=u,
                                logs=lgs)
                        for t, st, u, c, lgs in rows]
            root = derive_sha(receipts, derive_hasher())
            bloom = create_bloom(receipts)
        if root != block.header.receipt_hash:
            raise _block_error("machine block: receipt root mismatch",
                               block)
        if bloom != block.header.bloom:
            raise _block_error("machine block: bloom mismatch", block)
        if e.config.is_apricot_phase4(block.time):
            try:
                e.engine.verify_block_fee(
                    block.base_fee, block.header.block_gas_cost,
                    block.transactions,
                    [Receipt(gas_used=r[2]) for r in rows])
            except ConsensusError as exc:
                raise _block_error(f"machine block: {exc}", block) from exc

        # stage storage + accounts, and refresh the device tables and the
        # slot mirror the transfer and token path read: the classifier's
        # overlay is void, and every slot that path indexed takes the
        # block's write
        final = {addr: (st[0], st[1]) for addr, st in accounts.items()}
        self.last_writes = writes_final
        e.commit_pipe.stage(block.header, final, writes_final)
        e._slot_overlay.clear()
        state = e.state
        for ck, v in writes_final.items():
            sid = state.slot_index.get(ck)
            if sid is not None and state.slot_host[sid] != v:
                state.slot_host[sid] = v
                state._staged_slots.append((sid, v))
        for addr in accounts:
            e._account(addr)
        state.set_accounts(final)
        e.parent_header = block.header
        self.blocks += 1
        e.stats.blocks_device += 1
        e.stats.txs += len(block.transactions)
        e.stats.t_trie += time.monotonic() - t1
        if defer:
            return None
        return e.commit_pipe.flush()

    # -------------------------------------------- serial short-circuit
    def _serial_eligible(self, plans: List[TxPlan]) -> bool:
        """A provably serial machine block: >= 2 call txs, ONE shared
        contract, and a statically known (PUSH-constant) storage
        footprint with writes — any two txs then conflict through the
        same keys (the swap shape), so device OCC would degrade to one
        lane per round anyway.  Such blocks go straight to the native
        session; blocks with computed keys (the token's keccak mapping
        slots) keep their real independence and stay on device OCC."""
        if not self.e.serial_shortcircuit:
            return False
        if not self.e.supervisor.allows("native"):
            return False  # the supervisor demoted the native session
        calls = [pl for pl in plans if pl.kind == "call"]
        if len(calls) < 2:
            return False
        target = calls[0].to
        if any(pl.to != target for pl in calls[1:]):
            return False
        keys = static_storage_keys(calls[0].code)
        if keys is None or not keys[1]:
            return False  # computed or write-free footprint
        return native_eligible(calls[0].code, self._fork)[0]

    def _execute_serial_run(self, items) -> int:
        """Execute a run of provably serial blocks one tx after another
        on the native session (no device launch); returns the blocks
        consumed.  A native escape (a call into other code, say) sends
        THAT block to the per-block OCC path and the run goes on (or
        hands the block back to the engine's host path, when the
        per-block path cannot finish it either); consensus failures
        raise like every other path."""
        e = self.e

        def resolver(contract: bytes, key: bytes) -> bytes:
            return self._base_value(contract, key).to_bytes(32, "big")

        def code_resolver(_addr: bytes):
            # any dynamic callee routes the tx (and block) off the serial
            # path — the detector only proved the ROOT contract
            return None

        be = HostExecBackend(self._fork, e.config.chain_id, resolver,
                             code_resolver)
        warm_coinbase = self._fork in COINBASE_WARM_FORKS  # EIP-3651
        consumed = 0
        try:
            for block, plans in items:
                t0 = time.monotonic()
                be.set_env(block.header.coinbase, block.time, block.number,
                           block.header.gas_limit, block.base_fee or 0)
                results: Dict[int, TxResult] = {}
                escaped = False
                for i, pl in enumerate(plans):
                    if pl.kind != "call":
                        continue
                    be.set_code(pl.to, pl.code)
                    warm = [pl.sender, pl.to]
                    if warm_coinbase:
                        warm.append(block.header.coinbase)
                    try:
                        res = be.call(pl.sender, pl.to, pl.value, pl.price,
                                      pl.data, pl.gas_limit - pl.intrinsic,
                                      warm_addrs=warm)
                    except (faults.FaultInjected, SessionError) as exc:
                        # a native boundary fault: strike the native
                        # scope and take this block off the serial path
                        e.supervisor.strike("native", exc)
                        escaped = True
                        break
                    if res.needs_host or any(
                            c != pl.to for c, _k in res.writes):
                        escaped = True
                        break
                    if res.status == M.STOP:
                        be.commit()  # sequential carry within the block
                    results[i] = TxResult(
                        status=res.status, gas_left=res.gas_left,
                        refund=res.refund,
                        logs=[(topics, data)
                              for _a, topics, data in res.logs],
                        reads={},  # exact by construction
                        writes={k: int.from_bytes(v, "big")
                                for (_c, k), v in res.writes.items()})
                e.stats.t_device += time.monotonic() - t0
                if escaped:
                    if self.execute(block, plans) is None:
                        return consumed
                    be.clear_storage()  # execute() moved the tries
                else:
                    # deferred: one deduped fold per serial run (the
                    # session's committed cache carries cross-block
                    # reads; _base_value consults the staged writes)
                    self._finish_block(block, plans, results, defer=True)
                    self.serial_blocks += 1
                    self.native_txs += len(results)
                consumed += 1
            e.commit_pipe.flush()
        finally:
            be.close()
            if self._runner is not None:
                # the window runner's mirror and table never saw these
                # writes; the epoch bump rebuilds it at its next use
                e.storage_epoch += 1
        return consumed

    # ------------------------------------------------- fused OCC windows
    def _window_runner(self) -> MachineWindowRunner:
        """The persistent fused-OCC runner, rebuilt (its counters carry
        over) when the fork changes or the token path wrote storage since
        the last machine window (``engine.storage_epoch``): its host
        mirror and device table no longer hold those values.  On a mesh
        engine with
        ``shard_occ`` (the reference's ``CORETH_SHARD_OCC=1``) it is the
        sharded runner (``evm/device/shard.py``: per-shard arenas and OCC
        in one cluster launch, K9, with the flags reduce inside); without
        it, the single-card runner over the sharded tables."""
        e = self.e
        if (self._runner is None or self._runner_fork != self._fork
                or self._runner_epoch != e.storage_epoch):
            if self._runner is not None:
                for k in self._runner_totals:
                    self._runner_totals[k] += getattr(self._runner, k)
            if e.mesh is not None and e.shard_occ:
                from coreth_tpu_torch.evm.device.shard import (
                    ShardedWindowRunner)
                self._runner = ShardedWindowRunner(
                    self._fork, self._base_value, e.mesh, device=e.device,
                    specialize=e.specialize, exchange=e.exchange,
                    keyrange=e.keyrange,
                    keyrange_threshold=e.keyrange_threshold,
                    exchange_density=e.exchange_density)
            else:
                self._runner = MachineWindowRunner(
                    self._fork, self._base_value, device=e.device,
                    specialize=e.specialize)
            self._runner.seed_window_hint(self.WINDOW)
            self._runner_fork = self._fork
        self._runner_epoch = e.storage_epoch
        return self._runner

    def _window_items(self, chunk):
        """(BlockEnv, [TxSpec]) pairs for the call lanes of a chunk."""
        e = self.e
        out = []
        for block, plans in chunk:
            env = BlockEnv(
                coinbase=block.header.coinbase, timestamp=block.time,
                number=block.number, gas_limit=block.header.gas_limit,
                chain_id=e.config.chain_id, base_fee=block.base_fee or 0)
            specs = [TxSpec(
                code=pl.code, calldata=pl.data,
                gas=pl.gas_limit - pl.intrinsic, value=pl.value,
                caller=pl.sender, address=pl.to, origin=pl.sender,
                gas_price=pl.price) for pl in plans if pl.kind == "call"]
            out.append((env, specs))
        return out

    def execute_run(self, items) -> int:
        """Execute a run of consecutive machine blocks ``items`` =
        [(block, plans), ...]; returns how many blocks it finished
        (on the machine or, for a dirty block past the first, on the
        engine's host path).  0 means the FIRST block could not be
        handled here and the caller must send it to the host path.

        A run that starts with provably serial blocks goes to the serial
        short-circuit (``_execute_serial_run``), and a serial block later
        in the run ends the run before it.  Otherwise, with the engine's
        ``device_occ`` the blocks chunk into windows of ``WINDOW``, one
        fused launch each.  The next chunk is launched BEFORE the
        previous chunk's tries fold (the device table carries the
        committed state across launches), so the host folds window N
        while the card runs window N+1.  A dirty block (an escaped lane)
        re-runs through ``execute``, and the run stops after it so the
        engine re-classifies against the repaired state.  Without
        ``device_occ`` the first block runs through ``execute`` alone."""
        with obs.span("machine/execute_run", blocks=len(items)):
            return self._execute_run(items)

    def _execute_run(self, items) -> int:
        e = self.e
        if self._serial_eligible(items[0][1]):
            k = 1
            while k < len(items) and self._serial_eligible(items[k][1]):
                k += 1
            with obs.span("machine/serial_run", blocks=k):
                return self._execute_serial_run(items[:k])
        for n in range(1, len(items)):
            if self._serial_eligible(items[n][1]):
                items = items[:n]
                break
        if not e.device_occ:
            block, plans = items[0]
            return 1 if self.execute(block, plans) is not None else 0
        runner = self._window_runner()
        chunks = [items[k:k + self.WINDOW]
                  for k in range(0, len(items), self.WINDOW)]
        t0 = time.monotonic()
        # the FIRST dispatch propagates faults: nothing is staged yet, so
        # the engine's supervised call can retry or strike
        with obs.span("machine/window_issue", blocks=len(chunks[0])):
            inflight = runner.issue(self._window_items(chunks[0]))
        e.stats.t_device += time.monotonic() - t0
        self._inflight_consumed = 0
        try:
            return self._chunk_loop(runner, chunks, inflight)
        except faults.FaultInjected as exc:
            # a fault mid-run: keep the finished prefix, hand the rest
            # back for re-classification (a persistent fault then fires
            # again at the next run's first dispatch, where the
            # supervisor retries or demotes)
            consumed = self._inflight_consumed
            e.supervisor.strike("device", exc)
            e.commit_pipe.flush()  # finished blocks stay committed
            # the runner's host mirror may already hold the writes of a
            # window whose blocks were not finished (the mirror learns a
            # clean window's writes before the next window's launch):
            # the next run takes a fresh runner, seeded from the folded
            # tries, not a table rebuilt from that mirror
            runner.invalidate()
            e.storage_epoch += 1
            if not consumed:
                raise
            return consumed

    def _chunk_loop(self, runner: MachineWindowRunner, chunks,
                    inflight) -> int:
        e = self.e
        consumed = 0
        for ci, chunk in enumerate(chunks):
            # the sharded runner: fetch the window's flags (K9's) first; if
            # every shard committed clean and the next window needs no
            # table rebuild, launch it BEFORE this window's packed rows
            # are fetched (the mirror still learns this window's writes
            # below before any later rebuild)
            early = next_items = None
            if ci + 1 < len(chunks):
                t0 = time.monotonic()
                if runner.poll_clean(inflight):
                    next_items = self._window_items(chunks[ci + 1])
                    if runner.can_pipeline(next_items):
                        early = runner.issue(next_items)
                e.stats.t_device += time.monotonic() - t0
            t0 = time.monotonic()
            with obs.span("machine/window_complete", blocks=len(chunk)):
                wres = runner.complete(inflight)
            e.stats.t_device += time.monotonic() - t0
            self.windows += 1
            self.window_attempts += wres.attempts
            imb_w = (self._runner_totals["load_imb_windows"]
                     + runner.load_imb_windows)
            if imb_w:
                # max/mean lanes per shard (permille), averaged over every
                # sharded window this executor ran
                e.stats.load_imbalance = round(
                    (self._runner_totals["load_imb_sum"]
                     + runner.load_imb_sum) / imb_w / 1000, 3)
            if early is not None and not all(wres.clean):
                # a clean flags reduce means clean packed rows; should they
                # ever disagree, the device table is not to be trusted
                runner.invalidate()
                early = None
            # pipeline: launch the NEXT chunk before folding this one —
            # its base state is the device-resident table.  The runner's
            # host mirror must learn this chunk's writes first: if the
            # next chunk grows the table past its pow2 cap, issue()
            # rebuilds it from the mirror
            pre_committed = False
            if ci + 1 < len(chunks) and all(wres.clean):
                for k, (_block, plans) in enumerate(chunk):
                    calls = [pl for pl in plans if pl.kind == "call"]
                    writes: Dict[Tuple[bytes, bytes], int] = {}
                    for pl, res in zip(calls, wres.results[k]):
                        if res.status == M.STOP:
                            for key, v in res.writes.items():
                                writes[(pl.to, key)] = v
                    runner.commit_block(writes)
                pre_committed = True
                if early is not None:
                    inflight = early
                else:
                    if next_items is None:
                        next_items = self._window_items(chunks[ci + 1])
                    t0 = time.monotonic()
                    inflight = runner.issue(next_items)
                    e.stats.t_device += time.monotonic() - t0
            for k, (block, plans) in enumerate(chunk):
                if wres.clean[k]:
                    call_idx = [i for i, pl in enumerate(plans)
                                if pl.kind == "call"]
                    results = {i: wres.results[k][n]
                               for n, i in enumerate(call_idx)}
                    self.rounds += max(0, wres.rounds[k] - 1)
                    # deferred: the window's writes fold once, below
                    self._finish_block(block, plans, results, defer=True)
                    if not pre_committed:
                        runner.commit_block(self.last_writes)
                    consumed += 1
                    self._inflight_consumed = consumed
                    continue
                # dirty: partial commits may sit in the device table and
                # every later block of the window ran on a speculative
                # base — this block goes to the per-block path (or, if a
                # lane escapes there too, the host path), the rest back
                # to the engine (execute() folds the clean prefix)
                self.dirty_blocks += 1
                obs.instant("machine/dirty_block", number=block.number)
                runner.invalidate()
                if self.execute(block, plans) is None:
                    if consumed == 0:
                        return 0  # the caller owns the first block's fate
                    e._fallback(block)
                else:
                    runner.commit_block(self.last_writes)
                return consumed + 1
            # ONE deduped fold + root check per fused window
            e.commit_pipe.flush()
        return consumed
