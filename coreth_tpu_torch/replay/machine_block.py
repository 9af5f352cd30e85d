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
  that escaped) goes to ``execute`` and ends the run.  On a mesh engine
  the windows run per shard (``evm/device/shard.ShardedWindowRunner``,
  K9 and its flags reduce K9x; ``shard_occ=False`` keeps the single-card
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
     call from the first still-pending one on) runs sequentially on the
     native host session (``evm/hostexec``, native/evm.cc), seeded with
     the device-valid prefix's writes — the reference reaches the same
     compiled executor through its interpreter's hostexec bridge.

Account effects (nonces, buyGas solvency, value moves, fees) are a host
sweep over Python ints, O(txs).  A block this executor cannot finish —
a lane that escapes the machine (``HOST``), a suffix tx the native
session hands back as needing the host interpreter — raises
``ReplayError`` naming the block: the reference's Python interpreter
fallback is not ported.  Reference semantics: core/state_processor.go:95,
core/state_transition.go TransitionDb.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from coreth_tpu_torch.consensus.engine import ConsensusError
from coreth_tpu_torch.crypto import native
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device import tables as DT
from coreth_tpu_torch.evm.device.adapter import (
    BlockEnv, MachineRunner, MachineWindowRunner, TxResult, TxSpec,
)
from coreth_tpu_torch.evm.hostexec.backend import HostExecBackend
from coreth_tpu_torch.evm.hostexec.eligibility import (
    COINBASE_WARM_FORKS, native_eligible,
)
from coreth_tpu_torch.evm.precompiles import (
    is_prohibited, special_call_targets,
)
from coreth_tpu_torch.mpt import derive_hasher
from coreth_tpu_torch.processor.state_transition import intrinsic_gas
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
        self.host_txs = 0          # conflict-suffix txs resolved off device
        self.native_txs = 0        # ... of them served by the native session
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
        self._runner_totals = dict.fromkeys(_RUNNER_COUNTERS, 0)

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
            intrinsic = intrinsic_gas(tx.data, rules)
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
    def _code_resolver(self, rules):
        """Callee code for the native session: the engine's code store
        for eligible contracts, b"" for EOAs, None (HOST) otherwise."""
        e = self.e
        avoid = special_call_targets(rules)

        def resolve(addr: bytes) -> Optional[bytes]:
            if addr in avoid or is_prohibited(addr):
                return None
            idx = e._account(addr)
            if e.state.has_code[idx]:
                code = e.store.code(e.state.code_hashes[idx])
                return code if native_eligible(code, self._fork)[0] \
                    else None
            raw = e.trie.get(addr)
            if raw is not None:
                a = StateAccount.from_rlp(raw)
                if a.nonce == 0 and a.balance == 0:
                    return None   # existing-but-empty: EIP-158 touch
            return b""
        return resolve

    def _host_resolve(self, block: Block, plans, call_idx, results,
                      first: int) -> None:
        """Sequentially re-execute every call tx at index >= ``first`` on
        the native host session, seeded with the device-valid prefix's
        storage writes.  One pass resolves an arbitrarily deep conflict
        chain; results slot into the same validation sweep (reads empty:
        exact by construction)."""
        from coreth_tpu_torch.replay.engine import _block_error
        e = self.e
        rules = e.config.rules(block.number, block.time)

        def slot(contract: bytes, key: bytes) -> bytes:
            return self._base_value(contract, key).to_bytes(32, "big")

        be = HostExecBackend(self._fork, e.config.chain_id, slot,
                             self._code_resolver(rules))
        try:
            be.set_env(block.header.coinbase, block.time, block.number,
                       block.header.gas_limit, block.base_fee or 0)
            for i in call_idx:
                pl = plans[i]
                if i < first:
                    res = results[i]
                    if res is not None and res.status == M.STOP:
                        for key, v in res.writes.items():
                            be.seed_slot(pl.to, key, v.to_bytes(32, "big"))
                    continue
                warm = [pl.sender, pl.to]
                if self._fork in COINBASE_WARM_FORKS:
                    warm.append(block.header.coinbase)   # EIP-3651
                r = be.call(pl.sender, pl.to, pl.value, pl.price, pl.data,
                            pl.gas_limit - pl.intrinsic, warm_addrs=warm)
                if r.needs_host:
                    raise _block_error(
                        f"machine block: tx {i} needs the host "
                        f"interpreter (reason {r.host_reason}), which is "
                        "not ported", block)
                logs, writes = [], {}
                if r.status == M.STOP:
                    be.commit()   # the next suffix tx reads these
                    for (contract, key), v in r.writes.items():
                        if contract != pl.to:
                            raise _block_error(
                                f"machine block: tx {i} wrote another "
                                "contract's storage", block)
                        writes[key] = int.from_bytes(v, "big")
                    logs = [(topics, data) for _a, topics, data in r.logs]
                results[i] = TxResult(
                    status=r.status, gas_left=r.gas_left, refund=0,
                    logs=logs, reads={}, writes=writes)
                self.host_txs += 1
                self.native_txs += 1
        finally:
            be.close()

    # ------------------------------------------------------------- storage
    def _base_value(self, contract: bytes, key: bytes) -> int:
        """Committed value at block start: staged-but-unfolded writes
        first, then the contract's storage trie."""
        e = self.e
        v = e.commit_pipe.base_value(contract, key)
        if v is not None:
            return v
        return e.storage_value(contract, key)

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
                # exact position; the device keeps the valid prefix
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

        # stage storage + accounts, and refresh the device tables the
        # transfer path reads
        final = {addr: (st[0], st[1]) for addr, st in accounts.items()}
        self.last_writes = writes_final
        e.commit_pipe.stage(block.header, final, writes_final)
        for addr in accounts:
            e._account(addr)
        e.state.set_accounts(final)
        e.parent_header = block.header
        self.blocks += 1
        e.stats.blocks_device += 1
        e.stats.txs += len(block.transactions)
        e.stats.t_trie += time.monotonic() - t1
        if defer:
            return None
        return e.commit_pipe.flush()

    # ------------------------------------------------- fused OCC windows
    def _window_runner(self) -> MachineWindowRunner:
        """The persistent fused-OCC runner, rebuilt when the fork
        changes (its counters carry over).  On a mesh engine with
        ``shard_occ`` (the reference's ``CORETH_SHARD_OCC=1``) it is the
        sharded runner (``evm/device/shard.py``: per-shard arenas and OCC
        in one cluster launch, K9, with the flags reduce K9x); without
        it, the single-card runner over the sharded tables."""
        e = self.e
        if self._runner is None or self._runner_fork != self._fork:
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
        [(block, plans), ...]; returns how many blocks it finished (>= 1).

        With the engine's ``device_occ`` the blocks chunk into windows
        of ``WINDOW``, one fused launch each.  The next chunk is launched
        BEFORE the previous chunk's tries fold (the device table carries
        the committed state across launches), so the host folds window N
        while the card runs window N+1.  A dirty block (an escaped lane)
        re-runs through ``execute``, and the run stops after it so the
        engine re-classifies against the repaired state.  Without
        ``device_occ`` the first block runs through ``execute`` alone.
        Raises ReplayError for a block neither path can finish."""
        e = self.e
        if not e.device_occ:
            block, plans = items[0]
            self._execute_or_raise(block, plans)
            return 1
        runner = self._window_runner()
        chunks = [items[k:k + self.WINDOW]
                  for k in range(0, len(items), self.WINDOW)]
        t0 = time.monotonic()
        inflight = runner.issue(self._window_items(chunks[0]))
        e.stats.t_device += time.monotonic() - t0
        return self._chunk_loop(runner, chunks, inflight)

    def _execute_or_raise(self, block: Block, plans) -> None:
        if self.execute(block, plans) is None:
            from coreth_tpu_torch.replay.engine import _NOT_PORTED, \
                _block_error
            raise _block_error(
                "a call escaped the device step machine (HOST); "
                f"{_NOT_PORTED}", block)

    def _chunk_loop(self, runner: MachineWindowRunner, chunks,
                    inflight) -> int:
        e = self.e
        consumed = 0
        for ci, chunk in enumerate(chunks):
            # the sharded runner: fetch the window's flags (K9x) first; if
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
                    continue
                # dirty: partial commits may sit in the device table and
                # every later block of the window ran on a speculative
                # base — this block goes to the per-block path, the rest
                # back to the engine (execute() folds the clean prefix)
                self.dirty_blocks += 1
                runner.invalidate()
                self._execute_or_raise(block, plans)
                runner.commit_block(self.last_writes)
                return consumed + 1
            # ONE deduped fold + root check per fused window
            e.commit_pipe.flush()
        return consumed
