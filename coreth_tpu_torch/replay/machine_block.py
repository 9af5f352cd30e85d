"""Machine blocks: general contract blocks on the device step machine,
with an optimistic execute-validate-retry scheduler.

Port of reference ``replay/machine_block.py`` in its per-block OCC
configuration (the reference's ``CORETH_DEVICE_OCC=0``): every call tx
whose callee bytecode is device-eligible executes on the step machine
(``evm/device``: the K5 kernel on the card) against block-start state,
and cross-tx ordering is repaired Block-STM style:

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
    BlockEnv, MachineRunner, TxResult, TxSpec,
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

    def __init__(self, engine):
        self.e = engine
        self.rounds = 0            # OCC re-execution rounds
        self.blocks = 0
        self.host_txs = 0          # conflict-suffix txs resolved off device
        self.native_txs = 0        # ... of them served by the native session
        self.launches = 0          # step-machine runs (miss rounds included)
        self.steps = 0             # lane-steps those runs executed
        # host-clock seconds of the runners (adapter.MachineRunner) and
        # of the native conflict suffix
        self.t_pack = self.t_machine = self.t_unpack = self.t_suffix = 0.0
        self._fork: Optional[str] = None

    def counters(self) -> dict:
        return dict(blocks=self.blocks, rounds=self.rounds,
                    host_txs=self.host_txs, native_txs=self.native_txs,
                    launches=self.launches, steps=self.steps,
                    t_pack=self.t_pack, t_machine=self.t_machine,
                    t_unpack=self.t_unpack, t_suffix=self.t_suffix)

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
                      results: Dict[int, TxResult]) -> bytes:
        """Account sweep + receipts + staged trie commit for one block
        whose call results are final; folds and root-checks it."""
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
        e.commit_pipe.stage(block.header, final, writes_final)
        for addr in accounts:
            e._account(addr)
        e.state.set_accounts(final)
        e.parent_header = block.header
        self.blocks += 1
        e.stats.blocks_device += 1
        e.stats.txs += len(block.transactions)
        e.stats.t_trie += time.monotonic() - t1
        return e.commit_pipe.flush()
