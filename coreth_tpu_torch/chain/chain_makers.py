"""Deterministic chain generation: value transfers and contract calls.

The port's counterpart of reference core/chain_makers.go (BlockGen :47,
GenerateChain :245).  ``BlockGen.add_tx`` applies each tx sequentially
with Python ints under the reference's state-transition rules (nonce
and fee-cap pre-checks, buyGas against gas * fee_cap + value, intrinsic
gas, the value transfer with EIP-158's no-op for a zero-value call to a
missing account, the unused-gas refund at the effective price with no
SSTORE refund from ApricotPhase1 on, the coinbase fee, per-tx deletion
of touched empty accounts).  A call into contract code executes on the
repo's native host session (``evm/hostexec``, native/evm.cc): the
builder shares no code with the device step machine or its plain
version, so chains built here are an independent reference for the
replay engine.  Receipts carry the calls' logs and the bloom.

Contract creation, access lists, and calls the native session cannot
take (a host-only opcode, a precompile callee) raise ``InvalidTransfer``.

``generate_chain(..., engine=)`` takes the reference's own path instead
(chain_makers.go:57-140): each block's txs apply through the port's
``processor.apply_transaction`` on a ``StateDB`` over the store, and
the engine's callbacks finalize the block, so a chain may hold atomic
ExtData blocks, multicoin balances and precompile calls
(``nativeAssetCall``).  That path shares the ``Processor``'s state
transition with the replay engine's host path, so it is a builder, not
an independent reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from coreth_tpu_torch.consensus import calc_base_fee
from coreth_tpu_torch.consensus.engine import DummyEngine
from coreth_tpu_torch.evm import EVM, TxContext
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device.tables import fork_key
from coreth_tpu_torch.evm.hostexec.backend import HostExecBackend
from coreth_tpu_torch.evm.hostexec.eligibility import (
    COINBASE_WARM_FORKS, native_eligible,
)
from coreth_tpu_torch.evm.precompiles import (
    BLACKHOLE_ADDR, is_prohibited, special_call_targets,
)
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.processor.message import tx_to_message
from coreth_tpu_torch.processor.state_processor import (
    apply_transaction, new_block_context,
)
from coreth_tpu_torch.processor.state_transition import GasPool, intrinsic_gas
from coreth_tpu_torch.state import StateDB, StateStore
from coreth_tpu_torch.types import (
    Block, Header, LatestSigner, Log, Receipt, StateAccount, Transaction,
)
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH


class InvalidTransfer(ValueError):
    """The tx is not valid (or not supported) at this point."""


class _State:
    """Account and storage overlay over a StateStore: reads fall
    through, writes fold into the tries once per block (``commit``)."""

    def __init__(self, store: StateStore):
        self.store = store
        self.trie = store.trie
        self.accounts: Dict[bytes, Optional[StateAccount]] = {}
        self.dirty: Set[bytes] = set()
        self.slots: Dict[Tuple[bytes, bytes], int] = {}

    def get(self, addr: bytes) -> Optional[StateAccount]:
        if addr not in self.accounts:
            raw = self.trie.get(addr)
            self.accounts[addr] = (StateAccount.from_rlp(raw)
                                   if raw is not None else None)
        return self.accounts[addr]

    def obj(self, addr: bytes) -> StateAccount:
        """The account, created empty if missing; marks it touched."""
        acct = self.get(addr)
        if acct is None:
            acct = StateAccount()
            self.accounts[addr] = acct
        self.dirty.add(addr)
        return acct

    def code(self, acct: Optional[StateAccount]) -> bytes:
        if acct is None or acct.code_hash == EMPTY_CODE_HASH:
            return b""
        return self.store.code(acct.code_hash)

    def slot(self, addr: bytes, key: bytes) -> int:
        v = self.slots.get((addr, key))
        return v if v is not None else self.store.storage_value(addr, key)

    def finalise(self, touched: Set[bytes]) -> None:
        """EIP-158: delete touched accounts that ended up empty."""
        for addr in touched:
            a = self.accounts.get(addr)
            if a is not None and a.nonce == 0 and a.balance == 0 \
                    and a.code_hash == EMPTY_CODE_HASH \
                    and not a.is_multi_coin:
                self.accounts[addr] = None

    def intermediate_root(self, _delete_empty_objects: bool) -> bytes:
        """The post-block root ``finalize_and_assemble`` takes: the
        overlay always deletes touched empty accounts (EIP-158)."""
        return self.commit()

    def commit(self) -> bytes:
        for (addr, key), v in self.slots.items():
            self.store.set_storage(addr, key, v)
        for addr in {a for a, _k in self.slots}:
            self.obj(addr).root = self.store.storage_trie(addr).hash()
        self.slots.clear()
        for addr in sorted(self.dirty):
            a = self.accounts[addr]
            if a is None:
                if self.trie.get(addr) is not None:
                    self.trie.delete(addr)
            else:
                self.trie.update(addr, a.rlp())
        self.dirty.clear()
        return self.trie.hash()


class _Calls:
    """The chain's native host session, opened at the first contract
    call (one per fork), with code resolved from the chain builder's state."""

    def __init__(self, config: ChainConfig, state: _State):
        self.config = config
        self.state = state
        self.sessions: Dict[str, object] = {}

    def session(self, rules, header: Header):
        fork = fork_key(rules)
        if fork is None:
            raise InvalidTransfer("contract calls need ApricotPhase2+")
        be = self.sessions.get(fork)
        if be is None:
            st = self.state
            avoid = special_call_targets(rules)

            def slot(contract: bytes, key: bytes) -> bytes:
                return st.slot(contract, key).to_bytes(32, "big")

            def code(addr: bytes) -> Optional[bytes]:
                if addr in avoid or is_prohibited(addr):
                    return None      # precompile callee: host only
                acct = st.get(addr)
                c = st.code(acct)
                if c:
                    return c if native_eligible(c, fork)[0] else None
                if acct is not None and acct.nonce == 0 \
                        and acct.balance == 0:
                    return None      # existing-but-empty: EIP-158 touch
                return b""

            be = self.sessions[fork] = HostExecBackend(
                fork, self.config.chain_id, slot, code)
        be.set_env(header.coinbase, header.time, header.number,
                   header.gas_limit, header.base_fee or 0)
        return be, fork

    def close(self) -> None:
        for be in self.sessions.values():
            be.close()
        self.sessions.clear()


class BlockGen:
    """Per-block generation context (chain_makers.go:47)."""

    def __init__(self, index: int, parent: Block, state: _State,
                 config: ChainConfig, gap: int, calls: _Calls):
        self.index = index
        self.parent = parent
        self.state = state
        self.config = config
        self.header = _make_header(config, parent, gap)
        self.txs: List[Transaction] = []
        self.receipts: List[Receipt] = []
        self.gas_pool = self.header.gas_limit
        self.signer = LatestSigner(config.chain_id)
        self.used_gas = 0
        self._calls = calls

    @property
    def base_fee(self):
        return self.header.base_fee

    def add_tx(self, tx: Transaction) -> None:
        """Apply a value transfer or a contract call now; raises
        InvalidTransfer on a tx the reference would reject or this
        builder does not support."""
        hdr = self.header
        rules = self.config.rules(hdr.number, hdr.time)
        if tx.to is None or tx.access_list:
            raise InvalidTransfer("contract creation and access lists are "
                                  "not supported")
        if tx.to in special_call_targets(rules) or is_prohibited(tx.to):
            raise InvalidTransfer("call to a precompile address")
        sender = self.signer.sender(tx)
        st = self.state
        src = st.get(sender)
        nonce = src.nonce if src is not None else 0
        if tx.nonce != nonce:
            raise InvalidTransfer(f"nonce {tx.nonce} != state {nonce}")
        if src is not None and src.code_hash != EMPTY_CODE_HASH:
            raise InvalidTransfer("sender is not an EOA")
        base_fee = hdr.base_fee
        price = tx.gas_price
        if base_fee is not None:
            price = min(tx.gas_fee_cap, base_fee + tx.gas_tip_cap)
        if rules.is_apricot_phase3:
            if tx.gas_fee_cap < tx.gas_tip_cap:
                raise InvalidTransfer("tip above fee cap")
            if tx.gas_fee_cap < base_fee:
                raise InvalidTransfer("fee cap below base fee")
        # buyGas (state_transition.go buyGas): checked against the cap
        balance = src.balance if src is not None else 0
        if balance < tx.gas * tx.gas_fee_cap + tx.value:
            raise InvalidTransfer("insufficient funds for gas*price+value")
        if self.gas_pool < tx.gas:
            raise InvalidTransfer("block gas limit reached")
        intrinsic = intrinsic_gas(tx.data, [], False, rules)
        if tx.gas < intrinsic:
            raise InvalidTransfer("intrinsic gas too low")
        dst = st.get(tx.to)
        code = st.code(dst)
        touched = {sender}
        acct = st.obj(sender)
        acct.balance -= tx.gas * price   # >= tx.value, by the check above
        acct.nonce += 1
        status, logs = 1, []
        if code:
            gas_left, status, logs = self._call(tx, sender, price,
                                                intrinsic, rules, touched)
        else:
            gas_left = tx.gas - intrinsic
            # a zero-value call to a missing account is a no-op
            # (EIP-158); otherwise the recipient is created and credited
            if dst is not None or tx.value != 0 or not rules.is_eip158:
                acct.balance -= tx.value
                st.obj(tx.to).balance += tx.value
                touched.add(tx.to)
        gas_used = tx.gas - gas_left
        # refund of the unused gas (no refund counter from AP1 on), then
        # the fee to the coinbase
        acct.balance += gas_left * price
        st.obj(hdr.coinbase).balance += gas_used * price
        touched.add(hdr.coinbase)
        st.finalise(touched)
        self.gas_pool -= gas_used
        self.used_gas += gas_used
        self.txs.append(tx)
        self.receipts.append(Receipt(
            tx_type=tx.tx_type, status=status,
            cumulative_gas_used=self.used_gas, logs=logs,
            gas_used=gas_used, tx_hash=tx.hash(),
            effective_gas_price=price,
            transaction_index=len(self.txs) - 1))

    def _call(self, tx, sender, price, intrinsic, rules, touched):
        """The root call into contract code on the native session:
        (gas_left, receipt status, logs).  The value moves inside the
        call's snapshot: a revert or error returns it."""
        st = self.state
        be, fork = self._calls.session(rules, self.header)
        warm = [sender, tx.to]
        if fork in COINBASE_WARM_FORKS:
            warm.append(self.header.coinbase)      # EIP-3651
        res = be.call(sender, tx.to, tx.value, price, tx.data,
                      tx.gas - intrinsic, warm_addrs=warm)
        if res.needs_host:
            raise InvalidTransfer(
                f"call needs the host interpreter (reason "
                f"{res.host_reason}); the builder runs calls on the "
                "native session only")
        touched.add(tx.to)
        if res.status != M.STOP:
            return res.gas_left, 0, []
        be.commit()    # sequential carry: the next call reads these
        if tx.value:
            st.obj(sender).balance -= tx.value
            st.obj(tx.to).balance += tx.value
        for (contract, key), v in res.writes.items():
            st.slots[(contract, key)] = int.from_bytes(v, "big")
        logs = [Log(address=addr, topics=list(topics), data=data,
                    block_number=self.header.number)
                for addr, topics, data in res.logs]
        return res.gas_left, 1, logs


class StateDBBlockGen:
    """Per-block context of the ``engine=`` path (reference
    chain_makers.go:47): ``add_tx`` applies a tx at once through the
    port's ``apply_transaction`` on the block's ``StateDB``; an invalid
    tx raises."""

    def __init__(self, index: int, parent: Block, statedb: StateDB,
                 config: ChainConfig, gap: int):
        self.index = index
        self.parent = parent
        self.statedb = statedb
        self.config = config
        self.header = _make_header(config, parent, gap)
        self.txs: List[Transaction] = []
        self.receipts: List[Receipt] = []
        self.gas_pool = GasPool(self.header.gas_limit)
        self.signer = LatestSigner(config.chain_id)
        self._used_gas = [0]
        self._evm: Optional[EVM] = None

    @property
    def base_fee(self):
        return self.header.base_fee

    @property
    def used_gas(self) -> int:
        return self._used_gas[0]

    def add_tx(self, tx: Transaction) -> None:
        if self._evm is None:
            self._evm = EVM(new_block_context(self.header), TxContext(),
                            self.statedb, self.config)
        msg = tx_to_message(tx, self.signer, self.header.base_fee)
        self.statedb.set_tx_context(tx.hash(), len(self.txs))
        receipt = apply_transaction(
            msg, self.gas_pool, self.statedb, self.header.number,
            b"\x00" * 32, tx, self._used_gas, self._evm)
        receipt.transaction_index = len(self.txs)
        self.txs.append(tx)
        self.receipts.append(receipt)


def _make_header(config: ChainConfig, parent: Block, gap: int) -> Header:
    """makeHeader (chain_makers.go:380): fee fields per fork."""
    time = parent.time + gap
    header = Header(
        parent_hash=parent.hash(),
        coinbase=BLACKHOLE_ADDR,
        difficulty=1,
        number=parent.number + 1,
        time=time,
    )
    if config.is_cortina(time):
        header.gas_limit = P.CORTINA_GAS_LIMIT
    elif config.is_apricot_phase1(time):
        header.gas_limit = P.APRICOT_PHASE1_GAS_LIMIT
    else:
        header.gas_limit = parent.gas_limit
    if config.is_apricot_phase3(time):
        window, base_fee = calc_base_fee(config, parent.header, time)
        header.extra = window
        header.base_fee = base_fee
    return header


# the empty predicate-results encoding (u32 count = 0) that Durango
# headers carry after the fee window (worker.go:333-337)
_EMPTY_PREDICATE_RESULTS = b"\x00" * 4


def generate_chain(config: ChainConfig, parent: Block,
                   state: StateStore, n: int,
                   gen: Optional[Callable[[int, BlockGen], None]],
                   gap: int = 10, engine: Optional[DummyEngine] = None,
                   ) -> Tuple[List[Block], List[List[Receipt]]]:
    """GenerateChain: ``state`` holds the state at ``parent.root`` and
    is advanced block by block.  Without ``engine`` the txs apply on
    the builder's own overlay (``BlockGen``); with it on a ``StateDB``
    through the ``Processor``'s state transition
    (``StateDBBlockGen``), finalized by ``engine``'s callbacks.
    Returns (blocks, receipts)."""
    if engine is not None:
        return _generate_with_engine(config, parent, state, n, gen, gap,
                                     engine)
    engine = DummyEngine()
    st = _State(state)
    calls = _Calls(config, st)
    blocks: List[Block] = []
    all_receipts: List[List[Receipt]] = []
    try:
        for i in range(n):
            bg = BlockGen(i, parent, st, config, gap, calls)
            if gen is not None:
                gen(i, bg)
            bg.header.gas_used = bg.used_gas
            if config.is_durango(bg.header.time):
                bg.header.extra = bg.header.extra + _EMPTY_PREDICATE_RESULTS
            block = engine.finalize_and_assemble(
                config, bg.header, parent.header, st, bg.txs, bg.receipts)
            blocks.append(block)
            all_receipts.append(bg.receipts)
            parent = block
    finally:
        calls.close()
    return blocks, all_receipts


def _generate_with_engine(config, parent, state, n, gen, gap, engine):
    """The ``engine=`` path of ``generate_chain`` (reference
    chain_makers.go:245 over a StateDB)."""
    engine.set_config(config)
    blocks: List[Block] = []
    all_receipts: List[List[Receipt]] = []
    for i in range(n):
        statedb = StateDB(state)
        bg = StateDBBlockGen(i, parent, statedb, config, gap)
        if gen is not None:
            gen(i, bg)
        bg.header.gas_used = bg.used_gas
        if config.is_durango(bg.header.time):
            bg.header.extra = bg.header.extra + _EMPTY_PREDICATE_RESULTS
        block = engine.finalize_and_assemble(
            config, bg.header, parent.header, statedb, bg.txs, bg.receipts)
        statedb.commit(delete_empty_objects=True)
        blocks.append(block)
        all_receipts.append(bg.receipts)
        parent = block
    return blocks, all_receipts
