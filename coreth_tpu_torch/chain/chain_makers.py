"""Deterministic value-transfer chain generation.

The port's counterpart of reference core/chain_makers.go (BlockGen :47,
GenerateChain :245), cut to plain value transfers: ``BlockGen.add_tx``
applies each tx sequentially with Python ints under the reference's
state-transition rules (nonce and fee-cap pre-checks, buyGas against
gas * fee_cap + value, the value transfer with EIP-158's no-op for a
zero-value call to a missing account, the unused-gas refund at the
effective price, the coinbase fee, per-tx deletion of touched empty
accounts) and raises on any tx that is not a plain transfer.

Beside building chains, this is the independent sequential reference
that the replay engine's results are held against: it shares no code
with ``replay/``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from coreth_tpu_torch.consensus import calc_base_fee
from coreth_tpu_torch.consensus.engine import DummyEngine
from coreth_tpu_torch.evm.precompiles import (
    BLACKHOLE_ADDR, is_prohibited, special_call_targets,
)
from coreth_tpu_torch.mpt import NativeSecureTrie
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.types import (
    Block, Header, LatestSigner, Receipt, StateAccount, Transaction,
)
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH


class InvalidTransfer(ValueError):
    """The tx is not a valid plain value transfer at this point."""


class _State:
    """Account overlay over a trie: reads fall through, writes fold into
    the trie once per block (``commit``)."""

    def __init__(self, trie: NativeSecureTrie):
        self.trie = trie
        self.accounts: Dict[bytes, Optional[StateAccount]] = {}
        self.dirty: Set[bytes] = set()

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

    def finalise(self, touched: Set[bytes]) -> None:
        """EIP-158: delete touched accounts that ended up empty."""
        for addr in touched:
            a = self.accounts.get(addr)
            if a is not None and a.nonce == 0 and a.balance == 0 \
                    and a.code_hash == EMPTY_CODE_HASH \
                    and not a.is_multi_coin:
                self.accounts[addr] = None

    def commit(self) -> bytes:
        for addr in sorted(self.dirty):
            a = self.accounts[addr]
            if a is None:
                if self.trie.get(addr) is not None:
                    self.trie.delete(addr)
            else:
                self.trie.update(addr, a.rlp())
        self.dirty.clear()
        return self.trie.hash()


class BlockGen:
    """Per-block generation context (chain_makers.go:47)."""

    def __init__(self, index: int, parent: Block, state: _State,
                 config: ChainConfig, gap: int):
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

    @property
    def base_fee(self):
        return self.header.base_fee

    def add_tx(self, tx: Transaction) -> None:
        """Apply a plain value transfer now; raises InvalidTransfer on
        anything else or on a tx the reference would reject."""
        hdr = self.header
        rules = self.config.rules(hdr.number, hdr.time)
        if tx.to is None or tx.data or tx.access_list:
            raise InvalidTransfer("not a plain value transfer")
        if tx.to in special_call_targets(rules) or is_prohibited(tx.to):
            raise InvalidTransfer("transfer to a precompile address")
        sender = self.signer.sender(tx)
        st = self.state
        src = st.get(sender)
        nonce = src.nonce if src is not None else 0
        if tx.nonce != nonce:
            raise InvalidTransfer(f"nonce {tx.nonce} != state {nonce}")
        if src is not None and src.code_hash != EMPTY_CODE_HASH:
            raise InvalidTransfer("sender is not an EOA")
        dst = st.get(tx.to)
        if dst is not None and dst.code_hash != EMPTY_CODE_HASH:
            raise InvalidTransfer("recipient has code")
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
        if tx.gas < P.TX_GAS:
            raise InvalidTransfer("intrinsic gas too low")
        touched = {sender}
        acct = st.obj(sender)
        acct.balance -= tx.gas * price   # >= tx.value, by the check above
        acct.nonce += 1
        # CALL: a zero-value call to a missing account is a no-op
        # (EIP-158); otherwise the recipient is created and credited
        if dst is not None or tx.value != 0 or not rules.is_eip158:
            acct.balance -= tx.value
            st.obj(tx.to).balance += tx.value
            touched.add(tx.to)
        # refund of the unused gas, then the fee to the coinbase
        gas_used = P.TX_GAS
        acct.balance += (tx.gas - gas_used) * price
        st.obj(hdr.coinbase).balance += gas_used * price
        touched.add(hdr.coinbase)
        st.finalise(touched)
        self.gas_pool -= gas_used
        self.used_gas += gas_used
        self.txs.append(tx)
        self.receipts.append(Receipt(
            tx_type=tx.tx_type, status=1,
            cumulative_gas_used=self.used_gas, gas_used=gas_used,
            tx_hash=tx.hash(), effective_gas_price=price,
            transaction_index=len(self.txs) - 1))


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
                   trie: NativeSecureTrie, n: int,
                   gen: Optional[Callable[[int, BlockGen], None]],
                   gap: int = 10,
                   ) -> Tuple[List[Block], List[List[Receipt]]]:
    """GenerateChain: ``trie`` holds the state at ``parent.root`` and is
    advanced block by block.  Returns (blocks, receipts)."""
    engine = DummyEngine()
    state = _State(trie)
    blocks: List[Block] = []
    all_receipts: List[List[Receipt]] = []
    for i in range(n):
        bg = BlockGen(i, parent, state, config, gap)
        if gen is not None:
            gen(i, bg)
        bg.header.gas_used = bg.used_gas
        if config.is_durango(bg.header.time):
            bg.header.extra = bg.header.extra + _EMPTY_PREDICATE_RESULTS
        root = state.commit()
        block = engine.finalize_and_assemble(
            config, bg.header, parent.header, root, bg.txs, bg.receipts)
        blocks.append(block)
        all_receipts.append(bg.receipts)
        parent = block
    return blocks, all_receipts
