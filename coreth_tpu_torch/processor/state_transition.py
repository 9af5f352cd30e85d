"""Single-message state transition.

Twin of reference core/state_transition.go: preCheck (:308), buyGas
(:286), IntrinsicGas (:79), accessListGas (:136), TransitionDb (:373),
refundGas (:449 — ApricotPhase1 removes refunds entirely).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from coreth_tpu_torch import vmerrs
from coreth_tpu_torch.evm.evm import EVM
from coreth_tpu_torch.evm.precompiles import is_prohibited  # noqa: F401
from coreth_tpu_torch.params import Rules
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.processor.message import Message
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH

UINT64_MAX = (1 << 64) - 1
HASH_ZERO = b"\x00" * 32


class ConsensusError(Exception):
    """A rule violation that invalidates the tx (and thus the block)."""


class ErrNonceTooLow(ConsensusError):
    pass


class ErrNonceTooHigh(ConsensusError):
    pass


class ErrSenderNoEOA(ConsensusError):
    pass


class ErrInsufficientFunds(ConsensusError):
    pass


class ErrIntrinsicGas(ConsensusError):
    pass


class ErrFeeCapTooLow(ConsensusError):
    pass


class ErrTipAboveFeeCap(ConsensusError):
    pass


class ErrGasLimitReached(ConsensusError):
    pass


class ErrInsufficientFundsForTransfer(ConsensusError):
    pass


class ErrAddrProhibited(ConsensusError):
    pass


class GasPool:
    """Block gas counter (core/gaspool.go)."""

    def __init__(self, gas: int):
        self.gas = gas

    def sub_gas(self, amount: int) -> None:
        if self.gas < amount:
            raise ErrGasLimitReached(
                f"gas limit reached: have {self.gas}, want {amount}")
        self.gas -= amount

    def add_gas(self, amount: int) -> None:
        self.gas += amount


@dataclass
class ExecutionResult:
    used_gas: int = 0
    err: Optional[Exception] = None  # VM error: does not invalidate the tx
    return_data: bytes = b""

    @property
    def failed(self) -> bool:
        return self.err is not None


def intrinsic_gas(data: bytes, access_list, is_contract_creation: bool,
                  rules: Rules) -> int:
    """IntrinsicGas (state_transition.go:79)."""
    if is_contract_creation and rules.is_homestead:
        gas = P.TX_GAS_CONTRACT_CREATION
    else:
        gas = P.TX_GAS
    if data:
        nz = len(data) - data.count(0)  # C-speed zero-byte census
        nonzero_gas = (P.TX_DATA_NON_ZERO_GAS_EIP2028 if rules.is_istanbul
                       else P.TX_DATA_NON_ZERO_GAS_FRONTIER)
        gas += nz * nonzero_gas
        gas += (len(data) - nz) * P.TX_DATA_ZERO_GAS
        if is_contract_creation and rules.is_durango:
            gas += ((len(data) + 31) // 32) * P.INIT_CODE_WORD_GAS
    if access_list:
        gas += _access_list_gas(rules, access_list)
    if gas > UINT64_MAX:
        raise vmerrs.ErrGasUintOverflow()
    return gas


def _access_list_gas(rules: Rules, access_list) -> int:
    """accessListGas (state_transition.go:136): predicate tuples charge the
    predicate's own gas instead of the standard access-list gas."""
    if not rules.predicaters:
        gas = len(access_list) * P.TX_ACCESS_LIST_ADDRESS_GAS
        gas += sum(len(keys) for _, keys in access_list) \
            * P.TX_ACCESS_LIST_STORAGE_KEY_GAS
        return gas
    gas = 0
    for addr, keys in access_list:
        predicater = rules.predicaters.get(addr)
        if predicater is None:
            gas += (P.TX_ACCESS_LIST_ADDRESS_GAS
                    + len(keys) * P.TX_ACCESS_LIST_STORAGE_KEY_GAS)
        else:
            gas += predicater.predicate_gas(b"".join(keys))
    return gas


class StateTransition:
    def __init__(self, evm: EVM, msg: Message, gas_pool: GasPool):
        self.evm = evm
        self.msg = msg
        self.gp = gas_pool
        self.state = evm.statedb
        self.initial_gas = 0
        self.gas_remaining = 0

    # ---------------------------------------------------------------- checks
    def pre_check(self) -> None:
        msg = self.msg
        if not msg.skip_account_checks:
            st_nonce = self.state.get_nonce(msg.from_)
            if st_nonce < msg.nonce:
                raise ErrNonceTooHigh(
                    f"nonce too high: tx {msg.nonce} state {st_nonce}")
            if st_nonce > msg.nonce:
                raise ErrNonceTooLow(
                    f"nonce too low: tx {msg.nonce} state {st_nonce}")
            if st_nonce + 1 > UINT64_MAX:
                raise ConsensusError("nonce max")
            code_hash = self.state.get_code_hash(msg.from_)
            if code_hash not in (HASH_ZERO, EMPTY_CODE_HASH):
                raise ErrSenderNoEOA(f"sender not an EOA: {msg.from_.hex()}")
            if is_prohibited(msg.from_):
                raise ErrAddrProhibited(msg.from_.hex())
        if self.evm.rules.is_apricot_phase3:
            base_fee = self.evm.block_ctx.base_fee
            skip = (self.evm.config.no_base_fee and msg.gas_fee_cap == 0
                    and msg.gas_tip_cap == 0)
            if not skip:
                if msg.gas_fee_cap < msg.gas_tip_cap:
                    raise ErrTipAboveFeeCap(
                        f"tip {msg.gas_tip_cap} > feeCap {msg.gas_fee_cap}")
                if msg.gas_fee_cap < base_fee:
                    raise ErrFeeCapTooLow(
                        f"feeCap {msg.gas_fee_cap} < baseFee {base_fee}")
        self.buy_gas()

    def buy_gas(self) -> None:
        msg = self.msg
        mgval = msg.gas_limit * msg.gas_price
        balance_check = mgval
        if msg.gas_fee_cap is not None:
            balance_check = msg.gas_limit * msg.gas_fee_cap + msg.value
        if self.state.get_balance(msg.from_) < balance_check:
            raise ErrInsufficientFunds(
                f"insufficient funds for gas*price+value: {msg.from_.hex()}")
        self.gp.sub_gas(msg.gas_limit)
        self.gas_remaining = msg.gas_limit
        self.initial_gas = msg.gas_limit
        self.state.sub_balance(msg.from_, mgval)

    # ------------------------------------------------------------ transition
    def transition_db(self) -> ExecutionResult:
        self.pre_check()
        msg = self.msg
        rules = self.evm.rules
        contract_creation = msg.to is None
        gas = intrinsic_gas(msg.data, msg.access_list, contract_creation,
                            rules)
        if self.gas_remaining < gas:
            raise ErrIntrinsicGas(
                f"intrinsic gas: have {self.gas_remaining}, want {gas}")
        self.gas_remaining -= gas
        if msg.value > 0 and not self.evm.can_transfer(msg.from_, msg.value):
            raise ErrInsufficientFundsForTransfer(msg.from_.hex())
        if (rules.is_durango and contract_creation
                and len(msg.data) > P.MAX_INIT_CODE_SIZE):
            raise ConsensusError("max initcode size exceeded")
        self.state.prepare(rules, msg.from_, self.evm.block_ctx.coinbase,
                           msg.to, self.evm.active_precompile_addresses(),
                           msg.access_list)
        vm_err: Optional[Exception] = None
        if contract_creation:
            ret, _, self.gas_remaining, vm_err = self.evm.create(
                msg.from_, msg.data, self.gas_remaining, msg.value)
        else:
            self.state.set_nonce(msg.from_,
                                 self.state.get_nonce(msg.from_) + 1)
            ret, self.gas_remaining, vm_err = self.evm.call(
                msg.from_, msg.to, msg.data, self.gas_remaining, msg.value)
        self.refund_gas(rules.is_apricot_phase1)
        self.state.add_balance(self.evm.block_ctx.coinbase,
                               self.gas_used() * msg.gas_price)
        return ExecutionResult(used_gas=self.gas_used(), err=vm_err,
                               return_data=ret)

    def refund_gas(self, apricot_phase1: bool) -> None:
        if not apricot_phase1:
            refund = min(self.gas_used() // P.REFUND_QUOTIENT,
                         self.state.refund)
            self.gas_remaining += refund
        self.state.add_balance(self.msg.from_,
                               self.gas_remaining * self.msg.gas_price)
        self.gp.add_gas(self.gas_remaining)

    def gas_used(self) -> int:
        return self.initial_gas - self.gas_remaining


def apply_message(evm: EVM, msg: Message, gas_pool: GasPool
                  ) -> ExecutionResult:
    """ApplyMessage (state_transition.go:233)."""
    return StateTransition(evm, msg, gas_pool).transition_db()
