"""The EVM object: call/create dispatch, value transfer, precompiles.

Twin of reference core/vm/evm.go (Call :263, CallCode :431, DelegateCall
:482, StaticCall :525, Create :689, Create2 :698, NativeAssetCall :710,
precompile lookup :78).  Error contract matches geth: methods return
(ret, remaining_gas, err) where err None = success; on revert the
frame's remaining gas survives, on any other error it is consumed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.evm import precompiles as pc
from coreth_tpu_torch.evm import vmerrs
from coreth_tpu_torch.evm.interpreter import Frame, Interpreter
from coreth_tpu_torch.evm.jump_table import for_rules
from coreth_tpu_torch.params import ChainConfig, Rules
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH

HASH_ZERO = b"\x00" * 32


@dataclass
class BlockContext:
    """Per-block EVM environment (evm.go:114 BlockContext)."""
    coinbase: bytes = b"\x00" * 20
    gas_limit: int = 0
    number: int = 0
    time: int = 0
    difficulty: int = 1
    base_fee: Optional[int] = None
    get_hash: Callable[[int], bytes] = lambda n: HASH_ZERO
    # predicate results for this block (Durango; core/evm.go:75)
    predicate_results: Optional[object] = None


@dataclass
class TxContext:
    """Per-transaction EVM environment (evm.go:157 TxContext)."""
    origin: bytes = b"\x00" * 20
    gas_price: int = 0


@dataclass
class Config:
    """vm.Config equivalent: tracer hooks + base-fee toggle for eth_call."""
    tracer: Optional[object] = None
    no_base_fee: bool = False


class EVM:
    def __init__(self, block_ctx: BlockContext, tx_ctx: TxContext,
                 statedb, chain_config: ChainConfig,
                 config: Optional[Config] = None):
        self.block_ctx = block_ctx
        self.tx_ctx = tx_ctx
        self.statedb = statedb
        self.chain_config = chain_config
        self.chain_id = chain_config.chain_id
        self.rules: Rules = chain_config.rules(block_ctx.number,
                                               block_ctx.time)
        self.config = config or Config()
        self.jump_table = for_rules(self.rules)
        self.interpreter = Interpreter(self)
        self.depth = 0
        self.call_gas_temp = 0

    # -------------------------------------------------------------- helpers
    def reset(self, tx_ctx: TxContext, statedb) -> None:
        self.tx_ctx = tx_ctx
        self.statedb = statedb

    def precompile(self, addr: bytes):
        """Module-registered stateful precompiles take priority, then the
        fork-keyed builtin map (evm.go:78)."""
        mod = self.rules.active_precompiles.get(addr)
        if mod is not None:
            return mod
        return pc.active_precompiles(self.rules).get(addr)

    def active_precompile_addresses(self) -> List[bytes]:
        addrs = list(pc.active_precompiles(self.rules).keys())
        addrs.extend(self.rules.active_precompiles.keys())
        return addrs

    def can_transfer(self, addr: bytes, amount: int) -> bool:
        return self.statedb.get_balance(addr) >= amount

    def transfer(self, sender: bytes, recipient: bytes, amount: int) -> None:
        self.statedb.sub_balance(sender, amount)
        self.statedb.add_balance(recipient, amount)

    def is_homestead_rules_new_account(self, addr: bytes) -> bool:
        """CALL new-account surcharge test (gas_table.go gasCall)."""
        if self.rules.is_eip158:
            return self.statedb.empty(addr)
        return not self.statedb.exist(addr)

    # ----------------------------------------------------------------- call
    def _run_precompile(self, p, caller: bytes, addr: bytes, input_: bytes,
                        gas: int, read_only: bool) -> Tuple[bytes, int]:
        if getattr(p, "stateful", False):
            return p.run_stateful(self, caller, addr, input_, gas, read_only)
        required = p.required_gas(input_)
        if gas < required:
            raise vmerrs.ErrOutOfGas()
        return p.run(input_), gas - required

    def _execute(self, p, caller: bytes, storage_addr: bytes,
                 code_addr: bytes, input_: bytes, gas: int, value: int,
                 read_only: bool, snapshot: int, op: int = 0xF1
                 ) -> Tuple[bytes, int, Optional[Exception]]:
        """Shared tail of the four call variants: run precompile or code,
        map errors to geth's (ret, gas, err) contract."""
        tracer = self.config.tracer
        if tracer is not None and self.depth > 0:
            tracer.capture_enter(op, caller, code_addr, input_, gas, value)
        frame = None
        try:
            if p is not None:
                ret, gas_left = self._run_precompile(
                    p, caller, code_addr, input_, gas, read_only)
                out = (ret, gas_left, None)
            else:
                code = self.statedb.get_code(code_addr)
                frame = Frame(caller, storage_addr, code, input_, gas,
                              value, self.statedb.get_code_hash(code_addr))
                ret = self.interpreter.run(frame, read_only)
                out = (ret, frame.gas, None)
        except vmerrs.ErrExecutionReverted as e:
            self.statedb.revert_to_snapshot(snapshot)
            gas_left = frame.gas if frame is not None \
                else getattr(e, "gas_left", 0)
            out = (getattr(e, "data", b""), gas_left, e)
        except vmerrs.VMError as e:
            self.statedb.revert_to_snapshot(snapshot)
            out = (b"", 0, e)
        if tracer is not None and self.depth > 0:
            tracer.capture_exit(out[0], gas - out[1], out[2])
        return out

    def call(self, caller: bytes, addr: bytes, input_: bytes, gas: int,
             value: int) -> Tuple[bytes, int, Optional[Exception]]:
        """CALL (evm.go:263)."""
        if self.depth > int(P.CALL_CREATE_DEPTH):
            return b"", gas, vmerrs.ErrDepth()
        if value and not self.can_transfer(caller, value):
            return b"", gas, vmerrs.ErrInsufficientBalance()
        snapshot = self.statedb.snapshot()
        p = self.precompile(addr)
        tracer = self.config.tracer
        if not self.statedb.exist(addr):
            if p is None and self.rules.is_eip158 and value == 0:
                # touch-free no-op (evm.go:285) — still traced
                if tracer is not None and self.depth == 0:
                    tracer.capture_start(self, caller, addr, False, input_,
                                         gas, value)
                    tracer.capture_end(b"", 0, None)
                return b"", gas, None
            self.statedb.create_account(addr)
        self.transfer(caller, addr, value)
        if tracer is not None and self.depth == 0:
            tracer.capture_start(self, caller, addr, False, input_, gas,
                                 value)
            ret, gas_left, err = self._execute(
                p, caller, addr, addr, input_, gas, value, False, snapshot)
            tracer.capture_end(ret, gas - gas_left, err)
            return ret, gas_left, err
        if self.depth == 0 and p is None:
            # compiled host executor for root frames (evm/hostexec):
            # returns None for anything outside the native opcode set,
            # and the interpreter below remains the exact fallback
            from coreth_tpu_torch.evm.hostexec.bridge import try_call
            native = try_call(self, caller, addr, input_, gas, value,
                              snapshot)
            if native is not None:
                return native
        return self._execute(p, caller, addr, addr, input_, gas, value,
                             False, snapshot)

    def call_code(self, caller: bytes, addr: bytes, input_: bytes, gas: int,
                  value: int) -> Tuple[bytes, int, Optional[Exception]]:
        """CALLCODE: addr's code in caller's storage ctx (evm.go:431)."""
        if self.depth > int(P.CALL_CREATE_DEPTH):
            return b"", gas, vmerrs.ErrDepth()
        if value and not self.can_transfer(caller, value):
            return b"", gas, vmerrs.ErrInsufficientBalance()
        snapshot = self.statedb.snapshot()
        p = self.precompile(addr)
        return self._execute(p, caller, caller, addr, input_, gas, value,
                             False, snapshot, op=0xF2)

    def delegate_call(self, parent: Frame, addr: bytes, input_: bytes,
                      gas: int) -> Tuple[bytes, int, Optional[Exception]]:
        """DELEGATECALL: parent's caller/value/storage ctx (evm.go:482)."""
        if self.depth > int(P.CALL_CREATE_DEPTH):
            return b"", gas, vmerrs.ErrDepth()
        snapshot = self.statedb.snapshot()
        p = self.precompile(addr)
        return self._execute(p, parent.caller, parent.address, addr, input_,
                             gas, parent.value, False, snapshot, op=0xF4)

    def static_call(self, caller: bytes, addr: bytes, input_: bytes,
                    gas: int) -> Tuple[bytes, int, Optional[Exception]]:
        """STATICCALL (evm.go:525)."""
        if self.depth > int(P.CALL_CREATE_DEPTH):
            return b"", gas, vmerrs.ErrDepth()
        snapshot = self.statedb.snapshot()
        # touch the callee (geth AddBalance(addr, 0), evm.go:556)
        self.statedb.add_balance(addr, 0)
        p = self.precompile(addr)
        return self._execute(p, caller, addr, addr, input_, gas, 0, True,
                             snapshot, op=0xFA)

    # --------------------------------------------------------------- create
    def create_address(self, caller: bytes, nonce: int) -> bytes:
        return keccak256(rlp.encode([caller, rlp.encode_uint(nonce)]))[12:]

    def create2_address(self, caller: bytes, salt: int,
                        init_code: bytes) -> bytes:
        return keccak256(b"\xff" + caller + salt.to_bytes(32, "big")
                         + keccak256(init_code))[12:]

    def create(self, caller: bytes, init_code: bytes, gas: int, value: int):
        addr = self.create_address(caller, self.statedb.get_nonce(caller))
        return self._create(caller, init_code, gas, value, addr)

    def create2(self, caller: bytes, init_code: bytes, gas: int, value: int,
                salt: int):
        addr = self.create2_address(caller, salt, init_code)
        return self._create(caller, init_code, gas, value, addr)

    def _create(self, caller: bytes, init_code: bytes, gas: int, value: int,
                addr: bytes):
        """(ret, contract_addr, gas_left, err) — evm.go:590 create.

        All Avalanche configs activate Homestead at genesis, so the
        frontier keep-account-on-code-store-OOG corner is not modeled.
        """
        if self.depth > int(P.CALL_CREATE_DEPTH):
            return b"", addr, gas, vmerrs.ErrDepth()
        if not self.can_transfer(caller, value):
            return b"", addr, gas, vmerrs.ErrInsufficientBalance()
        if (self.rules.is_durango
                and len(init_code) > P.MAX_INIT_CODE_SIZE):
            return b"", addr, gas, vmerrs.ErrMaxInitCodeSizeExceeded()
        nonce = self.statedb.get_nonce(caller)
        if nonce + 1 > (1 << 64) - 1:
            return b"", addr, gas, vmerrs.ErrNonceUintOverflow()
        self.statedb.set_nonce(caller, nonce + 1)
        if self.rules.is_apricot_phase2:  # EIP-2929 warm the new address
            self.statedb.add_address_to_access_list(addr)
        # collision check (evm.go:620)
        if (self.statedb.get_nonce(addr) != 0
                or self.statedb.get_code_hash(addr) not in
                (HASH_ZERO, EMPTY_CODE_HASH)):
            return b"", addr, 0, vmerrs.ErrContractAddressCollision()
        snapshot = self.statedb.snapshot()
        self.statedb.create_account(addr)
        self.statedb.mark_created_this_tx(addr)  # EIP-6780 book-keeping
        if self.rules.is_eip158:
            self.statedb.set_nonce(addr, 1)
        self.transfer(caller, addr, value)
        frame = Frame(caller, addr, init_code, b"", gas, value)
        tracer = self.config.tracer
        if tracer is not None and self.depth == 0:
            tracer.capture_start(self, caller, addr, True, init_code, gas,
                                 value)
        ret_err: Tuple[bytes, bytes, int, Optional[Exception]]
        try:
            ret = self.interpreter.run(frame, read_only=False)
            if self.rules.is_apricot_phase3 and ret[:1] == b"\xEF":
                raise vmerrs.ErrInvalidCode()  # EIP-3541
            if self.rules.is_eip158 and len(ret) > P.MAX_CODE_SIZE:
                raise vmerrs.ErrMaxCodeSizeExceeded()
            deposit_gas = len(ret) * P.CREATE_DATA_GAS
            if frame.gas < deposit_gas:
                raise vmerrs.ErrCodeStoreOutOfGas()
            frame.use_gas(deposit_gas)
            self.statedb.set_code(addr, ret)
            ret_err = (ret, addr, frame.gas, None)
        except vmerrs.ErrExecutionReverted as e:
            self.statedb.revert_to_snapshot(snapshot)
            ret_err = (getattr(e, "data", b""), addr, frame.gas, e)
        except vmerrs.VMError as e:
            self.statedb.revert_to_snapshot(snapshot)
            ret_err = (b"", addr, 0, e)
        if tracer is not None and self.depth == 0:
            tracer.capture_end(ret_err[0], gas - ret_err[2], ret_err[3])
        return ret_err

    # ------------------------------------------------- native asset (ANT)
    def native_asset_call(self, caller: bytes, input_: bytes, gas: int,
                          gas_cost: int, read_only: bool):
        """nativeAssetCall precompile body (evm.go:710 NativeAssetCall):
        input = to(20) | assetID(32) | assetAmount(32) | callData."""
        if gas < gas_cost:
            raise vmerrs.ErrOutOfGas()
        remaining = gas - gas_cost
        if read_only:
            raise vmerrs.ErrExecutionReverted()
        if len(input_) < 84:
            raise vmerrs.VMError("invalid nativeAssetCall input")
        to = input_[0:20]
        asset_id = input_[20:52]
        asset_amount = int.from_bytes(input_[52:84], "big")
        call_data = input_[84:]
        snapshot = self.statedb.snapshot()
        if asset_amount and (self.statedb.get_balance_multi_coin(
                caller, asset_id) < asset_amount):
            raise vmerrs.ErrInsufficientBalance()
        if not self.statedb.exist(to):
            self.statedb.create_account(to)
        # multicoin transfer (evm.go TransferMultiCoin via CanTransferMC)
        self.statedb.sub_balance_multi_coin(caller, asset_id, asset_amount)
        self.statedb.add_balance_multi_coin(to, asset_id, asset_amount)
        ret, gas_left, err = self.call(caller, to, call_data, remaining, 0)
        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if isinstance(err, vmerrs.ErrExecutionReverted):
                e = vmerrs.ErrExecutionReverted()
                e.data = ret
                e.gas_left = gas_left
                raise e
            raise err
        return ret, gas_left
