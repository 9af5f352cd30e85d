"""EVM error taxonomy (twin of reference vmerrs/vmerrs.go)."""


class VMError(Exception):
    """Base: consumes all remaining gas unless stated otherwise."""


class ErrOutOfGas(VMError):
    pass


class ErrCodeStoreOutOfGas(VMError):
    pass


class ErrDepth(VMError):
    pass


class ErrInsufficientBalance(VMError):
    pass


class ErrContractAddressCollision(VMError):
    pass


class ErrExecutionReverted(VMError):
    """REVERT opcode: remaining gas is returned to the caller."""


class ErrMaxCodeSizeExceeded(VMError):
    pass


class ErrMaxInitCodeSizeExceeded(VMError):
    pass


class ErrInvalidJump(VMError):
    pass


class ErrWriteProtection(VMError):
    pass


class ErrReturnDataOutOfBounds(VMError):
    pass


class ErrGasUintOverflow(VMError):
    pass


class ErrInvalidCode(VMError):
    """EIP-3541: new code starting with 0xEF."""


class ErrNonceUintOverflow(VMError):
    pass


class ErrAddrProhibited(VMError):
    """Avalanche: calls to the blackhole address are forbidden."""


class ErrInvalidCoinID(VMError):
    pass


class ErrStackUnderflow(VMError):
    pass


class ErrStackOverflow(VMError):
    pass


class ErrInvalidOpCode(VMError):
    pass


class ErrToAddrProhibited6(VMError):
    """ApricotPhase6: prohibited to-addresses for native asset call."""
