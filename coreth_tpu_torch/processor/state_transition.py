"""Intrinsic gas of a transaction.

Port of reference ``processor/state_transition.py``, cut to
``intrinsic_gas`` for calls without an access list (the machine path's
classifier rejects access lists; ``is_prohibited`` lives in
``evm/precompiles.py``).
"""

from __future__ import annotations

from coreth_tpu_torch.params import protocol as P


def intrinsic_gas(data: bytes, rules) -> int:
    """IntrinsicGas (state_transition.go:79) of a plain call."""
    gas = P.TX_GAS
    if data:
        nz = len(data) - data.count(0)
        nonzero_gas = (P.TX_DATA_NON_ZERO_GAS_EIP2028 if rules.is_istanbul
                       else P.TX_DATA_NON_ZERO_GAS_FRONTIER)
        gas += nz * nonzero_gas + (len(data) - nz) * P.TX_DATA_ZERO_GAS
    return gas
