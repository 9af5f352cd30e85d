"""The EVM.

Port of reference ``evm/``: the host interpreter (evm.py,
interpreter.py, jump_table.py, gas.py, precompiles.py), the native host
session (hostexec/) and the device step machine (device/).  The host
interpreter is the correctness anchor — bit-exact gas and semantics; the
device path handles the data-parallel common case and defers to it for
the long tail.
"""

from coreth_tpu_torch.evm.evm import EVM, BlockContext, TxContext, Config  # noqa: F401
from coreth_tpu_torch.evm import vmerrs  # noqa: F401
