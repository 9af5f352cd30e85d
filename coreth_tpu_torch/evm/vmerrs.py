"""Compatibility shim — the error taxonomy moved to ``coreth_tpu_torch.vmerrs``.

Mirrors the reference, where ``vmerrs/`` is a standalone top-level
package precisely so ``precompile/`` can raise EVM errors without
importing ``core/vm`` (see coreth vmerrs/vmerrs.go).
"""

from coreth_tpu_torch.vmerrs import *  # noqa: F401,F403
