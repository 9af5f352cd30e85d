"""Host cryptography: keccak-256 and secp256k1 (pure Python, with the
C++ fast path of ``native/`` installed on first use when the library
builds)."""

from coreth_tpu_torch.crypto.keccak import (  # noqa: F401
    keccak256, keccak256_many, keccak256_py, EMPTY_KECCAK,
)

__all__ = ["keccak256", "keccak256_many", "keccak256_py", "EMPTY_KECCAK"]
