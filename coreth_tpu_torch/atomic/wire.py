"""The linear codec under its ``atomic`` name.

Port of reference ``atomic/wire.py``: the Packer/Unpacker pair lives at
the package root (``coreth_tpu_torch.wire``); this module re-exports it
for code that reaches the codec through the atomic package.
"""

from coreth_tpu_torch.wire import (  # noqa: F401
    CODEC_VERSION,
    TYPE_EXPORT_TX,
    TYPE_IMPORT_TX,
    TYPE_SECP_CREDENTIAL,
    TYPE_SECP_TRANSFER_INPUT,
    TYPE_SECP_TRANSFER_OUTPUT,
    Packer,
    Unpacker,
)
