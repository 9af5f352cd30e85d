"""coreth_tpu_torch: the PyTorch/CUDA port of coreth-tpu's batch replay.

A second package beside ``coreth_tpu`` (the JAX reference, which stays
as it is).  This slice replays chains of signed value-transfer blocks
through ``replay.engine.ReplayEngine``: senders recover on the card
with a hand-written secp256k1 kernel (``csrc/secp_recover.cu``), each
window of blocks executes in one hand-written kernel launch
(``csrc/transfer_window.cu``), and the state roots fold in the repo's
C++ trie (``native/``) and are checked against the headers.

The package imports torch, numpy and the standard library only — never
``jax`` and nothing of ``coreth_tpu``; what it needs from the reference's
host layers is copied here under the same relative paths.

Entry points take ``device=`` and default to ``"cuda"``; with no card
they raise unless the caller asks for ``device="cpu"`` (the tests do),
where every kernel wrapper runs its plain PyTorch version instead.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means ``"cuda"``.  A CUDA device without a usable card
    raises: there is no silent fall back to the CPU — a caller that
    wants the CPU (the plain versions of the kernels) says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coreth_tpu_torch: CUDA requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
