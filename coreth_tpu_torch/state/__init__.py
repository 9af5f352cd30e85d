"""World state over the repo's C++ tries (account trie, storage tries,
code store)."""

from coreth_tpu_torch.state.store import (  # noqa: F401
    StateStore, normalize_state_key,
)
