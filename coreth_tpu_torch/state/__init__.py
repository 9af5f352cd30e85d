"""World state over the repo's C++ tries (account trie, storage tries,
code store), and the journaled StateDB the host execution path runs
on."""

from coreth_tpu_torch.state.store import (  # noqa: F401
    StateStore, normalize_state_key,
)
from coreth_tpu_torch.state.statedb import (  # noqa: F401
    StateDB, normalize_coin_id,
)
