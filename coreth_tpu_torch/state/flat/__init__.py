"""The flat-state layer: a raw-keyed ``address -> account`` /
``(address, slot) -> value`` view kept current from the commit
pipeline's deduped window effects and the host path's StateDB diffs.

Port of reference ``state/flat/``, with three jobs (store.py,
exporter.py):

1. **O(1) cold reads**: the engine's cold reads, the device table
   fills and StateDB resolution hit a dict instead of walking the
   Merkle trie;
2. **background checkpoints**: the execute thread only stamps a
   generation boundary; a worker thread re-derives the trie from the
   sealed diff generations and writes the durable checkpoint record;
3. **rollback**: per-commit-unit generations carry undo logs, so a
   quarantined block can be popped and the engine re-converged to the
   strict-mode root.
"""

from coreth_tpu_torch.state.flat.store import (  # noqa: F401
    DELETED, FlatError, FlatGeneration, FlatStateView, FlatStore,
    flat_diff_from_statedb,
)
from coreth_tpu_torch.state.flat.exporter import (  # noqa: F401
    ExporterError, FlatExporter,
)
