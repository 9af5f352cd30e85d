"""Height-indexed atomic trie.

Port of reference ``atomic/trie.py`` over the port's Python trie
(``mpt/trie.py``), without the ops decoder that only the reference's
shared-memory recovery cursor reads.

Twin of reference plugin/evm/atomic_trie.go (:48 AtomicTrie, :225
UpdateTrie, :341 AcceptTrie): an MPT keyed by big-endian uint64 height
whose values are the RLP of that height's atomic operations, giving
state-sync a verifiable index of every accepted cross-chain effect.
Roots are committed every `commit_interval` heights (4096).
"""

from __future__ import annotations

from typing import Optional, Tuple

from coreth_tpu_torch import rlp
from coreth_tpu_torch.mpt import EMPTY_ROOT
from coreth_tpu_torch.mpt.trie import Trie

COMMIT_INTERVAL = 4096


def height_key(height: int) -> bytes:
    return height.to_bytes(8, "big")


def encode_ops(requests) -> bytes:
    """RLP of {peer_chain: (removes, puts)} sorted by chain id."""
    items = []
    for chain in sorted(requests):
        req = requests[chain]
        puts = [[el.key, el.value, list(el.traits)]
                for el in req.put_requests]
        items.append([chain, list(req.remove_requests), puts])
    return rlp.encode(items)


class AtomicTrie:
    def __init__(self, node_db: Optional[dict] = None,
                 root: bytes = EMPTY_ROOT,
                 commit_interval: int = COMMIT_INTERVAL):
        self.node_db = node_db if node_db is not None else {}
        self.trie = Trie(root_hash=root, db=self.node_db)
        self.commit_interval = commit_interval
        self.last_committed_root = root
        self.last_committed_height = 0
        # height -> committed root, for state-sync summaries at past
        # commit heights (atomic_trie.go height->root index)
        self.committed_roots = {0: root}

    def update_trie(self, height: int, requests) -> None:
        """Index one accepted height's ops (atomic_trie.go:225)."""
        if requests:
            self.trie.update(height_key(height), encode_ops(requests))

    def accept_trie(self, height: int) -> Tuple[bool, bytes]:
        """Commit policy on accept (atomic_trie.go:341): persist the
        root every commit_interval heights.  Returns (committed, root)."""
        if height % self.commit_interval == 0 and height > 0:
            root = self.trie.commit()
            self.last_committed_root = root
            self.last_committed_height = height
            self.committed_roots[height] = root
            return True, root
        return False, self.trie.hash()

    def root(self) -> bytes:
        return self.trie.hash()

    def get(self, height: int) -> Optional[bytes]:
        return self.trie.get(height_key(height))
