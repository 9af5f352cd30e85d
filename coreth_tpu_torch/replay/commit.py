"""Window-batched trie commit — state-root folding off the critical path.

Port of reference ``replay/commit.py``, native backend only, cut to the
account trie: value transfers write no contract storage (the token path
that does is a later slice).  Finished blocks STAGE their account states,
deduped to the last value per address across the whole window;
``flush()`` — once per window, after the next window's device launch is
already queued — folds the deduped set in one fold-and-root call, then
checks the root against the last staged block's header.  Intermediate
per-block roots are never materialized; the window root must equal the
chain's.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from coreth_tpu_torch.types.account import EMPTY_CODE_HASH, EMPTY_ROOT_HASH


class CommitPipeline:
    """Per-engine staging buffer + window flusher for trie commits."""

    def __init__(self, engine):
        self.e = engine
        # last-value-per-address: addr -> (balance, nonce)
        self.accounts: Dict[bytes, Tuple[int, int]] = {}
        self.expected_root: Optional[bytes] = None
        self.expected_number: Optional[int] = None
        self.staged_blocks = 0
        self.fold_s = 0.0
        self.fold_calls = 0
        self.fold_blocks = 0

    def stage(self, header, accounts: Dict[bytes, Tuple[int, int]]) -> None:
        """Queue one finished block's account states; later stages of
        the same account overwrite earlier ones (window dedup)."""
        self.accounts.update(accounts)
        self.expected_root = header.root
        self.expected_number = header.number
        self.staged_blocks += 1

    def pending(self) -> bool:
        return self.staged_blocks > 0

    def _fold_accounts(self) -> bytes:
        e = self.e
        state = e.state
        n = len(self.accounts)
        keys = bytearray()
        bals = bytearray()
        roots = bytearray()
        hashes = bytearray()
        mc = bytearray(n)
        dels = bytearray(n)
        nlist = []
        for i, (addr, (balance, nonce)) in enumerate(self.accounts.items()):
            idx = state.index[addr]
            keys += state.addr_hashes[idx]
            code_hash = state.code_hashes[idx]
            storage_root = state.roots[idx]
            if (balance == 0 and nonce == 0
                    and code_hash == EMPTY_CODE_HASH
                    and storage_root == EMPTY_ROOT_HASH
                    and not state.multicoin[idx]):
                dels[i] = 1  # EIP-158 touched-empty deletion
            bals += balance.to_bytes(32, "big")
            roots += storage_root
            hashes += code_hash
            mc[i] = 1 if state.multicoin[idx] else 0
            nlist.append(nonce)
        return e.trie.fold_accounts_root(
            bytes(keys), bytes(bals), nlist, bytes(roots), bytes(hashes),
            bytes(mc), bytes(dels))

    def flush(self) -> bytes:
        """Fold the staged window, check the root against the last staged
        header, advance ``engine.root``."""
        e = self.e
        if not self.staged_blocks:
            return e.root
        from coreth_tpu_torch.replay.engine import ReplayError
        t0 = time.monotonic()
        root = self._fold_accounts()
        dt = time.monotonic() - t0
        self.fold_s += dt
        e.stats.t_trie += dt
        self.fold_calls += 1
        self.fold_blocks += self.staged_blocks
        expected, number = self.expected_root, self.expected_number
        n_blocks = self.staged_blocks
        self.accounts = {}
        self.staged_blocks = 0
        self.expected_root = None
        self.expected_number = None
        if root != expected:
            raise ReplayError(
                f"state root mismatch at block {number} "
                f"(commit window of {n_blocks}): {root.hex()} != "
                f"{expected.hex()}")
        e.root = root
        return root
