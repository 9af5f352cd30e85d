"""Level-synchronous batched trie rehash on the card (K3's entry).

Port of reference ``mpt/rehash.py``.  Geth parallelises trie hashing
with fork-join goroutines per full node (trie/hasher.go:57); here the
recursion becomes level batches: collect every dirty (unmemoized) node
of a Python ``Trie``, walk the depths bottom-up, RLP-encode each level
on the host (its children's references are ready by then), and hash
the level's encodings of 32 bytes or more in one ``keccak256_blocks``
launch (``csrc/keccak256_blocks.cu``; its plain version on a CPU
device).  The memos are filled in place, so the trie's own ``hash()``
and ``commit()`` afterwards cost O(1), and the root equals
``trie.hash()`` bit for bit.

A level with fewer than ``min_batch`` such encodings hashes on the host
(the native C++ keccak), and a trie with fewer dirty nodes than that
hashes wholly through ``trie.hash()``.  The default keeps the host for
every trie the reference measured; ``chip_smoke.py`` phase rehash
measures the crossover on the card (PERF.md).
"""

from __future__ import annotations

from typing import List

import torch

from coreth_tpu_torch import default_device, rlp
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.mpt.trie import (
    BRANCH, EXT, HASHREF, LEAF, _MEMO, Trie, hex_prefix,
)
from coreth_tpu_torch.ops import keccak as K

# the reference's default (its CORETH_REHASH_MIN_BATCH unset)
DEFAULT_MIN_BATCH = 1_000_000


def hash_on_device(msgs: List[bytes], device: torch.device) -> List[bytes]:
    """keccak-256 of ``msgs`` in one ``keccak256_blocks`` call on
    ``device``."""
    blocks, nblocks = K.pack_blocks(msgs)
    words = K.keccak256_blocks(torch.from_numpy(blocks).to(device),
                               torch.from_numpy(nblocks).to(device))
    return K.digests(words)


def collect_dirty(trie: Trie):
    """(node, depth) for every resident node lacking a memo, via
    iterative DFS.  Children of memoized nodes are skipped — their
    hashes are already final."""
    out = []
    if trie.root is None or trie.root[0] == HASHREF:
        return out
    stack = [(trie.root, 0)]
    while stack:
        node, depth = stack.pop()
        if node is None or node[0] == HASHREF:
            continue
        if node[_MEMO] is not None:
            continue
        out.append((node, depth))
        kind = node[0]
        if kind == EXT:
            stack.append((node[2], depth + 1))
        elif kind == BRANCH:
            for c in node[1]:
                stack.append((c, depth + 1))
    return out


def _child_ref(node):
    """Parent-embedded reference of an already-processed child."""
    if node[0] == HASHREF:
        return node[1]
    return node[_MEMO][1]


def _encode(node) -> bytes:
    kind = node[0]
    if kind == LEAF:
        return rlp.encode([hex_prefix(node[1], True), node[2]])
    if kind == EXT:
        return rlp.encode([hex_prefix(node[1], False), _child_ref(node[2])])
    items = [_child_ref(c) if c is not None else b"" for c in node[1]]
    items.append(node[2])
    return rlp.encode(items)


def device_rehash(trie: Trie, min_batch: int = DEFAULT_MIN_BATCH,
                  device=None) -> bytes:
    """Fill the memos of every dirty node, a level at a time, each
    level's hashes in one K3 launch on ``device`` (default ``"cuda"``,
    which raises without a card; ``"cpu"`` runs K3's plain version),
    then return the root hash, equal to ``trie.hash()``."""
    dev = default_device(device)
    dirty = collect_dirty(trie)
    if len(dirty) < max(min_batch, 1):
        return trie.hash()
    max_depth = max(d for _, d in dirty)
    by_depth: List[List] = [[] for _ in range(max_depth + 1)]
    for node, d in dirty:
        by_depth[d].append(node)
    for depth in range(max_depth, -1, -1):
        level = by_depth[depth]
        if not level:
            continue
        encodings = [_encode(n) for n in level]
        # small encodings inline into their parent (no hash)
        to_hash = [(i, e) for i, e in enumerate(encodings) if len(e) >= 32]
        if to_hash and len(to_hash) >= min_batch:
            digests = hash_on_device([e for _, e in to_hash], dev)
        else:
            digests = [keccak256(e) for _, e in to_hash]
        hash_map = {i: dg for (i, _), dg in zip(to_hash, digests)}
        for i, (node, encoded) in enumerate(zip(level, encodings)):
            if i in hash_map:
                node[_MEMO] = (encoded, hash_map[i])
            else:
                node[_MEMO] = (encoded, rlp.decode(encoded))
    return trie.hash()
