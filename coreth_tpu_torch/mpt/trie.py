"""Merkle-Patricia trie — host structural engine with incremental hashing.

Port of reference ``mpt/trie.py``: the Python trie under the atomic
trie, ``mpt/rehash.py``, the replay engine's ``trie="py"`` state and
the ``trie_check`` oracle's twin (``mpt/native_trie.py``), without the
copy helper nothing in the port calls.

Semantics per the Ethereum yellow-paper trie spec (reference trie/trie.go:
insert :308, delete :413, Hash :573; hasher.go:69 collapse rules):

- leaf:      [hex-prefix(nibbles, t=1), value]
- extension: [hex-prefix(nibbles, t=0), child-ref]
- branch:    [c0..c15, value]
- a node's reference inside its parent is its RLP if len(rlp) < 32,
  else keccak256(rlp); the root hash is always keccak256(rlp(root)).

Every node carries a memo slot caching (encoded-rlp, parent-ref); edits
clear memos along the touched path only, so re-hashing after a block
touches O(dirty * depth) nodes — the host analog of the reference's
cached trie nodes (trie/triedb/hashdb), and the contract that lets
mpt/rehash.py hand whole dirty frontiers to the batched device keccak.

``SecureTrie`` applies keccak to keys (reference trie/secure_trie.go).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from coreth_tpu_torch import rlp
from coreth_tpu_torch.crypto import keccak256
# keccak256(rlp(b"")), spelled out: importing hashes nothing
from coreth_tpu_torch.types.account import EMPTY_ROOT_HASH as EMPTY_ROOT

# Node model (mutable lists so edits are in place); last slot is the memo:
#   [LEAF,   nibbles(bytes), value(bytes),      memo]
#   [EXT,    nibbles(bytes), child,             memo]
#   [BRANCH, [child x 16],   value(bytes),      memo]
#   [HASHREF, digest(bytes32)]                  (db-backed reference)
# memo = (encoded_rlp: bytes, ref) where ref is the 32-byte hash if
# len(encoded) >= 32 else the decoded RLP structure to inline in parents.

LEAF, EXT, BRANCH, HASHREF = "L", "E", "B", "H"
_MEMO = 3  # memo slot index for L/E/B nodes


def hex_prefix(nibbles: bytes, is_leaf: bool) -> bytes:
    """Hex-prefix encoding (yellow paper appendix C)."""
    flag = 2 if is_leaf else 0
    if len(nibbles) % 2:
        out = bytearray([(flag + 1) << 4 | nibbles[0]])
        rest = nibbles[1:]
    else:
        out = bytearray([flag << 4])
        rest = nibbles
    for i in range(0, len(rest), 2):
        out.append(rest[i] << 4 | rest[i + 1])
    return bytes(out)


def decode_hex_prefix(data: bytes) -> Tuple[bytes, bool]:
    flag = data[0] >> 4
    is_leaf = flag >= 2
    nibbles = bytearray()
    if flag & 1:
        nibbles.append(data[0] & 0x0F)
    for b in data[1:]:
        nibbles.append(b >> 4)
        nibbles.append(b & 0x0F)
    return bytes(nibbles), is_leaf


def key_to_nibbles(key: bytes) -> bytes:
    out = bytearray()
    for b in key:
        out.append(b >> 4)
        out.append(b & 0x0F)
    return bytes(out)


def nibbles_to_key(nibbles: bytes) -> bytes:
    """Inverse of key_to_nibbles for even-length nibble paths (reference
    ``mpt/iterator.py``)."""
    if len(nibbles) % 2:
        raise ValueError("odd nibble path has no byte key")
    return bytes((nibbles[i] << 4) | nibbles[i + 1]
                 for i in range(0, len(nibbles), 2))


def _common_prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class MissingNodeError(Exception):
    """A hash reference was dereferenced but absent from the node store."""


def _leaf(nibbles, value):
    return [LEAF, nibbles, value, None]


def _ext(nibbles, child):
    return [EXT, nibbles, child, None]


def _branch(children, value):
    return [BRANCH, children, value, None]


class Trie:
    """In-memory MPT over an optional {hash: node-rlp} backing store."""

    def __init__(self, root_hash: bytes = EMPTY_ROOT,
                 db: Optional[Dict[bytes, bytes]] = None):
        self.db = db if db is not None else {}
        if root_hash == EMPTY_ROOT:
            self.root = None
        else:
            self.root = [HASHREF, root_hash]

    # ------------------------------------------------------------------ get
    def get(self, key: bytes) -> Optional[bytes]:
        return self._get(self.root, key_to_nibbles(key))

    def _resolve(self, node):
        if node is not None and node[0] == HASHREF:
            data = self.db.get(node[1])
            if data is None:
                raise MissingNodeError(node[1].hex())
            return self._decode_node(rlp.decode(data))
        return node

    def _resolve_in_place(self, parent, slot):
        """Resolve a HASHREF child and replace it in the parent so the
        decode cost is paid once."""
        node = parent[slot]
        if node is not None and node[0] == HASHREF:
            node = self._resolve(node)
            parent[slot] = node
        return node

    def _decode_node(self, items):
        """RLP structure -> node model.  Child byte-strings of 32 bytes are
        hash refs; nested lists are inlined nodes."""
        if isinstance(items, list) and len(items) == 2:
            nibbles, is_leaf = decode_hex_prefix(items[0])
            if is_leaf:
                return _leaf(nibbles, items[1])
            return _ext(nibbles, self._decode_ref(items[1]))
        if isinstance(items, list) and len(items) == 17:
            children = [self._decode_ref(c) if c else None
                        for c in items[:16]]
            return _branch(children, items[16])
        raise ValueError("malformed trie node")

    def _decode_ref(self, item):
        if isinstance(item, list):
            return self._decode_node(item)
        if item == b"":
            return None
        if len(item) == 32:
            return [HASHREF, item]
        raise ValueError("malformed node reference")

    def _get(self, node, nibbles: bytes) -> Optional[bytes]:
        while True:
            if node is None:
                return None
            node = self._resolve(node)
            if node is None:
                return None
            kind = node[0]
            if kind == LEAF:
                return node[2] if node[1] == nibbles else None
            if kind == EXT:
                if nibbles[:len(node[1])] != node[1]:
                    return None
                nibbles = nibbles[len(node[1]):]
                node = node[2]
                continue
            # branch
            if not nibbles:
                return node[2] or None
            nxt = node[1][nibbles[0]]
            nibbles = nibbles[1:]
            node = nxt

    # --------------------------------------------------------------- update
    def update(self, key: bytes, value: bytes) -> None:
        nibbles = key_to_nibbles(key)
        if value:
            self.root = self._insert(self.root, nibbles, value)
        else:
            self.root = self._delete(self.root, nibbles)

    def delete(self, key: bytes) -> None:
        self.update(key, b"")

    def _insert(self, node, nibbles: bytes, value: bytes):
        if node is None:
            return _leaf(nibbles, value)
        node = self._resolve(node)
        if node is None:
            return _leaf(nibbles, value)
        kind = node[0]
        if kind == LEAF:
            existing = node[1]
            if existing == nibbles:
                node[2] = value
                node[_MEMO] = None
                return node
            cp = _common_prefix_len(existing, nibbles)
            branch = _branch([None] * 16, b"")
            for nb, val in ((existing, node[2]), (nibbles, value)):
                rest = nb[cp:]
                if not rest:
                    branch[2] = val
                else:
                    branch[1][rest[0]] = _leaf(rest[1:], val)
            if cp:
                return _ext(nibbles[:cp], branch)
            return branch
        if kind == EXT:
            prefix = node[1]
            cp = _common_prefix_len(prefix, nibbles)
            if cp == len(prefix):
                node[2] = self._insert(node[2], nibbles[cp:], value)
                node[_MEMO] = None
                return node
            branch = _branch([None] * 16, b"")
            old_rest = prefix[cp:]
            child = node[2] if len(old_rest) == 1 \
                else _ext(old_rest[1:], node[2])
            branch[1][old_rest[0]] = child
            new_rest = nibbles[cp:]
            if not new_rest:
                branch[2] = value
            else:
                branch[1][new_rest[0]] = _leaf(new_rest[1:], value)
            if cp:
                return _ext(nibbles[:cp], branch)
            return branch
        # branch
        if not nibbles:
            node[2] = value
            node[_MEMO] = None
            return node
        idx = nibbles[0]
        node[1][idx] = self._insert(node[1][idx], nibbles[1:], value)
        node[_MEMO] = None
        return node

    # --------------------------------------------------------------- delete
    def _delete(self, node, nibbles: bytes):
        if node is None:
            return None
        node = self._resolve(node)
        if node is None:
            return None
        kind = node[0]
        if kind == LEAF:
            return None if node[1] == nibbles else node
        if kind == EXT:
            prefix = node[1]
            if nibbles[:len(prefix)] != prefix:
                return node
            child = self._delete(node[2], nibbles[len(prefix):])
            if child is None:
                return None
            child = self._resolve(child)
            if child[0] == EXT:
                return _ext(prefix + child[1], child[2])
            if child[0] == LEAF:
                return _leaf(prefix + child[1], child[2])
            node[2] = child
            node[_MEMO] = None
            return node
        # branch
        if not nibbles:
            if not node[2]:
                return node
            node[2] = b""
        else:
            idx = nibbles[0]
            node[1][idx] = self._delete(node[1][idx], nibbles[1:])
        node[_MEMO] = None
        live = [(i, c) for i, c in enumerate(node[1]) if c is not None]
        if node[2]:
            if live:
                return node
            return _leaf(b"", node[2])
        if len(live) > 1:
            return node
        if not live:
            return None
        idx, child = live[0]
        child = self._resolve_in_place(node[1], idx)
        if child[0] == LEAF:
            return _leaf(bytes([idx]) + child[1], child[2])
        if child[0] == EXT:
            return _ext(bytes([idx]) + child[1], child[2])
        return _ext(bytes([idx]), child)

    # ----------------------------------------------------------------- hash
    def _encode_node(self, node, acc):
        """Node -> (rlp bytes, parent-ref), memoized.

        acc, when given, collects (hash, rlp) for every hashed node (the
        commit set) — including memoized subtrees on their first commit.
        """
        memo = node[_MEMO]
        if memo is not None:
            if acc is not None:
                self._collect_committed(node, acc)
            return memo
        kind = node[0]
        if kind == LEAF:
            encoded = rlp.encode([hex_prefix(node[1], True), node[2]])
        elif kind == EXT:
            encoded = rlp.encode([hex_prefix(node[1], False),
                                  self._ref(node[2], acc)])
        else:
            items = [self._ref(c, acc) if c is not None else b""
                     for c in node[1]]
            items.append(node[2])
            encoded = rlp.encode(items)
        if len(encoded) < 32:
            ref = rlp.decode(encoded)
        else:
            ref = keccak256(encoded)
            if acc is not None:
                acc.append((ref, encoded))
        node[_MEMO] = (encoded, ref)
        return node[_MEMO]

    def _collect_committed(self, node, acc):
        """Emit (hash, rlp) pairs for a memoized subtree (first commit
        after a hash() pass)."""
        stack = [node]
        while stack:
            n = stack.pop()
            if n is None or n[0] == HASHREF:
                continue
            memo = n[_MEMO]
            if memo is None:
                continue
            encoded, ref = memo
            if isinstance(ref, bytes) and len(ref) == 32:
                if ref in self.db:
                    continue  # subtree already persisted
                acc.append((ref, encoded))
            if n[0] == EXT:
                stack.append(n[2])
            elif n[0] == BRANCH:
                stack.extend(n[1])

    def _ref(self, node, acc):
        if node[0] == HASHREF:
            return node[1]
        return self._encode_node(node, acc)[1]

    def hash(self) -> bytes:
        """Root hash (reference trie.go:573 Hash)."""
        if self.root is None:
            return EMPTY_ROOT
        if self.root[0] == HASHREF:
            return self.root[1]
        encoded, ref = self._encode_node(self.root, None)
        if isinstance(ref, bytes) and len(ref) == 32:
            return ref
        return keccak256(encoded)

    def commit(self) -> bytes:
        """Hash and persist all nodes into the backing store.

        Returns the root hash (reference trie.go:585 Commit +
        committer.go).  The in-memory tree stays resident (it is the
        clean cache).
        """
        if self.root is None:
            return EMPTY_ROOT
        if self.root[0] == HASHREF:
            return self.root[1]
        acc: List[Tuple[bytes, bytes]] = []
        encoded, ref = self._encode_node(self.root, acc)
        root_hash = ref if isinstance(ref, bytes) and len(ref) == 32 \
            else keccak256(encoded)
        self.db[root_hash] = encoded
        for h, data in acc:
            self.db[h] = data
        return root_hash


    # ------------------------------------------------------------- iterate
    def items(self):
        """Yield (key_nibbles, value) in lexicographic key order."""
        yield from self._iter(self.root, b"")

    def _iter(self, node, prefix: bytes):
        if node is None:
            return
        node = self._resolve(node)
        if node is None:
            return
        kind = node[0]
        if kind == LEAF:
            yield prefix + node[1], node[2]
        elif kind == EXT:
            yield from self._iter(node[2], prefix + node[1])
        else:
            if node[2]:
                yield prefix, node[2]
            for i, c in enumerate(node[1]):
                if c is not None:
                    yield from self._iter(c, prefix + bytes([i]))


class SecureTrie(Trie):
    """Trie with keccak256-hashed keys (reference trie/secure_trie.go)."""

    def get(self, key: bytes) -> Optional[bytes]:
        return super().get(keccak256(key))

    def update(self, key: bytes, value: bytes) -> None:
        super().update(keccak256(key), value)

    def delete(self, key: bytes) -> None:
        self.update(key, b"")
