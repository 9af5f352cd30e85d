"""Merkle-Patricia tries: the repo's C++ trie (native/baseline.cc), which
holds the replay engine's state, and the Python trie (``mpt/trie.py``)
under the atomic trie and the batched device rehash (``mpt/rehash.py``)."""

from coreth_tpu_torch.mpt.native_trie import (  # noqa: F401
    NativeOrderedTrie, NativeSecureTrie, derive_hasher,
)
from coreth_tpu_torch.mpt.trie import EMPTY_ROOT, SecureTrie, Trie  # noqa: F401
