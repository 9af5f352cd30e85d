"""Merkle-Patricia tries: the repo's C++ trie (native/baseline.cc), which
holds the replay engine's state by default, and the Python trie
(``mpt/trie.py``) under the atomic trie, the engine's ``trie="py"``
state, the ``trie_check`` oracle's twin and the batched device rehash
(``mpt/rehash.py``)."""

from coreth_tpu_torch.mpt.native_trie import (  # noqa: F401
    NativeOrderedTrie, NativeSecureTrie, derive_hasher,
)
from coreth_tpu_torch.mpt.trie import EMPTY_ROOT, SecureTrie, Trie  # noqa: F401
