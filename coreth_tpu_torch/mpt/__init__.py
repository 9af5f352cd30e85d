"""Merkle-Patricia tries over the repo's C++ trie (native/baseline.cc)."""

from coreth_tpu_torch.mpt.native_trie import (  # noqa: F401
    NativeOrderedTrie, NativeSecureTrie, derive_hasher,
)
