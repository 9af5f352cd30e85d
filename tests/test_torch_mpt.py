"""The port's Python Merkle-Patricia trie and its batched K3 rehash,
against the JAX reference's and the port's C++ trie, on the CPU.

``Trie`` / ``SecureTrie`` roots must equal the reference's and
``NativeSecureTrie``'s on the same inserts, updates and deletes; a
committed trie reopens from its root in either package's node store;
and ``device_rehash(..., device="cpu")`` (K3's plain version, one call a
level) must equal ``trie.hash()`` and the reference's ``device_rehash``
(tests/test_replay.py:201).
"""

import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

from coreth_tpu.mpt import SecureTrie as RSecureTrie
from coreth_tpu.mpt import Trie as RTrie
from coreth_tpu.mpt import trie as rtrie
from coreth_tpu.mpt.rehash import device_rehash as r_device_rehash

from coreth_tpu_torch.mpt import (
    EMPTY_ROOT, NativeSecureTrie, SecureTrie, Trie,
)
from coreth_tpu_torch.mpt import trie as ttrie
from coreth_tpu_torch.mpt.rehash import collect_dirty, device_rehash
from coreth_tpu_torch.ops import keccak as K


def test_hex_prefix_matches_reference():
    rng = random.Random(3)
    for n in range(0, 12):
        for leaf in (False, True):
            nib = bytes(rng.randrange(16) for _ in range(n))
            enc = ttrie.hex_prefix(nib, leaf)
            assert enc == rtrie.hex_prefix(nib, leaf)
            assert ttrie.decode_hex_prefix(enc) == (nib, leaf)


@pytest.mark.parametrize("seed,key_len", [(0, 1), (1, 3), (2, 20)])
def test_trie_roots_match_reference(seed, key_len):
    """Plain tries over short keys (shared prefixes, branch values,
    collapses on delete) and long ones: equal roots and reads at every
    tenth edit, and an empty trie's root once every key is deleted."""
    rng = random.Random(seed)
    t, rt = Trie(), RTrie()
    keys = [rng.randbytes(key_len) for _ in range(120)]
    live = {}
    for step in range(600):
        k = rng.choice(keys)
        if live and rng.random() < 0.3:
            k = rng.choice(sorted(live))
            t.delete(k)
            rt.delete(k)
            del live[k]
        else:
            v = rng.randbytes(rng.choice((1, 5, 31, 40)))
            t.update(k, v)
            rt.update(k, v)
            live[k] = v
        if step % 10 == 0:
            assert t.hash() == rt.hash()
            probe = rng.choice(keys)
            assert t.get(probe) == rt.get(probe) == live.get(probe)
    for k in sorted(live):
        t.delete(k)
        rt.delete(k)
    assert t.hash() == rt.hash() == EMPTY_ROOT


def test_secure_trie_matches_reference_and_native():
    rng = random.Random(11)
    t, rt, nt = SecureTrie(), RSecureTrie(), NativeSecureTrie()
    keys = [rng.randbytes(20) for _ in range(400)]
    for i, k in enumerate(keys):
        v = rng.randbytes(1 + i % 70)
        for trie in (t, rt, nt):
            trie.update(k, v)
    assert t.hash() == rt.hash() == nt.hash()
    for k in keys[::3]:
        for trie in (t, rt, nt):
            trie.delete(k)
    assert t.hash() == rt.hash() == nt.hash()
    assert t.get(keys[1]) == rt.get(keys[1]) == nt.get(keys[1])
    assert t.get(keys[0]) is None


def test_commit_reopens_from_either_node_store():
    """Committed node stores are equal; each package reopens the other's
    root from its store and reads every key through the hash refs."""
    rng = random.Random(5)
    t, rt = SecureTrie(), RSecureTrie()
    items = {rng.randbytes(20): rng.randbytes(36) for _ in range(300)}
    for k, v in items.items():
        t.update(k, v)
        rt.update(k, v)
    root = t.commit()
    assert root == rt.commit()
    assert t.db == rt.db
    again = SecureTrie(root_hash=root, db=dict(rt.db))
    for k, v in items.items():
        assert again.get(k) == v
    k0 = next(iter(items))
    again.update(k0, b"\x01" * 40)
    rt.update(k0, b"\x01" * 40)
    assert again.hash() == rt.hash()


def _rehash_pair():
    """tests/test_replay.py:201's 3,000 keys in two port tries and one
    reference trie."""
    tries = (SecureTrie(), SecureTrie(), RSecureTrie())
    for i in range(3000):
        k = i.to_bytes(20, "big")
        v = (b"\x01" + i.to_bytes(8, "big")) * 4
        for t in tries:
            t.update(k, v)
    return tries


def test_device_rehash_parity(monkeypatch):
    """device_rehash on plain K3 == host hash == the reference's
    device_rehash, on 3,000 keys and after 500 updates; at most one K3
    call a level."""
    t1, t2, rt = _rehash_pair()
    levels = {d for _n, d in collect_dirty(t1)}
    calls = []
    k3 = K.keccak256_blocks

    def counted(blocks, nblocks):
        calls.append(blocks.shape[0])
        return k3(blocks, nblocks)

    monkeypatch.setattr(K, "keccak256_blocks", counted)
    got = device_rehash(t1, min_batch=64, device="cpu")
    assert got == t2.hash() == r_device_rehash(rt, min_batch=64)
    assert 1 <= len(calls) <= len(levels) and min(calls) >= 64
    assert not collect_dirty(t1)
    for i in range(500):
        k = i.to_bytes(20, "big")
        for t in (t1, t2, rt):
            t.update(k, b"\x99" * 40)
    assert device_rehash(t1, min_batch=64, device="cpu") == t2.hash() \
        == r_device_rehash(rt, min_batch=64)


def test_device_rehash_below_min_batch_hashes_on_the_host():
    t1, t2, _rt = _rehash_pair()
    assert device_rehash(t1, device="cpu") == t2.hash()
    assert device_rehash(Trie(), min_batch=0, device="cpu") == EMPTY_ROOT
