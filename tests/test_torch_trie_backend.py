"""The port's trie backends on the CPU against the JAX reference.

The engine's ``trie=`` keyword is the reference's ``CORETH_TRIE``:
``"py"`` folds every window into Python tries (``mpt/trie.py``) and
rehashes each level with ``mpt/rehash.py device_rehash``; here
``rehash_min_batch=0`` so K3's plain version hashes every level (on the
card the same levels run on K3's entry).  ``trie_check=True`` is
``CORETH_TRIE_CHECK=1``: the C++ fold with a Python twin re-deriving
every root (``CheckedSecureTrie``).  Mirrors tests/test_native_trie.py
:175-280 (the oracle, the window dedup, the py backend, the armed
oracle) and tests/test_shard_replay.py:152's ``trie`` parameter at
n = 2.  Chains come from the reference's builder (or, for the mixed
segment, the port's, which tests/test_torch_mixed.py holds byte for
byte to the reference's), so a root equal to the header is the
reference's root.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest

from coreth_tpu.mpt import SecureTrie as RSecureTrie
from coreth_tpu.mpt import native_trie as rnative_trie

from coreth_tpu_torch.chain import Genesis, GenesisAccount
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.crypto import native as tnative
from coreth_tpu_torch.mpt import SecureTrie, Trie, native_trie
from coreth_tpu_torch.mpt import rehash
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.parallel import make_mesh
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateDB, StateStore
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.workloads.erc20 import token_genesis_account
from coreth_tpu_torch.workloads.swap import pool_genesis_account

import test_shard_replay as SR
import torch_mixed_cases as MX


@pytest.fixture
def k3_levels(monkeypatch):
    """Counts the levels ``device_rehash`` hands to K3 (its plain
    version on the CPU)."""
    calls = []
    real = rehash.hash_on_device

    def counted(msgs, device):
        calls.append(len(msgs))
        return real(msgs, device)

    monkeypatch.setattr(rehash, "hash_on_device", counted)
    return calls


def _port_alloc(extra=None):
    """tests/test_shard_replay.py's genesis alloc with the port's types."""
    alloc = {a: GenesisAccount(balance=10**24) for a in SR.ADDRS}
    alloc[SR.POOL] = pool_genesis_account(10**15, 10**15)
    alloc[SR.TOKEN] = token_genesis_account({a: 10**21 for a in SR.ADDRS})
    alloc.update(extra or {})
    return alloc


def _engine(mesh=None, machine=False, **kw):
    store = StateStore(backend=kw.get("trie", "native"),
                       check=kw.get("trie_check", False))
    gblock = Genesis(config=CFG, gas_limit=8_000_000,
                     alloc=_port_alloc()).to_block(store)
    if machine:
        kw.update(token_fastpath=False, serial_shortcircuit=False)
    eng = ReplayEngine(CFG, store, parent_header=gblock.header, window=4,
                       capacity=256, batch_pad=64, device="cpu", mesh=mesh,
                       **kw)
    if machine:
        eng._machine_executor().WINDOW = 2
    return eng, store


def _replay(blocks, **kw):
    eng, store = _engine(**kw)
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root == store.trie.hash()
    assert eng.supervisor.strikes == 0
    return eng


# ---------------------------------------------------- the oracle alone

def test_checked_trie_oracle_detects_divergence():
    """tests/test_native_trie.py:175."""
    py = SecureTrie()
    py.update(b"\x01" * 20, b"hello")
    ct = native_trie.CheckedSecureTrie(py)
    ct.update(b"\x02" * 20, b"world")
    assert ct.hash() == ct.native.hash()
    # mutate the Python twin behind the wrapper's back: a divergence
    Trie.update(ct.py, keccak256(b"\x03" * 20), b"sneak")
    with pytest.raises(native_trie.TrieOracleError):
        ct.hash()


def _fold_inputs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    vals = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    vals[::5] = 0                          # deletes
    vals[1::7, :31] = 0                    # one-byte values
    deletes = (rng.random(n) < 0.2).astype(np.uint8)
    accts = dict(
        keys32=bytes(keys), balances32=bytes(vals),
        nonces=[int(x) for x in rng.integers(0, 1 << 40, n)],
        roots32=bytes(rng.integers(0, 256, (n, 32), dtype=np.uint8)),
        code_hashes32=bytes(rng.integers(0, 256, (n, 32), dtype=np.uint8)),
        mc=bytes((rng.random(n) < 0.3).astype(np.uint8)),
        deletes=bytes(deletes))
    return bytes(keys), bytes(vals), accts


@pytest.mark.parametrize("seed", [0, 1])
def test_checked_folds_match_reference(seed):
    """The same bytes through both packages' ``CheckedSecureTrie`` folds,
    twice (the second window over the first): equal roots, each equal
    to the twin's (no oracle error) and to a plain C++ trie's."""
    port = native_trie.CheckedSecureTrie(SecureTrie())
    ref = rnative_trie.CheckedSecureTrie(RSecureTrie())
    plain = native_trie.NativeSecureTrie()
    for window in range(2):
        keys, vals, accts = _fold_inputs(seed * 10 + window, 200)
        got = port.fold_storage(keys, vals, 200)
        assert got == ref.fold_storage(keys, vals, 200) \
            == plain.fold_storage(keys, vals, 200)
    acc_port = native_trie.CheckedSecureTrie(SecureTrie())
    acc_ref = rnative_trie.CheckedSecureTrie(RSecureTrie())
    for window in range(2):
        _k, _v, accts = _fold_inputs(seed * 10 + 5 + window, 150)
        assert acc_port.fold_accounts_root(**accts) \
            == acc_ref.fold_accounts_root(**accts)
    assert acc_port.py.hash() == acc_ref.py.hash()


def test_from_python_trie_matches_reference():
    """``from_python_trie`` against the reference's: a C++ trie seeded
    from a Python trie's leaves lands on its root, and folds on with
    it."""
    t, rt = SecureTrie(), RSecureTrie()
    for i in range(300):
        k, v = i.to_bytes(20, "big"), (b"\x07" + i.to_bytes(4, "big")) * 3
        t.update(k, v)
        rt.update(k, v)
    nt = native_trie.NativeSecureTrie.from_python_trie(t)
    rnt = rnative_trie.NativeSecureTrie.from_python_trie(rt)
    assert nt.hash() == rnt.hash() == rt.hash()
    assert nt.get((17).to_bytes(20, "big")) == t.get((17).to_bytes(20,
                                                                   "big"))
    for tr in (nt, t):
        tr.update(b"\x99" * 20, b"new")
        tr.delete((3).to_bytes(20, "big"))
    assert nt.hash() == t.hash()


@pytest.mark.parametrize("backend,check,kind", [
    ("native", False, native_trie.NativeSecureTrie),
    ("native", True, native_trie.CheckedSecureTrie),
    ("py", False, SecureTrie)], ids=["native", "checked", "py"])
def test_store_backend_and_engine_refusal(backend, check, kind):
    """Every trie a store hands out (storage tries made later included)
    is of its backend; an engine refuses a store of another backend
    rather than converting it."""
    store = StateStore(backend=backend, check=check)
    gblock = Genesis(config=CFG, gas_limit=8_000_000,
                     alloc=_port_alloc()).to_block(store)
    assert isinstance(store.trie, kind)
    assert isinstance(store.storage_trie(b"\xdd" * 20), kind)
    store.set_storage(b"\xcc" * 20, b"\x00" * 31 + b"\x01", 7)
    assert store.storage_value(b"\xcc" * 20, b"\x00" * 31 + b"\x01") == 7
    for trie, trie_check in (("native", False), ("native", True),
                             ("py", False)):
        if (trie, trie_check) == (backend, check):
            continue
        with pytest.raises(ValueError, match="StateStore"):
            ReplayEngine(CFG, store, parent_header=gblock.header,
                         device="cpu", trie=trie, trie_check=trie_check)
    with pytest.raises(ValueError):
        StateStore(backend="py", check=True)


def test_native_backend_without_the_library_raises(monkeypatch):
    """The reference quietly takes the Python trie when the library does
    not load (``native_trie.backend()``); ``trie="native"`` raises."""
    store = StateStore(backend="py")
    gblock = Genesis(config=CFG, gas_limit=8_000_000,
                     alloc=_port_alloc()).to_block(store)
    monkeypatch.setattr(tnative, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        ReplayEngine(CFG, store, parent_header=gblock.header,
                     device="cpu", trie="native")
    with pytest.raises(RuntimeError):
        ReplayEngine(CFG, store, parent_header=gblock.header,
                     device="cpu", trie_check=True)


# ----------------------------------------------------- py-fold replays

@pytest.mark.parametrize(
    "gen,machine,widths", [(SR._gen_transfer, False, (1, 2)),
                           (SR._gen_erc20, True, (1, 2)),
                           (SR._gen_mixed, True, (2,))],
    ids=["transfer", "erc20", "mixed"])
def test_py_fold_replays_on_a_mesh(gen, machine, widths, k3_levels):
    """tests/test_shard_replay.py:152 with ``trie="py"``: the
    reference-built chain replays on one shard and on two under the py
    fold (every level through K3's plain version) to the headers'
    roots; the machine shapes on the (sharded) window path, as the
    reference forces them.  (The mixed shape's swaps re-run lane by
    lane in K6's plain version, seconds a replay on the CPU: n = 2
    only.)"""
    blocks = SR._build_chain(4, gen)
    for n in widths:
        eng = _replay(blocks, mesh=make_mesh(n) if n > 1 else None,
                      machine=machine, trie="py", rehash_min_batch=0)
        assert eng.stats.blocks_fallback == 0
        assert isinstance(eng.store.trie, SecureTrie)
    assert k3_levels and min(k3_levels) >= 1


def test_py_fold_mixed_segment(k3_levels):
    """The 8-block Avalanche-semantics segment (atomic imports and
    nativeAssetCall on the host path over Python tries, transfers on the
    window path) under the py fold."""
    _gen, blocks = MX.build_segment(8)
    eng, store, _backend = MX.replay_engine("cpu", trie="py",
                                            rehash_min_batch=0)
    root = eng.replay([Block.decode(b.encode()) for b in blocks])
    eng.close()
    assert root == blocks[-1].header.root == store.trie.hash()
    assert eng.stats.blocks_fallback > 0 and eng.stats.blocks_device > 0
    assert StateDB(store).get_balance_multi_coin(
        MX.ASSET_RECIPIENT, MX.ASSET) > 0
    assert k3_levels


@pytest.mark.parametrize("trie", ["native", "py"])
def test_window_dedup_fold_equals_per_block_folds(trie):
    """tests/test_native_trie.py:236: every block rewrites the same eight
    holders' token balances, so a 4-block window dedupes to one
    last-value set; the fused fold lands the chain's root like
    per-block folds, with fewer fold calls, on either backend.  (The
    reference's chain is the pool's swaps; the token transfers rewrite
    slots alike at a tenth of the plain versions' CPU time.)"""
    blocks = SR._build_chain(4, SR._gen_erc20)
    runs = []
    for window in (4, 1):
        eng, _store = _engine(machine=True, trie=trie)
        eng._machine_executor().WINDOW = window
        assert eng.replay([Block.decode(b.encode()) for b in blocks]) \
            == blocks[-1].header.root
        runs.append(eng.commit_pipe)
    windowed, per_block = runs
    assert windowed.fold_calls < per_block.fold_calls
    assert windowed.fold_blocks == per_block.fold_blocks == 4


def test_trie_check_replay():
    """tests/test_native_trie.py:272: ``trie_check=True`` re-derives every
    window root on the Python twin during a machine-path replay (and a
    transfer one), with no ``TrieOracleError``."""
    for gen, machine in ((SR._gen_erc20, True), (SR._gen_transfer, False)):
        eng = _replay(SR._build_chain(3, gen), machine=machine,
                      trie_check=True)
        assert isinstance(eng.store.trie, native_trie.CheckedSecureTrie)
        assert eng.commit_pipe.fold_calls > 0


def test_trie_check_catches_a_wrong_fold(monkeypatch):
    """A C++ fold that lands on a wrong root (one value changed before
    it reaches the C++ trie) is caught by the oracle at that window."""
    eng, _store = _engine(trie_check=True)
    real = native_trie.NativeSecureTrie.fold_accounts_root

    def wrong(self, keys32, balances32, *a):
        return real(self, keys32, b"\x01" + balances32[1:], *a)

    monkeypatch.setattr(native_trie.NativeSecureTrie, "fold_accounts_root",
                        wrong)
    blocks = SR._build_chain(2, SR._gen_transfer)
    with pytest.raises(native_trie.TrieOracleError):
        eng.replay([Block.decode(b.encode()) for b in blocks])


def test_statedb_rewind_restores_python_tries():
    """A host-path block that fails its checks rewinds the store's
    Python tries exactly: the account trie's and the pool's and token's
    storage tries' roots and the senders' accounts back at the parent;
    the honest block then applies on the restored tries."""
    eng, store = _engine(trie="py")
    blocks = SR._build_chain(1, SR._gen_mixed)

    def view():
        return (store.trie.hash(), store.storage[SR.POOL].hash(),
                store.storage[SR.TOKEN].hash(),
                {a: store.trie.get(a) for a in SR.ADDRS})

    before = view()
    bad = Block.decode(blocks[0].encode())
    bad.header.root = b"\x11" * 32
    from coreth_tpu_torch.replay import ReplayError
    with pytest.raises(ReplayError, match="state root mismatch"):
        eng._fallback(bad)
    assert view() == before and eng.root == before[0]
    assert eng._fallback(Block.decode(blocks[0].encode())) \
        == blocks[0].header.root == store.trie.hash()
    assert view()[1:3] != before[1:3]
